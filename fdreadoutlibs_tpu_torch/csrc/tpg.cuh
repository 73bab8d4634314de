// The SWTPG tick for Hopper: the kernels of ROADMAP.md, shared by the
// translation units csrc/tpg*.cu (one per input encoding, one for the
// int16 state, two for K5, two for the pipeline's staged arms, six
// tpg_carry_*.cu for the SLOT_WORD_CARRY layout; tpg.cu holds the C
// entries).
//
// Replaces fdreadoutlibs_tpu/ops/pallas_tpg.py::_tpg_kernel:
//   K1  the time2 datapath (time_packed=True, tick 2j in the low and 2j+1 in
//       the high 16 bits of a word) for SimpleThreshold, AbsRS, StandardRS:
//       the warp-specialised pipeline (pipe_kernel below, kPipeThreshold),
//       its loader staging time2 rows and its front splitting them;
//   K2  the plain-sample datapath (time_packed=False, one int32 sample per
//       row; _decode_ticks :399-400), for the same families: the same
//       pipeline;
//   K3  the FIR+IQR family (:464-490, :556-560), on any datapath: on plain,
//       time2 and packed rows a two-warp pipeline (pipe_kernel, kPipeK3);
//   K4  the in-kernel 14-bit unpack (_unpack14_rows :241-265, reached via
//       _decode_ticks :396-398): packed WIBEth words, 16 channels in 7
//       words, for every family, staged into the pipeline's ring and
//       decoded there (kPipeThreshold; kPipeK3 for FIR);
//   K2b the native int16 state (i16_mode :475-476, fixedpoint.I16Fx): every
//       family on int16 state and feed, plain datapath only: the pipeline
//       (kPipeThreshold; kPipeK3 for FIR) with its roles on the int16
//       arithmetic and its loader staging int16 samples;
//   K3b the FIR family with the SWAR carry (fir_packed, :466-501, :522-525,
//       :547-548, :561-574; fir.py:278-332): K3's pipeline (kPipeK3) with
//       a packed front and a packed back (FirPackedChannel), on every
//       encoding K3 takes but int16;
//   K4b the words14 unpack as a gather (_unpack14_rows_gather :268-305,
//       words14_gather; also in K5) and as a slab of time2 words before the
//       time2 tick (_unpack14_slab :308-329 and :445-463, words14_slab):
//       both the pipeline (kPipeThreshold; kPipeK3 for FIR), the gather as
//       K4's decode of the staged rows, the slab as an unpack pass of warp
//       0 over each staged stage into a time2 slab of the ring;
// and pallas_tpg.py::_fir2_kernel:
//   K5  the two-pass FIR schedule (fir_twopass 1 and 2, :585-765), on any
//       datapath: the pipeline with a warp each for the front, the filter
//       and the hit chain (its note is at pipe_kernel below).
// The input encoding is the template parameter kEnc; the family, the state
// type and the carry layout are the channel type.
// The arithmetic is ops/step.py::dispatch_tick (tpg_tick, and
// fir.py::tpg_tick_fir for FIR; the port's copies of the JAX package's
// modules), the single source of tick semantics: the plain versions beside
// this kernel (fdreadoutlibs_tpu_torch/ops/tpg.py::process_window_plain and
// process_window_twopass_plain) run those very functions on torch tensors,
// and the two are compared bit for bit.
//
// Outputs, every kernel.  A close writes its record (2 or 3 words:
// [charge<<16|tover, (peak<<16|ptime,) end+1]) into
// slots[chunk][nclose][w][c] while nclose < K; nclose counts every close
// (drops included), is stored at each chunk end and restarts at 0.  The slot
// buffer must arrive zeroed (an empty slot is a zero end word).  State is
// read once and written back once, in place; rows outside the family's live
// set pass through.  The FIR ring of the previous 8 samples is 8 registers
// addressed by constant indices: tick u of a group of kGroup = 16 ticks
// (expanded at compile time) reads ring[(u + j) % 8] oldest-first and
// overwrites ring[u % 8] with its sample, so nothing moves per tick, as the
// Pallas kernel's tuple rotation; kGroup is a multiple of 8, so the ring is
// back in canonical order after every full group, and a ragged tail of n
// ticks is followed by one rotation (realign_ring).
//
// K4's layouts.  Channel c = 16g + r is class r of 7-word group g: its
// sample is bits [14r % 32, +14) of words j = 14r/32 and j + 1, extracted
// with one funnel shift.  The words stay where the feed put them: one
// address rule, word (t, j) of group g at (g / gpr) * outer + (g % gpr) *
// inner + t * tick_stride + j * word_stride, covers the frame words
// (L, T, 28) (gpr 4, outer T*28, inner 7, tick_stride 28, word_stride 1)
// and the host's words14 relayout (T, WR, 7, 128) (gpr 128, outer 896,
// inner 1, tick_stride WR*896, word_stride 128).  The TPU's words14 lane
// positions are not carried: state, slots and nclose keep canonical
// channel order.  Frame words give a warp two whole groups in 14
// consecutive words per tick; the words14 layout spreads them over 7 rows.
//
// K4b-gather (kGather14): a warp's 32 channels are two whole groups, 14
// words per tick, read once per warp: the pipeline's loader stages them and
// every lane takes its two words from the staged row (PipeFeed); the funnel
// shift is K4's.
//
// K4b-slab (kSlab14): the pipeline's loader stages the words14 rows as
// K4's does; warp 0 unpacks each staged stage in one pass into a time2 slab
// of the ring (16 rows x 32 words) and runs K1's front (K3's for FIR) on
// it, so shared memory does not grow with tc.  tc % 16 == 0.
//
// K2b (kI16 channel types, encoding kPlain16): the I16Fx arithmetic.  CUDA
// promotes short to int, so every op that I16Fx does in int16 and that can
// leave the int16 range goes back through int16_t (w16); add_clamp, div10
// and rs_div10 widen in I16Fx too and need no wrap.  State and feed are
// int16_t, slots and nclose int32; the pipeline's slabs hold the values
// sign-extended to int32.
//
// K3b (FirPackedChannel): K3's two warps, each carrying its part of the
// SWAR carry.  Warp 0's front (FirPackedFront) holds the IQR quantiles and
// their accumulators as two words of biased 16-bit halves, and runs the two
// quantile chains in the biased domain (acc_bias = 1 << 15); warp 1's back
// (FirPackedBack) holds charge, prev_was_over and tover as one word and
// takes charge and tover out of it each tick.  State in and out stays
// canonical: each warp packs its rows at load and unpacks them at store.
//
// SLOT_WORD_CARRY (CarrySlots, the units csrc/tpg_carry_*.cu; replaces the
// trace-time layout pallas_tpg.py:67, :506-516, :575-581 and _emit_records
// :426-430): a chunk's K x kWords record words stay out of global memory
// through the chunk.  The first kCarrySlots = 4 slots are registers, written
// by a chain of predicated selects on nclose unrolled to that ceiling (a
// register cannot be indexed at run time); slots above it are staged in the
// thread's column of the block's dynamic shared memory.  Both are stored
// once, where the chunk stores nclose.  A chunk of tc ticks closes at most
// ceil(tc / 2) hits per channel (a close needs an over tick before it), so
// min(K, ceil(tc / 2)) slots are carried (carry_limit) and the others keep
// the zeros the slot buffer arrives with.  The layout is the
// kernels' template parameter kCarry, instantiated in units of its own, so
// the direct-store kernels are the same code as without it.
//
// rs_float (kRsFloat, ProcessNaiveRS): v = 0.8f * rs + (AbsRS ? |s| / 2 :
// s) and trunc(v + copysign(0.5, v)), each float op rounded on its own
// (__fmul_rn / __fadd_rn: nvcc would contract a * b + c into an FMA, which
// the JAX package does not do).
//
// Integer exactness: left shifts and the wrapping products (the FIR
// filter, the threshold product wrap_i16((sigma_c << e) * threshold), the
// naive threshold product) run on uint32_t and wrap through int16_t or
// int32_t, which is the JAX package's int32 arithmetic mod 2^32; nothing
// relies on undefined signed behaviour.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

#ifdef TPG_HOST_EMULATION
#define TPG_DYNAMIC_SHARED(T, name) T* name = host_dynamic_shared<T>()
#else
#define TPG_DYNAMIC_SHARED(T, name) extern __shared__ T name[]
#endif

namespace tpg {

constexpr int kGroup = 16;   // ticks per unrolled group; a multiple of kTaps
constexpr int kTaps = 8;

// Input encodings (the C entry's `encoding`; kPlain16 is kPlain on an int16
// state).
enum Encoding : int {
  kPlain = 0,
  kTime2 = 1,
  kPacked14 = 2,
  kGather14 = 3,
  kSlab14 = 4,
  kPlain16 = 5
};

enum Family : int {
  kSimpleThreshold = 0,
  kAbsRS = 1,
  kStandardRS = 2,
  kFIR = 3
};

// The shared memory a block may use (227 KB): the bound of every launch's
// dynamic shared memory and mbarriers.
constexpr int kMaxSharedBytes = 232448;

struct Params {
  const void* feed;      // time2 words, samples or packed 14-bit words
  int feed_stride;       // between rows (time2, plain) or ticks (packed)
  // packed 14-bit words: the layout of the 7-word channel groups
  int groups_per_row;
  int group_outer;
  int group_inner;
  int word_stride;
  int n_chunks;
  int ticks_per_chunk;   // tc
  void* state;           // (KSTATE, C), int32 or int16
  int n_channels;
  int32_t* slots;        // (n_chunks, K, words, C), zeroed
  int32_t* nclose;       // (n_chunks, C)
  int k_slots;
  int threshold;
  int accumulator_limit;
  int rs_scale_factor_x10;
  // FIR family (ops/fir.py)
  int taps[kTaps];
  int tap_exponent;
  int adc_max;           // 32767 >> tap_exponent
  int sigma_cap;         // (1 << 15) / (multiplier * 5), AVX semantics
  int thr_mult;          // threshold * multiplier, naive semantics
};

// The compile-time choices of one launch, as the C entries take them.
struct Variant {
  int family;
  bool peak_gated;
  bool charge_floor;     // read for SimpleThreshold; the RS families floor
  bool track_peaks;
  bool avx;
  bool fir_packed;       // K3b: FIR on an int32 state
  bool rs_float;         // read for the RS families
};

// One dispatcher per translation unit.
cudaError_t launch_plain(const Params& p, const Variant& v, cudaStream_t s);
cudaError_t launch_time2(const Params& p, const Variant& v, cudaStream_t s);
cudaError_t launch_packed14(const Params& p, const Variant& v,
                            cudaStream_t s);
cudaError_t launch_gather14(const Params& p, const Variant& v,
                            cudaStream_t s);
cudaError_t launch_slab14(const Params& p, const Variant& v, cudaStream_t s);
cudaError_t launch_int16(const Params& p, const Variant& v, cudaStream_t s);
// the same with the SLOT_WORD_CARRY emission layout (csrc/tpg_carry_*.cu)
cudaError_t launch_carry_plain(const Params& p, const Variant& v,
                               cudaStream_t s);
cudaError_t launch_carry_time2(const Params& p, const Variant& v,
                               cudaStream_t s);
cudaError_t launch_carry_packed14(const Params& p, const Variant& v,
                                  cudaStream_t s);
cudaError_t launch_carry_gather14(const Params& p, const Variant& v,
                                  cudaStream_t s);
cudaError_t launch_carry_slab14(const Params& p, const Variant& v,
                                cudaStream_t s);
cudaError_t launch_carry_int16(const Params& p, const Variant& v,
                               cudaStream_t s);
// K5 on plain and time2 feeds, and on packed (K4 and K4b-gather) feeds
cudaError_t launch_fir2_unpacked(const Params& p, const Variant& v,
                                 int encoding, bool lift, cudaStream_t s);
cudaError_t launch_fir2_packed(const Params& p, const Variant& v,
                               int encoding, bool lift, cudaStream_t s);
// the pipeline's staged arms (one warp, the whole fused tick on a staged
// feed): FIR on plain and time2 feeds, the threshold families on plain
// samples and packed 14-bit words
cudaError_t launch_fir_staged(const Params& p, const Variant& v,
                              int encoding, cudaStream_t s);
cudaError_t launch_threshold_staged(const Params& p, const Variant& v,
                                    int encoding, cudaStream_t s);

}  // namespace tpg

namespace {

using namespace tpg;

constexpr int kInt16Max = 32767;
constexpr int kInt16Min = -32768;
constexpr int kBias = 1 << 15;   // the SWAR carry's bias (fir.py)

// State rows (ops/chanstate.py FIELDS order, then
// rs_memory_factor, then the FIR ring oldest-first).
enum Row : int {
  kPedestals = 0,
  kAccum = 1,
  kRs = 2,
  kPedestalsRs = 3,
  kAccumRs = 4,
  kPrevWasOver = 5,
  kHitCharge = 6,
  kHitTover = 7,
  kHitPeakAdc = 8,
  kHitPeakTime = 9,
  kQuantile25 = 10,
  kQuantile75 = 11,
  kAccum25 = 12,
  kAccum75 = 13,
  kMemoryFactor = 14,
  kFirRow0 = 15,
};

__device__ __forceinline__ int wrap_i16(int x) {
  return static_cast<int>(static_cast<int16_t>(x));
}

// An int16 op of I16Fx: the result back through int16_t (kI16), or the
// int32 value (I32Fx).
template <bool kI16>
__device__ __forceinline__ int w16(int x) {
  return kI16 ? wrap_i16(x) : x;
}

template <bool kI16>
using StateT = std::conditional_t<kI16, int16_t, int32_t>;

template <class S>
__device__ __forceinline__ void put(S* st, size_t row, size_t C, int v) {
  st[row * C] = static_cast<S>(v);
}

__device__ __forceinline__ int pack16(int hi, int lo) {
  return static_cast<int>((static_cast<uint32_t>(hi) << 16) |
                          static_cast<uint32_t>(lo));
}

__device__ __forceinline__ int clip1(int d) {
  return d > 1 ? 1 : (d < -1 ? -1 : d);
}

// The int16 state's bump of a frugal median: +1 past limit, else -1 past
// -limit (the first test wins where a negative limit makes both hold),
// resetting the accumulator, as selects: with the int16 wraps around it
// the if / else-if of the int32 form compiles to divergent branches (BSSY,
// BRA) in the pipeline's warps, which cost K2b about a third of its time
// (PERF.md §6).  w16(m + 0) is m, always in the state's range.  The int32
// form stays written out where it is used, as the int32 kernels were
// measured: the same logic through a helper, or as selects, changes
// nvcc's code for K3's and K5's warps (PERF.md §7).
__device__ __forceinline__ void bump_i16(int& m, int& acc, int limit) {
  const int b = acc > limit ? 1 : (acc < -limit ? -1 : 0);
  m = wrap_i16(m + b);
  acc = b != 0 ? 0 : acc;
}

// step.py::frugal_update: delta = clip(s - m, -1, 1); a bump of the median
// resets the accumulator.
template <bool kI16>
__device__ __forceinline__ void frugal(int& m, int& acc, int s, int limit) {
  acc = w16<kI16>(acc + clip1(w16<kI16>(s - m)));
  if constexpr (kI16) {
    bump_i16(m, acc, limit);
  } else if (acc > limit) {
    m = w16<kI16>(m + 1);
    acc = 0;
  } else if (acc < -limit) {
    m = w16<kI16>(m - 1);
    acc = 0;
  }
}

// ---- emission layouts: where a chunk's hit records live until its end ----
//
// A tick hands every close to slot_emit() on the chunk's `slots`: for the
// direct store the pointer to word 0 of slot 0 of that chunk and channel
// (slot k's word j is base[(k * kWords + j) * C]), passed by value as it
// always was, so the direct-store kernels are the same code as before the
// carry layout; for SLOT_WORD_CARRY a pointer to the chunk's CarrySlots,
// flushed where the chunk stores nclose.

// Store a closed hit's record into its slot while the chunk has room.
template <int kWords>
__device__ __forceinline__ void emit(int& nclose, int32_t* slot_base,
                                     const Params& p, int w0, int w1,
                                     int end_word) {
  if (nclose < p.k_slots) {
    const size_t C = static_cast<size_t>(p.n_channels);
    int32_t* rec = slot_base + static_cast<size_t>(nclose) * kWords * C;
    rec[0] = w0;
    if (kWords == 3) rec[C] = w1;
    rec[(kWords - 1) * C] = end_word;
  }
  ++nclose;
}

// The direct store: straight into the slot.
template <int kWords>
__device__ __forceinline__ void slot_emit(int32_t* slot_base, int& nclose,
                                          const Params& p, int w0, int w1,
                                          int end_word) {
  emit<kWords>(nclose, slot_base, p, w0, w1, end_word);
}

// Record slots a thread carries in registers (SLOT_WORD_CARRY).
constexpr int kCarrySlots = 4;

// The slots a chunk can fill: a close needs an over tick before it, so a
// chunk closes at most ceil(tc / 2) hits per channel.
__host__ __device__ inline int carry_limit(const Params& p) {
  const int most = (p.ticks_per_chunk + 1) / 2;
  return p.k_slots < most ? p.k_slots : most;
}

// The int32 words of a block's staging for the slots above kCarrySlots,
// one column for each of its `lanes` channels.
__host__ __device__ constexpr long long carry_stage_words(int limit,
                                                          int n_words,
                                                          int lanes) {
  return static_cast<long long>(limit > kCarrySlots ? limit - kCarrySlots
                                                    : 0) *
         n_words * lanes;
}

// SLOT_WORD_CARRY: the chunk's records as kCarrySlots x kWords registers,
// each close a chain of predicated selects on nclose (_emit_records
// :426-430), and above that ceiling the thread's column of the block's
// staging in shared memory (word j of slot kCarrySlots + i at
// stage[(i * kWords + j) * kStride], kStride the block's channels); all
// stored once at the chunk's end.
template <int kWords, int kStride>
struct CarrySlots {
  int32_t* base;
  int32_t* stage;
  int limit;
  int w[kCarrySlots][kWords];

  __device__ __forceinline__ void begin(int32_t* chunk_base,
                                        int32_t* thread_stage,
                                        const Params& p) {
    base = chunk_base;
    stage = thread_stage;
    limit = carry_limit(p);
#pragma unroll
    for (int k = 0; k < kCarrySlots; ++k)
#pragma unroll
      for (int j = 0; j < kWords; ++j) w[k][j] = 0;
  }

  __device__ __forceinline__ void emit(int& nclose, int w0, int w1,
                                       int end_word) {
    int rec[kWords];
    rec[0] = w0;
    if (kWords == 3) rec[1] = w1;
    rec[kWords - 1] = end_word;
    if (nclose < limit) {
      if (nclose < kCarrySlots) {
#pragma unroll
        for (int k = 0; k < kCarrySlots; ++k) {
          const bool sel = nclose == k;
#pragma unroll
          for (int j = 0; j < kWords; ++j) w[k][j] = sel ? rec[j] : w[k][j];
        }
      } else {
        int32_t* at = stage + static_cast<size_t>(nclose - kCarrySlots) *
                                  kWords * kStride;
#pragma unroll
        for (int j = 0; j < kWords; ++j) at[j * kStride] = rec[j];
      }
    }
    ++nclose;
  }

  __device__ __forceinline__ void flush(int nclose, const Params& p) {
    const size_t C = static_cast<size_t>(p.n_channels);
#pragma unroll
    for (int k = 0; k < kCarrySlots; ++k) {
      if (k < limit) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) base[(k * kWords + j) * C] = w[k][j];
      }
    }
    const int n = nclose < limit ? nclose : limit;
    for (int k = kCarrySlots; k < n; ++k) {
      const int32_t* at = stage + static_cast<size_t>(k - kCarrySlots) *
                                      kWords * kStride;
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        base[(static_cast<size_t>(k) * kWords + j) * C] = at[j * kStride];
    }
  }
};

template <int kWords, int kStride>
__device__ __forceinline__ void slot_emit(CarrySlots<kWords, kStride>* slots,
                                          int& nclose, const Params&, int w0,
                                          int w1, int end_word) {
  slots->emit(nclose, w0, w1, end_word);
}

// step.py::tpg_tick's hit chain after the close test: the saturating
// charge (floored with kChargeFloor) and tover, the peak registers (gated
// on over with kPeakGated).  Writes the record words w0 = charge<<16|tover,
// w1 = peak<<16|ptime and zeroes the hit on a close.
template <bool kPeakGated, bool kChargeFloor>
struct ThresholdHit {
  int charge, tover, peak_adc, peak_time;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    charge = st[kHitCharge * C];
    tover = st[kHitTover * C];
    peak_adc = st[kHitPeakAdc * C];
    peak_time = st[kHitPeakTime * C];
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    put(st, kHitCharge, C, charge);
    put(st, kHitTover, C, tover);
    put(st, kHitPeakAdc, C, peak_adc);
    put(st, kHitPeakTime, C, peak_time);
  }

  __device__ __forceinline__ void step(int s, bool over, bool closed,
                                       int& w0, int& w1) {
    int ch = charge + (over ? s : 0);
    ch = ch < kInt16Max ? ch : kInt16Max;
    if (kChargeFloor) ch = ch > kInt16Min ? ch : kInt16Min;
    bool peak_upd = s > peak_adc;
    if (kPeakGated) peak_upd = peak_upd && over;
    const int pk = peak_upd ? s : peak_adc;
    const int pt = peak_upd ? tover : peak_time;
    int tv = tover + (over ? 1 : 0);
    tv = tv < kInt16Max ? tv : kInt16Max;
    w0 = pack16(ch, tv);
    w1 = pack16(pk, pt);
    if (closed) {
      charge = tover = peak_adc = peak_time = 0;
    } else {
      charge = ch;
      tover = tv;
      peak_adc = pk;
      peak_time = pt;
    }
  }
};

// The RS families' chain after the raw pedestal: the running sum on the
// carried rs and the channel's memory factor (read only), and the frugal
// pedestal of the running sum.
template <int kFamily, bool kI16, bool kRsFloat>
struct RsChain {
  int rs, ped_rs, acc_rs, mf;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    rs = st[kRs * C];
    ped_rs = st[kPedestalsRs * C];
    acc_rs = st[kAccumRs * C];
    mf = st[kMemoryFactor * C];
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    put(st, kRs, C, rs);
    put(st, kPedestalsRs, C, ped_rs);
    put(st, kAccumRs, C, acc_rs);
  }

  // The RS waveform of one tick from the pedestal-subtracted sample.
  __device__ __forceinline__ int running_sum(int s, const Params& p) const {
    if (kRsFloat) {
      // step.py's float branch: |s| in the state's type (int16: |-32768|
      // stays -32768), float32 ops rounded one by one, std::round as
      // trunc(v + copysign(0.5, v)), then float -> int32 -> state type
      const int a = w16<kI16>(s < 0 ? -s : s);
      const float second = kFamily == kAbsRS
                               ? __fmul_rn(static_cast<float>(a), 0.5f)
                               : static_cast<float>(s);
      const float v = __fadd_rn(__fmul_rn(0.8f, static_cast<float>(rs)),
                                second);
      return w16<kI16>(static_cast<int>(
          truncf(__fadd_rn(v, copysignf(0.5f, v)))));
    }
    const int second =
        kFamily == kAbsRS ? (s < 0 ? -s : s) * p.rs_scale_factor_x10 : s;
    // fixedpoint.rs_div10_unwrapped: mulhrs(wrap_i16(sum), 3276); the
    // int16 products of I16Fx are congruent mod 2^16, so the same
    return (wrap_i16(rs * mf + second) * 3276 + 16384) >> 15;
  }

  // The RS value x of one tick (rs keeps the previous one: the caller
  // tests the close on it, then stores x).
  __device__ __forceinline__ int step(int s, const Params& p) {
    const int r = running_sum(s, p);
    frugal<kI16>(ped_rs, acc_rs, r, p.accumulator_limit);
    // float-mode rs can leave int16: its subtraction wraps (sub16)
    return kRsFloat ? wrap_i16(r - ped_rs) : w16<kI16>(r - ped_rs);
  }
};

// step.py::tpg_tick: SimpleThreshold, AbsRS, StandardRS, one fused tick:
// the raw pedestal, the running sum (RsChain) and the hit chain
// (ThresholdHit) in series.
template <int kFamily, bool kPeakGated, bool kChargeFloor, bool kI16,
          bool kRsFloat>
struct ThresholdChannel {
  using State = StateT<kI16>;
  static constexpr int kWords = 3;
  int ped, acc;
  int prev_over;   // SimpleThreshold; RS reads the carried rs instead
  RsChain<kFamily, kI16, kRsFloat> rsc;
  ThresholdHit<kPeakGated, kChargeFloor> hit;
  int nclose;

  __device__ __forceinline__ void load(const State* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
    hit.load(st, C);
    prev_over = 0;
    rsc.rs = rsc.ped_rs = rsc.acc_rs = rsc.mf = 0;
    if (kFamily == kSimpleThreshold)
      prev_over = st[kPrevWasOver * C];
    else
      rsc.load(st, C);
  }

  __device__ __forceinline__ void store(State* st, size_t C) const {
    put(st, kPedestals, C, ped);
    put(st, kAccum, C, acc);
    hit.store(st, C);
    if (kFamily == kSimpleThreshold)
      put(st, kPrevWasOver, C, prev_over);
    else
      rsc.store(st, C);
  }

  __device__ __forceinline__ void realign(int) {}

  // One sample; `end_word` is the window tick + 1; a close is stored while
  // `live` (the pipeline's staged arm has lanes past the last channel).
  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s_raw, int end_word, Slots slots,
                                       const Params& p, bool live = true) {
    frugal<kI16>(ped, acc, s_raw, p.accumulator_limit);
    const int s = w16<kI16>(s_raw - ped);
    bool over, closed;
    if (kFamily == kSimpleThreshold) {
      over = s > p.threshold;
      closed = prev_over != 0 && !over;
      prev_over = over ? 1 : 0;
    } else {
      const int x = rsc.step(s, p);
      over = x > p.threshold;
      // RS derives the previous over flag from the carried (previous) rs
      closed = rsc.rs > p.threshold && !over;
      rsc.rs = x;
    }
    int w0, w1;
    hit.step(s, over, closed, w0, w1);
    if (closed && live) slot_emit<kWords>(slots, nclose, p, w0, w1, end_word);
  }
};

// The FIR family's pieces (fir.py), shared by K3's fused tick and K5's
// passes.
//
// fir_iqr_update + fir_pedestal_sub: the IQR and pedestal chains of one
// tick.  Returns the clamped, pedestal-subtracted sample; `sigma` gets
// q75 - q25.
template <bool kI16>
struct FirFront {
  int ped, acc, q25, q75, a25, a75;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
    q25 = st[kQuantile25 * C];
    q75 = st[kQuantile75 * C];
    a25 = st[kAccum25 * C];
    a75 = st[kAccum75 * C];
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    put(st, kPedestals, C, ped);
    put(st, kAccum, C, acc);
    put(st, kQuantile25, C, q25);
    put(st, kQuantile75, C, q75);
    put(st, kAccum25, C, a25);
    put(st, kAccum75, C, a75);
  }

  __device__ __forceinline__ int step(int s_raw, const Params& p,
                                      int& sigma) {
    const int limit = p.accumulator_limit;
    // the active quantile chain, gated on the pre-update median; the bump
    // check runs whatever the gate, as frugal_update's masked form does
    const bool lt = s_raw < ped;
    const bool gt = s_raw > ped;
    int qa = lt ? q25 : q75;
    int aa = lt ? a25 : a75;
    aa = w16<kI16>(aa + ((lt || gt) ? clip1(w16<kI16>(s_raw - qa)) : 0));
    if constexpr (kI16) {
      bump_i16(qa, aa, limit);
    } else if (aa > limit) {
      qa = w16<kI16>(qa + 1);
      aa = 0;
    } else if (aa < -limit) {
      qa = w16<kI16>(qa - 1);
      aa = 0;
    }
    if (lt) {
      q25 = qa;
      a25 = aa;
    }
    if (gt) {
      q75 = qa;
      a75 = aa;
    }
    sigma = w16<kI16>(q75 - q25);
    frugal<kI16>(ped, acc, s_raw, limit);
    const int s = w16<kI16>(s_raw - ped);
    return s < p.adc_max ? s : p.adc_max;
  }
};

// fir_threshold, both semantics.  The AVX product runs on uint32_t, so the
// threshold-product wrap guard of fir.py (a wrap kept when a*T may not
// fit int32) is exact here by construction: wrap_i16 of the product mod
// 2^32 is the wrapped int16 chain.
template <bool kAvx>
__device__ __forceinline__ bool fir_over(int filt, int sigma,
                                         const Params& p) {
  if (kAvx) {
    const int sc = sigma < p.sigma_cap ? sigma : p.sigma_cap;
    const uint32_t prod = (static_cast<uint32_t>(sc) << p.tap_exponent) *
                          static_cast<uint32_t>(p.threshold);
    return filt > wrap_i16(static_cast<int>(prod));
  }
  return filt > static_cast<int>(static_cast<uint32_t>(p.thr_mult) *
                                 static_cast<uint32_t>(sigma));
}

// fir_to_add
__device__ __forceinline__ int fir_to_add(bool over, int filt,
                                          const Params& p) {
  return over ? (filt >> p.tap_exponent) : 0;
}

// fir_filter over the previous 8 samples, oldest first from ring[kU % 8]
// (a tick's kU in its group), wrapped to int16 once at the end.
template <int kU>
__device__ __forceinline__ int fir_filter(const int (&ring)[kTaps],
                                          const Params& p) {
  uint32_t f = 0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
    f += static_cast<uint32_t>(p.taps[j]) *
         static_cast<uint32_t>(ring[(kU + j) % kTaps]);
  return wrap_i16(static_cast<int>(f));
}

// fir_hit_update after the close test: the saturating charge/tover chain
// and the optional peak registers.  Writes the record words
// w0 = charge<<16|tover, w1 = peak<<16|ptime, and zeroes the hit on a
// close.
template <bool kPeakGated, bool kTrackPeaks>
struct FirHit {
  int charge, tover, peak_adc, peak_time;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    charge = st[kHitCharge * C];
    tover = st[kHitTover * C];
    peak_adc = peak_time = 0;
    if (kTrackPeaks) {
      peak_adc = st[kHitPeakAdc * C];
      peak_time = st[kHitPeakTime * C];
    }
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    put(st, kHitCharge, C, charge);
    put(st, kHitTover, C, tover);
    if (kTrackPeaks) {
      put(st, kHitPeakAdc, C, peak_adc);
      put(st, kHitPeakTime, C, peak_time);
    }
  }

  __device__ __forceinline__ void step(bool over, int to_add, int filt,
                                       bool closed, int& w0, int& w1) {
    int ch = charge + to_add;
    ch = ch < kInt16Max ? ch : kInt16Max;
    ch = ch > kInt16Min ? ch : kInt16Min;
    int pk = 0, pt = 0;
    if (kTrackPeaks) {
      bool peak_upd = filt > peak_adc;
      if (kPeakGated) peak_upd = peak_upd && over;
      pk = peak_upd ? filt : peak_adc;
      pt = peak_upd ? tover : peak_time;
    }
    int tv = tover + (over ? 1 : 0);
    tv = tv < kInt16Max ? tv : kInt16Max;
    w0 = pack16(ch, tv);
    w1 = pack16(pk, pt);
    if (closed) {
      charge = tover = 0;
      if (kTrackPeaks) peak_adc = peak_time = 0;
    } else {
      charge = ch;
      tover = tv;
      if (kTrackPeaks) {
        peak_adc = pk;
        peak_time = pt;
      }
    }
  }
};

// The FIR ring after a guarded tail group of n ticks: the oldest sample
// sits at ring[n % 8]; rotate left by n % 8 to restore oldest-first order.
__device__ __forceinline__ void realign_ring(int (&ring)[kTaps], int n) {
  for (int k = 0; k < (n & (kTaps - 1)); ++k) {
    const int first = ring[0];
#pragma unroll
    for (int j = 0; j + 1 < kTaps; ++j) ring[j] = ring[j + 1];
    ring[kTaps - 1] = first;
  }
}

// Everything of fir.py::tpg_tick_fir after the front: the filter over the
// previous 8 samples (the current one then takes the oldest slot), the
// threshold, to_add, the close test and the hit chain, and the emission of
// a close while `live` (the pipeline's lanes past the last channel take
// part in its barriers but store nothing).  K3's second warp runs it on the
// front's s and sigma; FirChannel runs it after its own front.
template <bool kPeakGated, bool kTrackPeaks, bool kAvx>
struct FirBack {
  static constexpr int kWords = kTrackPeaks ? 3 : 2;
  FirHit<kPeakGated, kTrackPeaks> hit;
  int prev_over;
  int ring[kTaps];   // previous samples; oldest at ring[u % 8] for tick u
  int nclose;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    hit.load(st, C);
    prev_over = st[kPrevWasOver * C];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) ring[j] = st[(kFirRow0 + j) * C];
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    hit.store(st, C);
    put(st, kPrevWasOver, C, prev_over);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) put(st, kFirRow0 + j, C, ring[j]);
  }

  __device__ __forceinline__ void realign(int n) { realign_ring(ring, n); }

  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s, int sigma, int end_word,
                                       Slots slots, const Params& p,
                                       bool live) {
    const int filt = fir_filter<kU>(ring, p);
    ring[kU % kTaps] = s;
    const bool over = fir_over<kAvx>(filt, sigma, p);
    const bool closed = prev_over != 0 && !over;
    prev_over = over ? 1 : 0;
    int w0, w1;
    hit.step(over, fir_to_add(over, filt, p), filt, closed, w0, w1);
    if (closed && live) slot_emit<kWords>(slots, nclose, p, w0, w1, end_word);
  }
};

// fir.py::tpg_tick_fir (unpacked layout): the FIR+IQR family, one fused
// tick: the channel type the pipeline's FIR modes read (PipeOf; kI16 for
// K2b) and, with its whole tick, the pipeline's staged arm below.
template <bool kPeakGated, bool kTrackPeaks, bool kAvx, bool kI16>
struct FirChannel : FirBack<kPeakGated, kTrackPeaks, kAvx> {
  using Back = FirBack<kPeakGated, kTrackPeaks, kAvx>;
  using State = StateT<kI16>;
  FirFront<kI16> front;

  __device__ __forceinline__ void load(const State* st, size_t C) {
    front.load(st, C);
    Back::load(st, C);
  }

  __device__ __forceinline__ void store(State* st, size_t C) const {
    front.store(st, C);
    Back::store(st, C);
  }

  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s_raw, int end_word, Slots slots,
                                       const Params& p, bool live = true) {
    int sigma;
    const int s = front.step(s_raw, p, sigma);
    Back::template tick<kU>(s, sigma, end_word, slots, p, live);
  }
};

// frugal_update(m, s, acc, limit, mask, acc_bias=kBias) on biased values.
__device__ __forceinline__ void frugal_biased(int& m, int& acc, int s,
                                              bool mask, int limit) {
  acc += mask ? clip1(s - m) : 0;
  if (acc > limit + kBias) {
    m += 1;
    acc = kBias;
  } else if (acc < -limit + kBias) {
    m -= 1;
    acc = kBias;
  }
}

__device__ __forceinline__ int pack_halves(int lo, int hi) {
  return static_cast<int>(static_cast<uint32_t>(lo) |
                          (static_cast<uint32_t>(hi) << 16));
}

// K3b's warp 0 (fir_packed): FirFront's chains with the packed SWAR carry,
// qpair = (q25 + B) | (q75 + B) << 16 and apair the same for the
// accumulators, packed from the canonical rows at load and unpacked at store
// (pallas_tpg.py:491-501, :561-574): both quantile chains run in the biased
// domain, each gated on the pre-update median, then the pedestal's.
struct FirPackedFront {
  int ped, acc, qpair, apair;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
    qpair = pack_halves((st[kQuantile25 * C] + kBias) & 0xFFFF,
                        st[kQuantile75 * C] + kBias);
    apair = pack_halves((st[kAccum25 * C] + kBias) & 0xFFFF,
                        st[kAccum75 * C] + kBias);
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    put(st, kPedestals, C, ped);
    put(st, kAccum, C, acc);
    put(st, kQuantile25, C, (qpair & 0xFFFF) - kBias);
    put(st, kQuantile75, C, ((qpair >> 16) & 0xFFFF) - kBias);
    put(st, kAccum25, C, (apair & 0xFFFF) - kBias);
    put(st, kAccum75, C, ((apair >> 16) & 0xFFFF) - kBias);
  }

  __device__ __forceinline__ int step(int s_raw, const Params& p,
                                      int& sigma) {
    const int limit = p.accumulator_limit;
    const int sb = s_raw + kBias;
    int q25 = qpair & 0xFFFF, a25 = apair & 0xFFFF;
    int q75 = (qpair >> 16) & 0xFFFF, a75 = (apair >> 16) & 0xFFFF;
    frugal_biased(q25, a25, sb, s_raw < ped, limit);
    frugal_biased(q75, a75, sb, s_raw > ped, limit);
    qpair = pack_halves(q25, q75);
    apair = pack_halves(a25, a75);
    sigma = q75 - q25;
    frugal<false>(ped, acc, s_raw, limit);
    const int s = s_raw - ped;
    return s < p.adc_max ? s : p.adc_max;
  }
};

// K3b's warp 1 (fir_packed): FirBack with ct = charge << 16 |
// prev_was_over << 15 | tover in place of the hit's charge and tover and
// of prev_was_over, packed at load and unpacked at store; each tick takes
// charge and tover out of ct for K3's hit chain and packs them back with
// the new over flag.
template <bool kPeakGated, bool kTrackPeaks, bool kAvx>
struct FirPackedBack {
  static constexpr int kWords = kTrackPeaks ? 3 : 2;
  FirHit<kPeakGated, kTrackPeaks> hit;   // peaks carried; charge/tover not
  int ct;
  int ring[kTaps];   // previous samples; oldest at ring[u % 8] for tick u
  int nclose;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    hit.load(st, C);
    ct = pack16(st[kHitCharge * C], st[kHitTover * C] & 0x7FFF) |
         (st[kPrevWasOver * C] != 0 ? 0x8000 : 0);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) ring[j] = st[(kFirRow0 + j) * C];
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    FirHit<kPeakGated, kTrackPeaks> h = hit;
    h.charge = ct >> 16;
    h.tover = ct & 0x7FFF;
    h.store(st, C);
    put(st, kPrevWasOver, C, (ct >> 15) & 1);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) put(st, kFirRow0 + j, C, ring[j]);
  }

  __device__ __forceinline__ void realign(int n) { realign_ring(ring, n); }

  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s, int sigma, int end_word,
                                       Slots slots, const Params& p,
                                       bool live) {
    const int filt = fir_filter<kU>(ring, p);
    ring[kU % kTaps] = s;
    const bool over = fir_over<kAvx>(filt, sigma, p);
    hit.charge = ct >> 16;
    hit.tover = ct & 0x7FFF;
    const bool closed = ((ct >> 15) & 1) != 0 && !over;
    int w0, w1;
    hit.step(over, fir_to_add(over, filt, p), filt, closed, w0, w1);
    // where(closed, 0, w0) | where(over, 0x8000, 0)
    ct = pack16(hit.charge, hit.tover) | (over ? 0x8000 : 0);
    if (closed && live) slot_emit<kWords>(slots, nclose, p, w0, w1, end_word);
  }
};

// fir.py::tpg_tick_fir with the packed SWAR carry (K3b, fir_packed): the
// channel type the pipeline's K3 mode reads (PipeOf) for its packed front
// and back, on an int32 state.
template <bool kPeakGated, bool kTrackPeaks, bool kAvx>
struct FirPackedChannel {
  using State = int32_t;
  static constexpr int kWords =
      FirPackedBack<kPeakGated, kTrackPeaks, kAvx>::kWords;
};

template <int kEnc>
using FeedT = std::conditional_t<kEnc == kPlain16, int16_t, int32_t>;

// The offset of 7-word group g's first word in a packed feed.
__device__ __forceinline__ size_t group_base(const Params& p, int g) {
  return static_cast<size_t>(g / p.groups_per_row) * p.group_outer +
         static_cast<size_t>(g % p.groups_per_row) * p.group_inner;
}

// ---- The warp-specialised pipeline: K1-K5, K2b and K4b ---------------------
//
// Replaces, for the FIR family, pallas_tpg.py::_tpg_kernel's fused tick on
// the plain, time2 and packed 14-bit datapaths (K3, :464-490, :556-560;
// K4's FIR) and pallas_tpg.py::_fir2_kernel on every datapath (K5,
// fir_twopass 1 and 2, :585-765); for SimpleThreshold, AbsRS and
// StandardRS, _tpg_kernel's tick on time2 rows (K1, _decode_ticks :379),
// plain samples (K2, :399-400) and packed 14-bit words (K4,
// _unpack14_rows :241-265); for every family, the tick on the native int16
// state (K2b, i16_mode :475-476: kPipeThreshold and kPipeK3 with the
// channel type's kI16, which every role takes for its arithmetic and its
// state rows) and on words14 rows through the gather (K4b-gather,
// _unpack14_rows_gather :268-305) and the slab (K4b-slab, _unpack14_slab
// :308-329, the schedule :445-463: warp 0 unpacks each stage into a time2
// slab of the ring before its front reads it); and for FIR with the SWAR
// carry, the same on every encoding but int16 (K3b, fir_packed :466-501,
// :561-574: kPipeK3 with FirPackedChannel's front and back).  Same outputs
// as the plain versions, bit for bit.
//
// A tick is a few chains that need little of each other.  FIR: (a) the
// pedestal and IQR frugal chains (FirFront), which need only the raw sample
// and their own state; (b) the 8-tap filter, the threshold and to_add, no
// recurrence; (c) the hit chain (FirHit).  The threshold families: (a) the
// raw pedestal's frugal chain, which gives s; (r) for AbsRS and StandardRS
// the running sum on the carried rs and its own frugal pedestal (RsChain),
// which give x and over = x > threshold; (c) the hit chain (ThresholdHit),
// which needs s and over only: closed = rs(t-1) > threshold && !over(t) is
// over(t-1) && !over(t), the window's first over(t-1) from the carried rs.
// One thread running the pieces in turn pays the sum of their latencies
// every tick (P1: a dependent op costs ~4.7 SM cycles with one warp per
// scheduler, and 2560 channels leave 448 of the 528 schedulers idle).  Here
// a block owns 32 consecutive channels and gives the pieces warps of their
// own, so a tick costs the longest chain, not the sum:
//   warp 0  the loader and front: copies the feed of each stage of
//           kPipeTicks ticks into a ring of kPipeStages shared-memory slabs
//           with cp.async, kPipeStages - 1 stages ahead of its chain, each
//           stage completing on its `full` mbarrier; then runs (a) over the
//           stage and writes s into the stage's slab (FIR: clamped, and
//           sigma).  K4b-slab: before (a), one pass unpacks the stage's
//           words14 rows into its time2 slab, hands the feed slab back to
//           the loader, and (a) reads the time2 slab as K1's front does;
//   K3, warp 1  (b) and (c) on each stage's s and sigma (FirBack, the FIR
//           ring in its registers) and the emission into the K slots
//           (direct, or SLOT_WORD_CARRY in columns of 32);
//   K5, warp 1  (b): is_over, to_add and filt into the stage's slabs, and
//           with lift (fir_twopass=2) the closed flag, over(t-1) && !over(t)
//           on its carried prev_was_over;
//       warp 2  (c) and the emission: the close tested in place (fir_twopass
//           1) or read from the slab (2);
//   K1, K2, K4 and K2b (kPipeThreshold), RS families, warp 1  (r): over
//           into the stage's flag slab;
//       the hit warp (warp 2; warp 1 for SimpleThreshold, which tests
//           s > threshold itself, a two-warp mode)  (c) on s and over, and
//           the emission (direct, or SLOT_WORD_CARRY).
// Each warp loads and writes back only its own state rows: the front the
// pedestal rows (FIR: and the IQR rows), the RS warp rs, pedestals_rs and
// accum_rs (the memory factor read only), the filter the FIR ring, the hit
// warp the hit rows (and prev_was_over where it carries it).  The RS
// families' hit warp reads the carried rs before the block's first barrier,
// so the RS warp's write-back of rs cannot come before it.
// A stage's slabs go round the ring through mbarriers: `full` (the feed has
// landed), `ready` (s written), `s_empty` (s read, by each warp that reads
// it), `filtered` and `f_empty` (K5's filter slabs, the RS warp's flags:
// written, read).  A producer waits for the previous round's release of the
// slot before it writes, a consumer for the round's completion before it
// reads (parity waits).  A stage never straddles a chunk (a chunk is
// ceil(tc / kPipeTicks) stages, the last one ragged), so each role runs a
// stage as groups of kGroup ticks with the tail guarded and the FIR ring
// realigned after it, a chunk's nclose and slots begin with its first
// stage and are stored with its last, and tick u of a stage ends at window
// tick t0 + u + 1.  Lanes past the last channel run the loops with the
// others (every warp arrives at every barrier) and store nothing.  K5 takes
// no global scratch: its slabs are the ring.  On the int16 state (K2b) the
// slabs stay int32: s, sigma and the flags are held sign-extended, and each
// role wraps its own ops (w16) as the channel types do.  The staged arm
// (kPipeStaged, tpg_fir_staged_launch and tpg_threshold_staged_launch,
// measured by the probes against K1-K4 and K2b) is one warp that copies the
// feed the same way and runs the channel's whole fused tick.
//
// What bounds it: the slowest warp's instructions per tick, if the others
// keep up (~3 SM cycles each on an H100, above the loop-carried chain;
// PERF.md); the ring's barriers cost a few waits per stage of 32 ticks.
constexpr int kPipeLanes = 32;    // channels per block
constexpr int kPipeTicks = 32;    // ticks per stage, a multiple of kGroup
constexpr int kPipeStages = 4;    // stages in the ring
constexpr int kStageWords = kPipeTicks * kPipeLanes;   // one slab
constexpr int kPipeBars = 5 * kPipeStages;   // full, ready, s_empty,
                                             // filtered, f_empty
constexpr int kMbarrierBytes = 8;
static_assert(kPipeTicks % kGroup == 0, "a stage is whole groups");

enum PipeMode : int {
  kPipeStaged = 0,     // one warp: the staged feed and the whole tick
  kPipeK3 = 1,         // loader + front; filter + hit
  kPipeK5 = 2,         // loader + front; filter; hit (fir_twopass 1)
  kPipeK5Lift = 3,     // the same, closed from the filter warp (2)
  kPipeThreshold = 4   // loader + front; running sum (RS families); hit
};

// What the pipeline reads of a channel type: its family and options, and
// for FIR the chains of K3's two warps (Front: warp 0's, Back: warp 1's;
// void for the threshold families, whose roles are their own).
template <class Ch>
struct PipeOf;

template <bool kG, bool kP, bool kA, bool kI>
struct PipeOf<FirChannel<kG, kP, kA, kI>> {
  static constexpr int kFamily = kFIR;
  static constexpr bool kGated = kG, kPeaks = kP, kAvx = kA;
  static constexpr bool kFloor = true, kRsFloat = false, kI16 = kI;
  using Front = FirFront<kI>;
  using Back = FirBack<kG, kP, kA>;
};

template <bool kG, bool kP, bool kA>
struct PipeOf<FirPackedChannel<kG, kP, kA>> {
  static constexpr int kFamily = kFIR;
  static constexpr bool kGated = kG, kPeaks = kP, kAvx = kA;
  static constexpr bool kFloor = true, kRsFloat = false, kI16 = false;
  using Front = FirPackedFront;
  using Back = FirPackedBack<kG, kP, kA>;
};

template <int kF, bool kG, bool kFl, bool kI, bool kR>
struct PipeOf<ThresholdChannel<kF, kG, kFl, kI, kR>> {
  static constexpr int kFamily = kF;
  static constexpr bool kGated = kG, kPeaks = true, kAvx = false;
  static constexpr bool kFloor = kFl, kRsFloat = kR, kI16 = kI;
  using Front = void;
  using Back = void;
};

// The threshold pipeline's RS warp (AbsRS, StandardRS).
template <int kMode, class Ch>
constexpr bool kPipeRsWarp =
    kMode == kPipeThreshold && PipeOf<Ch>::kFamily != kSimpleThreshold;

template <int kMode, class Ch>
constexpr int kPipeWarps =
    kMode == kPipeStaged
        ? 1
        : (kMode == kPipeK3 ||
                   (kMode == kPipeThreshold && !kPipeRsWarp<kMode, Ch>)
               ? 2
               : 3);

// The slabs of one stage: the feed; s and sigma (K3, K5); K5's flags
// (is_over | closed << 1), to_add, and filt with peaks; s and the RS
// warp's over flags (K1, K2, K4, K2b); then for K4b-slab (kSlab14) the
// stage's time2 slab, its words14 rows unpacked.  The one rule, for the
// launch (kPipeSlabs) and for fused_shared_bytes from the run-time variant.
constexpr int pipe_slabs(int enc, int mode, int family, bool peaks) {
  return (mode == kPipeStaged
              ? 1
              : (mode == kPipeK3
                     ? 3
                     : (mode == kPipeThreshold
                            ? (family != kSimpleThreshold ? 3 : 2)
                            : 5 + (peaks ? 1 : 0)))) +
         (enc == kSlab14 ? 1 : 0);
}

template <int kEnc, int kMode, class Ch>
constexpr int kPipeSlabs =
    pipe_slabs(kEnc, kMode, PipeOf<Ch>::kFamily, PipeOf<Ch>::kPeaks);

// Dynamic shared memory of one block in bytes: the ring of `slabs` slabs
// per stage, then the carry layout's staging in columns of kPipeLanes.
// The launch refuses more than a block may use, with the mbarriers.
inline long long pipe_shared_bytes(const Params& p, int slabs, int n_words,
                                   bool carry) {
  return 4LL * (static_cast<long long>(slabs) * kPipeStages * kStageWords +
                (carry ? carry_stage_words(carry_limit(p), n_words,
                                           kPipeLanes)
                       : 0));
}

// Shared memory of one block of the fused tick's launch (dispatch_fused) in
// bytes, as that launch counts it against kMaxSharedBytes: the pipeline's
// ring, its carry staging and its mbarriers (K3b's ring is K3's).  The C
// entry tpg_shared_bytes (tpg.cu) gives it to ops/tpg.py::
// carry_shared_bytes for the wrapper's own refusal.
inline long long fused_shared_bytes(const Params& p, const Variant& v,
                                    int enc, bool carry) {
  const int n_words = v.family == kFIR && !v.track_peaks ? 2 : 3;
  const int mode = v.family == kFIR ? kPipeK3 : kPipeThreshold;
  return pipe_shared_bytes(p, pipe_slabs(enc, mode, v.family, v.track_peaks),
                           n_words, carry) +
         kPipeBars * kMbarrierBytes;
}

// The ring's primitives: an mbarrier, a 4-byte cp.async into shared memory
// and its arrival on an mbarrier.  The host build for the CPU tests takes
// the stand-ins of tests/cuda_host/cuda_runtime.h (a plain copy; host
// barriers with the same arrive and parity wait).
#ifndef TPG_HOST_EMULATION
struct StageBar {
  unsigned long long word;
};

__device__ __forceinline__ unsigned shared_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void stage_bar_init(StageBar* bar,
                                               unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival, releasing the thread's earlier shared-memory writes to the
// threads that wait for the phase.
__device__ __forceinline__ void stage_bar_arrive(StageBar* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   shared_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool stage_bar_try(StageBar* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(shared_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  No wait of the
// ring lasts longer than a stage of its producer, so one that outlasts
// 2^32 SM cycles (~2 s) is a fault: the kernel traps (the launch fails)
// rather than hang the card.
__device__ __forceinline__ void stage_bar_wait(StageBar* bar,
                                               unsigned parity) {
  if (stage_bar_try(bar, parity)) return;
  const long long start = clock64();
  while (!stage_bar_try(bar, parity))
    if (clock64() - start > (1LL << 32)) __trap();
}

// Copy one int32 from global into shared memory, asynchronously.
__device__ __forceinline__ void stage_copy(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every earlier stage_copy of the thread has
// landed (the barrier's count holds it).
__device__ __forceinline__ void stage_copy_arrive(StageBar* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   shared_addr(bar))
               : "memory");
}
#endif

// Stage q of the window: its chunk, first window tick and tick count.
struct PipeStage {
  int chunk, t0, n;
  bool first, last;   // the chunk's first and last stage
};

__device__ __forceinline__ PipeStage pipe_stage(const Params& p, int q) {
  const int tc = p.ticks_per_chunk;
  const int per = (tc + kPipeTicks - 1) / kPipeTicks;
  const int off = (q % per) * kPipeTicks;
  PipeStage st;
  st.chunk = q / per;
  st.t0 = st.chunk * tc + off;
  st.n = tc - off < kPipeTicks ? tc - off : kPipeTicks;
  st.first = off == 0;
  st.last = off + kPipeTicks >= tc;
  return st;
}

template <bool kGuard, class F, int... kU>
__device__ __forceinline__ void each_tick(int n, F& f,
                                          std::integer_sequence<int, kU...>) {
  ((!kGuard || kU < n ? f(std::integral_constant<int, kU>{}) : void()), ...);
}

// f(u) for the ticks of a group, u a compile-time constant; kGuard: only
// the first n.
template <bool kGuard, class F>
__device__ __forceinline__ void each_tick(int n, F&& f) {
  each_tick<kGuard>(n, f, std::make_integer_sequence<int, kGroup>{});
}

// A role's ticks over a stage of n ticks: groups of kGroup, the tail
// guarded and followed by the role's realignment.  The group loop stays a
// loop (one group's body in the machine code, whose dependent chain the
// probes count).
template <class Role>
__device__ __forceinline__ void run_stage(Role& role, int n) {
  int g = 0;
#pragma unroll 1
  for (; g + kGroup <= n; g += kGroup) role.template group<false>(g, kGroup);
  if (g < n) {
    role.template group<true>(g, n - g);
    role.realign(n - g);
  }
}

// One lane's part of a stage's feed: its copies and its decode.  Plain and
// time2 rows: the lane copies its channel's words into its column of the
// feed slab.  Packed 14-bit words (K4, K4b, K5): a warp's 32 channels are
// two 7-word groups; lane k < 14 copies word k % 7 of group k / 7 of every
// tick into column k of the tick's row, and every lane takes its low and
// high word from the row (the gather of _unpack14_rows_gather as an
// exchange through shared memory) and funnel-shifts as K4's fused tick
// does: the decode leaves the chain.  K4b-slab (kSlab14) copies the same
// rows, and unpack() turns a stage of them into time2 words, which the
// front reads as K1's does.
// int16 samples (K2b): where a row starts on a 4-byte boundary (an even
// stride from an aligned feed; every block's first channel is a multiple of
// 32), lane l < 16 copies the word of channels 2l and 2l + 1 into column l
// of the row, and every lane takes its half of that word, the low one
// sign-extended and the high one by an arithmetic shift, as the time2 split
// does (`pairs`).  Otherwise (an odd stride) each lane loads its own sample
// with a plain load, stores it sign-extended into its column and arrives on
// the same `full` barrier: one feed path or the other per launch.
template <int kEnc>
struct PipeFeed {
  static constexpr bool kPacked =
      kEnc == kPacked14 || kEnc == kGather14 || kEnc == kSlab14;
  // a lane reads words that other lanes copied: the warp meets before it
  // copies the next round into the slab
  static constexpr bool kShared = kPacked || kEnc == kPlain16;
  // ticks per staged feed row: two in a time2 word; one tick's words per
  // row of packed words, K4b-slab's included (the loader stages its raw
  // rows; the unpack pass makes the time2 slab)
  static constexpr int kFeedRowTicks = kEnc == kTime2 ? 2 : 1;
  const FeedT<kEnc>* src;   // the lane's word of tick 0, or null: no copies
  size_t stride;
  int lane;
  int src_lo, src_hi;   // packed: the lane's two words in a row
  unsigned sh;
  bool pairs;           // int16: 4-byte copies of sample pairs
  int col, shl, shr;    // int16: the lane's word in a row and its half

  __device__ __forceinline__ void init(const Params& p, int c0, int lane_) {
    lane = lane_;
    stride = static_cast<size_t>(p.feed_stride);
    const int c = c0 + lane;
    const FeedT<kEnc>* feed = static_cast<const FeedT<kEnc>*>(p.feed);
    src = nullptr;
    src_lo = src_hi = 0;
    sh = 0;
    pairs = false;
    col = lane;
    shl = shr = 0;
    if constexpr (kEnc == kPlain16) {
      pairs = p.feed_stride % 2 == 0 &&
              (reinterpret_cast<uintptr_t>(p.feed) & 3) == 0;
      if (pairs) {
        col = lane / 2;
        shl = lane % 2 == 0 ? 16 : 0;
        shr = 16;
        if (lane < kPipeLanes / 2 && c0 + 2 * lane < p.n_channels)
          src = feed + c0 + 2 * lane;
      } else if (c < p.n_channels) {
        src = feed + c;
      }
    } else if constexpr (kPacked) {
      const int g0 = c0 / 16, g = c / 16, r = c % 16;
      const int j = 14 * r / 32;
      // class 15 ends on its group's last bit: read word 6 twice
      src_lo = (g - g0) * 7 + j;
      src_hi = (g - g0) * 7 + (j < 6 ? j + 1 : 6);
      sh = static_cast<unsigned>(14 * r % 32);
      if (lane < 14 && (g0 + lane / 7) * 16 < p.n_channels)
        src = feed + group_base(p, g0 + lane / 7) +
              static_cast<size_t>(lane % 7) * p.word_stride;
    } else {
      if (c < p.n_channels) src = feed + c;
    }
  }

  // Copy stage st's feed into `slab`; arrive on `full` when it has landed.
  __device__ __forceinline__ void issue(const PipeStage& st, int32_t* slab,
                                        StageBar* full) const {
    if constexpr (kEnc == kPlain16) {
      if (!pairs) {
        load_rows(st, slab);
        stage_bar_arrive(full);
        return;
      }
    }
    if (src != nullptr) {
      const int rows = st.n / kFeedRowTicks;
      const FeedT<kEnc>* from =
          src + static_cast<size_t>(st.t0 / kFeedRowTicks) * stride;
      for (int r = 0; r < rows; ++r)
        stage_copy(slab + r * kPipeLanes + lane,
                   reinterpret_cast<const int32_t*>(
                       from + static_cast<size_t>(r) * stride));
    }
    stage_copy_arrive(full);
  }

  // int16 samples at an odd stride: the lane's own samples of stage st,
  // loaded kLoadBatch rows at a time (their latencies overlap) and stored
  // sign-extended into its column.
  __device__ __forceinline__ void load_rows(const PipeStage& st,
                                            int32_t* slab) const {
    constexpr int kLoadBatch = 8;
    if (src == nullptr) return;
    const FeedT<kEnc>* from = src + static_cast<size_t>(st.t0) * stride;
    for (int r0 = 0; r0 < st.n; r0 += kLoadBatch) {
      int v[kLoadBatch];
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i)
        v[i] = r0 + i < st.n
                   ? __ldg(from + static_cast<size_t>(r0 + i) * stride)
                   : 0;
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i)
        if (r0 + i < st.n) slab[(r0 + i) * kPipeLanes + lane] = v[i];
    }
  }

  // The lane's 14-bit sample from a staged row of packed words.
  __device__ __forceinline__ int decode14(const int32_t* row) const {
    return static_cast<int>(
        __funnelshift_r(static_cast<unsigned>(row[src_lo]),
                        static_cast<unsigned>(row[src_hi]), sh) &
        0x3FFFu);
  }

  // K4b-slab: the n ticks of a stage's packed words (`raw`, n a multiple
  // of kGroup) unpacked into its time2 slab, tick pair u of the lane's
  // channel at t2[u * kPipeLanes + lane] = (v[2u] & 0xFFFF) | v[2u+1] << 16
  // as _unpack14_slab packs them (:455-459); a group's loads go out before
  // its stores.
  __device__ __forceinline__ void unpack(const int32_t* raw, int32_t* t2,
                                         int n) const {
#pragma unroll 1
    for (int g = 0; g < n; g += kGroup) {
      int v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        v[u] = decode14(raw + (g + u) * kPipeLanes);
#pragma unroll
      for (int u = 0; u < kGroup / 2; ++u)
        t2[(g / 2 + u) * kPipeLanes + lane] =
            pack16(v[2 * u + 1], v[2 * u] & 0xFFFF);
    }
  }

  // The sample of tick g + kU of the stage (g a multiple of kGroup), from
  // the feed slab (K4b-slab: from the stage's time2 slab).
  template <int kU>
  __device__ __forceinline__ int sample(const int32_t* slab, int g) const {
    if constexpr (kEnc == kPlain16) {
      const uint32_t w =
          static_cast<uint32_t>(slab[(g + kU) * kPipeLanes + col]);
      return static_cast<int>(w << shl) >> shr;
    } else if constexpr (kEnc == kTime2 || kEnc == kSlab14) {
      const int w = slab[(g / 2 + kU / 2) * kPipeLanes + lane];
      return kU % 2 == 0 ? wrap_i16(w) : (w >> 16);
    } else if constexpr (kPacked) {
      return decode14(slab + (g + kU) * kPipeLanes);
    } else {
      return slab[(g + kU) * kPipeLanes + lane];
    }
  }
};

// Warp 0's chain, FIR: (a) over a stage, s and sigma into the lane's
// columns: Front is FirFront (kI16: the int16 state's arithmetic) or K3b's
// FirPackedFront.
template <int kEnc, class Front>
struct PipeFront {
  Front front;
  PipeFeed<kEnc> feed;
  const int32_t* in;   // the stage's feed slab
  int32_t* s;
  int32_t* sigma;
  const Params* p;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    front.load(st, C);
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    front.store(st, C);
  }

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int x[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      x[kU] = !kGuard || kU < n ? feed.template sample<kU>(in, g) : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      int sg;
      s[(g + kU) * kPipeLanes] = front.step(x[kU], *p, sg);
      sigma[(g + kU) * kPipeLanes] = sg;
    });
  }

  __device__ __forceinline__ void realign(int) {}
};

// Warp 0's chain, threshold families: the raw pedestal's frugal update
// over a stage, s = sample - pedestal into the lane's column (kI16: both
// wrapped through int16, as ThresholdChannel::tick).
template <int kEnc, bool kI16>
struct PipeThresholdFront {
  int ped, acc;
  PipeFeed<kEnc> feed;
  const int32_t* in;   // the stage's feed slab
  int32_t* s;
  const Params* p;

  template <class S>
  __device__ __forceinline__ void load(const S* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
  }

  template <class S>
  __device__ __forceinline__ void store(S* st, size_t C) const {
    put(st, kPedestals, C, ped);
    put(st, kAccum, C, acc);
  }

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int x[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      x[kU] = !kGuard || kU < n ? feed.template sample<kU>(in, g) : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      frugal<kI16>(ped, acc, x[kU], p->accumulator_limit);
      s[(g + kU) * kPipeLanes] = w16<kI16>(x[kU] - ped);
    });
  }

  __device__ __forceinline__ void realign(int) {}
};

// K3's warp 1: (b) and (c) on a stage's s and sigma, the closes into the
// chunk's slots: its direct-store base, or its CarrySlots (kCarry).  Back
// is FirBack or K3b's FirPackedBack.
template <class Back, bool kCarry>
struct PipeBack {
  Back back;
  CarrySlots<Back::kWords, kPipeLanes> carry;
  int32_t* base;
  const int32_t* s;
  const int32_t* sigma;
  int t0;
  bool live;
  const Params* p;

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int sv[kGroup], gv[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const bool in = !kGuard || kU < n;
      sv[kU] = in ? s[(g + kU) * kPipeLanes] : 0;
      gv[kU] = in ? sigma[(g + kU) * kPipeLanes] : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      if constexpr (kCarry)
        back.template tick<kU>(sv[kU], gv[kU], t0 + g + kU + 1, &carry, *p,
                               live);
      else
        back.template tick<kU>(sv[kU], gv[kU], t0 + g + kU + 1, base, *p,
                               live);
    });
  }

  __device__ __forceinline__ void realign(int n) { back.realign(n); }
};

// K5's warp 1: (b) over a stage; with lift also the closed flag.
template <bool kPeaks, bool kAvx, bool kLift>
struct PipeFilter {
  int ring[kTaps];   // previous samples; oldest at ring[u % 8] for tick u
  int prev_over;     // lift: is_over of the tick before
  const int32_t* s;
  const int32_t* sigma;
  int32_t* flags;
  int32_t* add;
  int32_t* filt;
  const Params* p;

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int sv[kGroup], gv[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const bool in = !kGuard || kU < n;
      sv[kU] = in ? s[(g + kU) * kPipeLanes] : 0;
      gv[kU] = in ? sigma[(g + kU) * kPipeLanes] : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const int at = (g + kU) * kPipeLanes;
      const int f = fir_filter<kU>(ring, *p);
      ring[kU % kTaps] = sv[kU];
      const bool over = fir_over<kAvx>(f, gv[kU], *p);
      int fl = over ? 1 : 0;
      if constexpr (kLift) {
        fl |= prev_over != 0 && !over ? 2 : 0;
        prev_over = over ? 1 : 0;
      }
      flags[at] = fl;
      add[at] = fir_to_add(over, f, *p);
      if constexpr (kPeaks) filt[at] = f;
    });
  }

  __device__ __forceinline__ void realign(int n) { realign_ring(ring, n); }
};

// K5's warp 2: (c) over a stage and the direct-store emission.
template <bool kGated, bool kPeaks, bool kLift>
struct PipeHit {
  static constexpr int kWords = kPeaks ? 3 : 2;
  FirHit<kGated, kPeaks> hit;
  int prev_over;     // fir_twopass 1: is_over of the tick before
  int nclose;
  int32_t* base;     // the chunk's slot base
  const int32_t* flags;
  const int32_t* add;
  const int32_t* filt;
  int t0;
  bool live;
  const Params* p;

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int fl[kGroup], ad[kGroup], ft[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const bool in = !kGuard || kU < n;
      fl[kU] = in ? flags[(g + kU) * kPipeLanes] : 0;
      ad[kU] = in ? add[(g + kU) * kPipeLanes] : 0;
      ft[kU] = kPeaks && in ? filt[(g + kU) * kPipeLanes] : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const bool over = (fl[kU] & 1) != 0;
      bool closed;
      if constexpr (kLift) {
        closed = (fl[kU] & 2) != 0;
      } else {
        closed = prev_over != 0 && !over;
        prev_over = over ? 1 : 0;
      }
      int w0, w1;
      hit.step(over, ad[kU], ft[kU], closed, w0, w1);
      if (closed && live)
        emit<kWords>(nclose, base, *p, w0, w1, t0 + g + kU + 1);
    });
  }

  __device__ __forceinline__ void realign(int) {}
};

// The threshold pipeline's RS warp: (r) over a stage, the running sum and
// its pedestal on each tick's s, over into the lane's flag column; rs
// carries x from tick to tick (kI16: the int16 state's arithmetic).
template <int kFamily, bool kI16, bool kRsFloat>
struct PipeRs {
  RsChain<kFamily, kI16, kRsFloat> rsc;
  const int32_t* s;
  int32_t* flags;
  const Params* p;

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int sv[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      sv[kU] = !kGuard || kU < n ? s[(g + kU) * kPipeLanes] : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      rsc.rs = rsc.step(sv[kU], *p);
      flags[(g + kU) * kPipeLanes] = rsc.rs > p->threshold ? 1 : 0;
    });
  }

  __device__ __forceinline__ void realign(int) {}
};

// The threshold pipeline's hit warp: (c) over a stage on s and over (read
// from the RS warp's flags, or s > threshold for SimpleThreshold), the
// closes into the chunk's slots: its direct-store base, or its CarrySlots
// (kCarry).  prev_over is over of the tick before.
template <bool kGated, bool kFloor, bool kSimple, bool kCarry>
struct PipeThresholdHit {
  static constexpr int kWords = 3;
  ThresholdHit<kGated, kFloor> hit;
  CarrySlots<kWords, kPipeLanes> carry;
  int prev_over;
  int nclose;
  int32_t* base;     // the chunk's slot base
  const int32_t* s;
  const int32_t* flags;
  int t0;
  bool live;
  const Params* p;

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int sv[kGroup], ov[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const bool in = !kGuard || kU < n;
      sv[kU] = in ? s[(g + kU) * kPipeLanes] : 0;
      ov[kU] = !kSimple && in ? flags[(g + kU) * kPipeLanes] : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      const bool over = kSimple ? sv[kU] > p->threshold : ov[kU] != 0;
      const bool closed = prev_over != 0 && !over;
      prev_over = over ? 1 : 0;
      int w0, w1;
      hit.step(sv[kU], over, closed, w0, w1);
      if (closed && live) {
        if constexpr (kCarry)
          carry.emit(nclose, w0, w1, t0 + g + kU + 1);
        else
          emit<kWords>(nclose, base, *p, w0, w1, t0 + g + kU + 1);
      }
    });
  }

  __device__ __forceinline__ void realign(int) {}
};

// The staged arm's warp: the channel's whole fused tick on the staged feed.
template <int kEnc, class Ch>
struct PipeWhole {
  Ch ch;
  PipeFeed<kEnc> feed;
  const int32_t* in;
  int32_t* base;
  int t0;
  bool live;
  const Params* p;

  template <bool kGuard>
  __device__ __forceinline__ void group(int g, int n) {
    int x[kGroup];
    each_tick<false>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      x[kU] = !kGuard || kU < n ? feed.template sample<kU>(in, g) : 0;
    });
    each_tick<kGuard>(n, [&](auto u) {
      constexpr int kU = decltype(u)::value;
      ch.template tick<kU>(x[kU], t0 + g + kU + 1, base, *p, live);
    });
  }

  __device__ __forceinline__ void realign(int n) { ch.realign(n); }
};

// The pipeline of mode kMode for channel type Ch (FirChannel for the FIR
// modes, FirPackedChannel too for kPipeK3, FirChannel or ThresholdChannel
// for the staged arm, ThresholdChannel for kPipeThreshold)
// on the channel type's state (int32, or int16 for K2b: kPipeThreshold,
// kPipeK3 and the threshold staged arm), with the direct store or the
// carry layout (kCarry: K3 and kPipeThreshold).
template <int kEnc, int kMode, class Ch, bool kCarry>
__global__ void __launch_bounds__(kPipeWarps<kMode, Ch> * kPipeLanes, 1)
    pipe_kernel(Params p) {
  using Of = PipeOf<Ch>;
  constexpr int kWords = Ch::kWords;
  constexpr bool kLift = kMode == kPipeK5Lift;
  constexpr bool kRsWarp = kPipeRsWarp<kMode, Ch>;
  TPG_DYNAMIC_SHARED(int32_t, smem);
  __shared__ StageBar bars[kPipeBars];
  StageBar* const full = bars;
  StageBar* const ready = bars + kPipeStages;
  StageBar* const s_empty = bars + 2 * kPipeStages;
  StageBar* const filtered = bars + 3 * kPipeStages;
  StageBar* const f_empty = bars + 4 * kPipeStages;
  const int warp = threadIdx.x / kPipeLanes;
  const int lane = threadIdx.x % kPipeLanes;
  const int c0 = blockIdx.x * kPipeLanes;
  const int c = c0 + lane;
  const bool live = c < p.n_channels;
  const size_t C = static_cast<size_t>(p.n_channels);
  typename Ch::State* const st =
      static_cast<typename Ch::State*>(p.state) + c;
  // the chunk's slot words of the channel, and slab i of ring slot j
  auto slot_base = [&](int chunk) {
    return p.slots + static_cast<size_t>(chunk) * p.k_slots * kWords * C + c;
  };
  auto slab = [&](int i, int j) {
    return smem + (i * kPipeStages + j) * kStageWords;
  };
  // the carry layout's staging after the ring, the lane's column
  int32_t* const stage =
      smem + kPipeSlabs<kEnc, kMode, Ch> * kPipeStages * kStageWords + lane;
  // the RS families' hit warp: the carried rs, read before the barrier
  // below (the RS warp writes rs back at its end)
  const int rs0 = kRsWarp && warp == 2 && live ? st[kRs * C] : 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kPipeBars; ++i)
      // s_empty: the RS warp and the hit warp both read s
      stage_bar_init(&bars[i], (kRsWarp && i / kPipeStages == 2 ? 2 : 1) *
                                   kPipeLanes);
  __syncthreads();
  const int n_stages =
      p.n_chunks * ((p.ticks_per_chunk + kPipeTicks - 1) / kPipeTicks);

  if (warp == 0) {
    PipeFeed<kEnc> feed;
    feed.init(p, c0, lane);
    for (int q = 0; q < n_stages && q < kPipeStages; ++q)
      feed.issue(pipe_stage(p, q), slab(0, q), &full[q]);
    if constexpr (kMode == kPipeStaged) {
      PipeWhole<kEnc, Ch> w{};
      w.feed = feed;
      w.live = live;
      w.p = &p;
      if (live) w.ch.load(st, C);
      for (int q = 0; q < n_stages; ++q) {
        const PipeStage sg = pipe_stage(p, q);
        const int j = q % kPipeStages;
        stage_bar_wait(&full[j], (q / kPipeStages) & 1);
        if (sg.first) {
          w.ch.nclose = 0;
          w.base = slot_base(sg.chunk);
        }
        w.in = slab(0, j);
        w.t0 = sg.t0;
        run_stage(w, sg.n);
        if (sg.last && live) p.nclose[sg.chunk * C + c] = w.ch.nclose;
        // packed and int16 rows are read across lanes: all reads before
        // the refill
        if constexpr (PipeFeed<kEnc>::kShared) __syncwarp();
        if (q + kPipeStages < n_stages)
          feed.issue(pipe_stage(p, q + kPipeStages), slab(0, j), &full[j]);
      }
      if (live) w.ch.store(st, C);
    } else {
      std::conditional_t<Of::kFamily == kFIR,
                         PipeFront<kEnc, typename Of::Front>,
                         PipeThresholdFront<kEnc, Of::kI16>>
          a{};
      // K4b-slab's time2 slab, the stage's last
      constexpr int kT2 = kPipeSlabs<kEnc, kMode, Ch> - 1;
      a.feed = feed;
      a.p = &p;
      if (live) a.load(st, C);
      for (int q = 0; q < n_stages; ++q) {
        const PipeStage sg = pipe_stage(p, q);
        const int j = q % kPipeStages;
        const unsigned round = (q / kPipeStages) & 1;
        stage_bar_wait(&full[j], round);
        if constexpr (kEnc == kSlab14) {
          // the stage's words14 rows into its time2 slab in one pass, off
          // the front's chain; the lanes read each other's words, so the
          // warp meets before the feed slab goes back to the loader
          feed.unpack(slab(0, j), slab(kT2, j), sg.n);
          __syncwarp();
          if (q + kPipeStages < n_stages)
            feed.issue(pipe_stage(p, q + kPipeStages), slab(0, j), &full[j]);
        }
        stage_bar_wait(&s_empty[j], round ^ 1);
        a.in = slab(kEnc == kSlab14 ? kT2 : 0, j);
        a.s = slab(1, j) + lane;
        if constexpr (Of::kFamily == kFIR) a.sigma = slab(2, j) + lane;
        run_stage(a, sg.n);
        stage_bar_arrive(&ready[j]);
        if constexpr (kEnc != kSlab14) {
          // packed and int16 rows are read across lanes: all reads before
          // the refill
          if constexpr (PipeFeed<kEnc>::kShared) __syncwarp();
          if (q + kPipeStages < n_stages)
            feed.issue(pipe_stage(p, q + kPipeStages), slab(0, j), &full[j]);
        }
      }
      if (live) a.store(st, C);
    }
  } else if constexpr (kMode == kPipeK3) {
    PipeBack<typename Of::Back, kCarry> b{};
    b.live = live;
    b.p = &p;
    if (live) b.back.load(st, C);
    for (int q = 0; q < n_stages; ++q) {
      const PipeStage sg = pipe_stage(p, q);
      const int j = q % kPipeStages;
      stage_bar_wait(&ready[j], (q / kPipeStages) & 1);
      if (sg.first) {
        b.back.nclose = 0;
        b.base = slot_base(sg.chunk);
        if constexpr (kCarry) b.carry.begin(b.base, stage, p);
      }
      b.s = slab(1, j) + lane;
      b.sigma = slab(2, j) + lane;
      b.t0 = sg.t0;
      run_stage(b, sg.n);
      stage_bar_arrive(&s_empty[j]);
      if (sg.last && live) {
        if constexpr (kCarry) b.carry.flush(b.back.nclose, p);
        p.nclose[sg.chunk * C + c] = b.back.nclose;
      }
    }
    if (live) b.back.store(st, C);
  } else if constexpr (kMode == kPipeK5 || kMode == kPipeK5Lift) {
    if (warp == 1) {
      PipeFilter<Of::kPeaks, Of::kAvx, kLift> f{};
      f.p = &p;
      if (live) {
#pragma unroll
        for (int i = 0; i < kTaps; ++i) f.ring[i] = st[(kFirRow0 + i) * C];
        if (kLift) f.prev_over = st[kPrevWasOver * C];
      }
      for (int q = 0; q < n_stages; ++q) {
        const PipeStage sg = pipe_stage(p, q);
        const int j = q % kPipeStages;
        const unsigned round = (q / kPipeStages) & 1;
        stage_bar_wait(&ready[j], round);
        stage_bar_wait(&f_empty[j], round ^ 1);
        f.s = slab(1, j) + lane;
        f.sigma = slab(2, j) + lane;
        f.flags = slab(3, j) + lane;
        f.add = slab(4, j) + lane;
        if (Of::kPeaks) f.filt = slab(5, j) + lane;
        run_stage(f, sg.n);
        stage_bar_arrive(&s_empty[j]);
        stage_bar_arrive(&filtered[j]);
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < kTaps; ++i) put(st, kFirRow0 + i, C, f.ring[i]);
        if (kLift) put(st, kPrevWasOver, C, f.prev_over);
      }
    } else {
      PipeHit<Of::kGated, Of::kPeaks, kLift> h{};
      h.live = live;
      h.p = &p;
      if (live) {
        h.hit.load(st, C);
        if (!kLift) h.prev_over = st[kPrevWasOver * C];
      }
      for (int q = 0; q < n_stages; ++q) {
        const PipeStage sg = pipe_stage(p, q);
        const int j = q % kPipeStages;
        stage_bar_wait(&filtered[j], (q / kPipeStages) & 1);
        if (sg.first) {
          h.nclose = 0;
          h.base = slot_base(sg.chunk);
        }
        h.flags = slab(3, j) + lane;
        h.add = slab(4, j) + lane;
        if (Of::kPeaks) h.filt = slab(5, j) + lane;
        h.t0 = sg.t0;
        run_stage(h, sg.n);
        stage_bar_arrive(&f_empty[j]);
        if (sg.last && live) p.nclose[sg.chunk * C + c] = h.nclose;
      }
      if (live) {
        h.hit.store(st, C);
        if (!kLift) put(st, kPrevWasOver, C, h.prev_over);
      }
    }
  } else if constexpr (kMode == kPipeThreshold) {
    // the RS warp; the hit warp below is warp 2 (warp 1 for
    // SimpleThreshold)
    if constexpr (kRsWarp) {
      if (warp == 1) {
        PipeRs<Of::kFamily, Of::kI16, Of::kRsFloat> r{};
        r.p = &p;
        if (live) r.rsc.load(st, C);
        for (int q = 0; q < n_stages; ++q) {
          const int j = q % kPipeStages;
          const unsigned round = (q / kPipeStages) & 1;
          stage_bar_wait(&ready[j], round);
          stage_bar_wait(&f_empty[j], round ^ 1);
          r.s = slab(1, j) + lane;
          r.flags = slab(2, j) + lane;
          run_stage(r, pipe_stage(p, q).n);
          stage_bar_arrive(&s_empty[j]);
          stage_bar_arrive(&filtered[j]);
        }
        if (live) r.rsc.store(st, C);
        return;
      }
    }
    PipeThresholdHit<Of::kGated, Of::kFloor, !kRsWarp, kCarry> h{};
    h.live = live;
    h.p = &p;
    if (live) {
      h.hit.load(st, C);
      h.prev_over = kRsWarp ? (rs0 > p.threshold ? 1 : 0)
                            : st[kPrevWasOver * C];
    }
    for (int q = 0; q < n_stages; ++q) {
      const PipeStage sg = pipe_stage(p, q);
      const int j = q % kPipeStages;
      const unsigned round = (q / kPipeStages) & 1;
      stage_bar_wait(&ready[j], round);
      if (kRsWarp) stage_bar_wait(&filtered[j], round);
      if (sg.first) {
        h.nclose = 0;
        h.base = slot_base(sg.chunk);
        if constexpr (kCarry) h.carry.begin(h.base, stage, p);
      }
      h.s = slab(1, j) + lane;
      if (kRsWarp) h.flags = slab(2, j) + lane;
      h.t0 = sg.t0;
      run_stage(h, sg.n);
      stage_bar_arrive(&s_empty[j]);
      if (kRsWarp) stage_bar_arrive(&f_empty[j]);
      if (sg.last && live) {
        if constexpr (kCarry) h.carry.flush(h.nclose, p);
        p.nclose[sg.chunk * C + c] = h.nclose;
      }
    }
    if (live) {
      h.hit.store(st, C);
      if (!kRsWarp) put(st, kPrevWasOver, C, h.prev_over);
    }
  }
}

template <int kEnc, int kMode, class Ch, bool kCarry = false>
cudaError_t launch_pipe(const Params& p, cudaStream_t stream) {
  static_assert(kEnc != kSlab14 ||
                    (kMode == kPipeK3 || kMode == kPipeThreshold),
                "K4b-slab runs the fused tick's modes only");
  constexpr int kThreads = kPipeWarps<kMode, Ch> * kPipeLanes;
  const int blocks = (p.n_channels + kPipeLanes - 1) / kPipeLanes;
  const long long smem_ll =
      pipe_shared_bytes(p, kPipeSlabs<kEnc, kMode, Ch>, Ch::kWords, kCarry);
  if (smem_ll + kPipeBars * kMbarrierBytes > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_ll);
#ifdef TPG_HOST_EMULATION
  // host build for the CPU tests: a block's warps run as host threads, the
  // ring's copies and barriers the stand-ins'; blocks in turn
  (void)stream;
  for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks);
       ++blockIdx.x)
    host_run_block(kThreads, [&] {
      pipe_kernel<kEnc, kMode, Ch, kCarry>(p);
    }, smem);
#else
  cudaError_t err = cudaFuncSetAttribute(
      pipe_kernel<kEnc, kMode, Ch, kCarry>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pipe_kernel<kEnc, kMode, Ch, kCarry><<<blocks, kThreads, smem, stream>>>(p);
#endif
  return cudaGetLastError();
}

// Runtime flag -> compile-time flag.
template <class F>
cudaError_t pick(bool flag, F&& f) {
  return flag ? f(std::true_type{}) : f(std::false_type{});
}

// A channel type passed as a value.
template <class T>
struct Tag {
  using type = T;
};

// f(Tag<ThresholdChannel<...>>) for the threshold family the variant names
// (its charge floor for SimpleThreshold, rs_float for the RS families, the
// RS families always floored).
template <bool kI16, class F>
cudaError_t pick_threshold(const Variant& v, F&& f) {
  return pick(v.peak_gated, [&](auto gated) -> cudaError_t {
    constexpr bool kGated = decltype(gated)::value;
    switch (v.family) {
      case kSimpleThreshold:
        return pick(v.charge_floor, [&](auto fl) {
          return f(Tag<ThresholdChannel<kSimpleThreshold, kGated,
                                        decltype(fl)::value, kI16, false>>{});
        });
      case kAbsRS:
        return pick(v.rs_float, [&](auto rf) {
          return f(Tag<ThresholdChannel<kAbsRS, kGated, true, kI16,
                                        decltype(rf)::value>>{});
        });
      case kStandardRS:
        return pick(v.rs_float, [&](auto rf) {
          return f(Tag<ThresholdChannel<kStandardRS, kGated, true, kI16,
                                        decltype(rf)::value>>{});
        });
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// The fused tick (K1-K4 and their variants) of every family on encoding
// kEnc, with the direct store or the carry layout (kCarry): only the
// combinations the JAX package admits are instantiated (the peak gate only
// with peak registers, the charge floor of the RS families always on,
// rs_float for the RS families, the SWAR carry for FIR on an int32 state).
// The pipeline runs every family on every encoding: K3 (FIR) on plain,
// time2, packed, words14 (gather, slab) and int16 rows, the threshold
// families on time2 rows (K1), plain samples (K2), packed words (K4),
// int16 samples (K2b) and words14 rows through the gather and the slab
// (K4b); K3b (fir_packed) is K3's mode with the packed front and back.
template <int kEnc, bool kCarry = false>
cudaError_t dispatch_fused(const Params& p, const Variant& v,
                           cudaStream_t s) {
  constexpr bool kI16 = kEnc == kPlain16;
  if (v.family != kFIR) {
    return pick_threshold<kI16>(v, [&](auto tag) -> cudaError_t {
      return launch_pipe<kEnc, kPipeThreshold,
                         typename decltype(tag)::type, kCarry>(p, s);
    });
  }
  return pick(v.peak_gated, [&](auto gated) -> cudaError_t {
    constexpr bool kGated = decltype(gated)::value;
    return pick(v.track_peaks, [&](auto tp) {
      constexpr bool kPeaks = decltype(tp)::value;
      return pick(v.avx, [&](auto av) -> cudaError_t {
        constexpr bool kAvx = decltype(av)::value;
        if constexpr (!kI16) {
          if (v.fir_packed)
            return launch_pipe<kEnc, kPipeK3,
                               FirPackedChannel<kPeaks && kGated, kPeaks,
                                                kAvx>,
                               kCarry>(p, s);
        }
        return launch_pipe<kEnc, kPipeK3,
                           FirChannel<kPeaks && kGated, kPeaks, kAvx, kI16>,
                           kCarry>(p, s);
      });
    });
  });
}

// The pipeline's K5 (kMode kPipeK5 or kPipeK5Lift) or its FIR staged arm on
// encoding kEnc: the FIR family, the peak gate only with peaks.
template <int kEnc, int kMode>
cudaError_t dispatch_pipe(const Params& p, const Variant& v,
                          cudaStream_t s) {
  return pick(v.track_peaks, [&](auto tp) {
    constexpr bool kPeaks = decltype(tp)::value;
    return pick(kPeaks && v.peak_gated, [&](auto gated) {
      constexpr bool kGated = kPeaks && decltype(gated)::value;
      return pick(v.avx, [&](auto av) {
        return launch_pipe<kEnc, kMode,
                           FirChannel<kGated, kPeaks, decltype(av)::value,
                                      false>>(p, s);
      });
    });
  });
}

// The pipeline's staged arm for the threshold families on encoding kEnc
// (kPlain16: on the int16 state).
template <int kEnc>
cudaError_t dispatch_threshold_staged(const Params& p, const Variant& v,
                                      cudaStream_t s) {
  return pick_threshold<kEnc == kPlain16>(v, [&](auto tag) {
    return launch_pipe<kEnc, kPipeStaged, typename decltype(tag)::type>(p,
                                                                        s);
  });
}

// K5 on encoding kEnc; lift selects fir_twopass=2.
template <int kEnc>
cudaError_t dispatch_fir2(const Params& p, const Variant& v, bool lift,
                          cudaStream_t s) {
  return lift ? dispatch_pipe<kEnc, kPipeK5Lift>(p, v, s)
              : dispatch_pipe<kEnc, kPipeK5>(p, v, s);
}

}  // namespace
