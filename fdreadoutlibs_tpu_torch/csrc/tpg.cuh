// The SWTPG tick for Hopper: the kernels of ROADMAP.md, shared by the
// translation units csrc/tpg*.cu (one per input encoding, one for the
// int16 state, two for K5, six tpg_carry_*.cu for the SLOT_WORD_CARRY
// layout; tpg.cu holds the C entries).
//
// Replaces fdreadoutlibs_tpu/ops/pallas_tpg.py::_tpg_kernel:
//   K1  the time2 datapath (time_packed=True, tick 2j in the low and 2j+1 in
//       the high 16 bits of a word) for SimpleThreshold, AbsRS, StandardRS;
//   K2  the plain-sample datapath (time_packed=False, one int32 sample per
//       row; _decode_ticks :399-400), for the same families;
//   K3  the FIR+IQR family (:464-490, :556-560), on any datapath;
//   K4  the in-kernel 14-bit unpack (_unpack14_rows :241-265, reached via
//       _decode_ticks :396-398): packed WIBEth words, 16 channels in 7
//       words, read as they arrive, for every family;
//   K2b the native int16 state (i16_mode :475-476, fixedpoint.I16Fx): every
//       family on int16 state and feed, plain datapath only;
//   K3b the FIR family with the SWAR carry (fir_packed, :466-501, :522-525,
//       :547-548, :561-574; fir.py:278-332);
//   K4b the words14 unpack as a gather (_unpack14_rows_gather :268-305,
//       words14_gather; also in K5) and as a whole-chunk slab before the
//       time2 tick loop (_unpack14_slab :308-329 and :445-463,
//       words14_slab);
// and pallas_tpg.py::_fir2_kernel:
//   K5  the two-pass FIR schedule (fir_twopass 1 and 2, :585-765), on any
//       datapath (its note is at fir2_kernel below).
// The input encoding is the template parameter kEnc; the family, the state
// type and the carry layout are the channel type.
// The arithmetic is ops/step.py::dispatch_tick (tpg_tick, and
// fir.py::tpg_tick_fir for FIR; the port's copies of the JAX package's
// modules), the single source of tick semantics: the plain versions beside
// this kernel (fdreadoutlibs_tpu_torch/ops/tpg.py::process_window_plain and
// process_window_twopass_plain) run those very functions on torch tensors,
// and the two are compared bit for bit.
//
// Design.  One thread owns one channel; consecutive threads take
// consecutive channels, so every feed load and slot store of a warp is
// coalesced.  The grid is ceil(C/128) blocks of 128 threads.  Inside a
// thread a serial loop runs over chunks and, within a chunk, over groups of
// kGroup = 16 ticks with the whole live ChanState in registers: the group's
// feed values (8 time2 words, 16 samples, or 16 pairs of packed words) are
// loaded before its ticks so their latency overlaps the chain.  The ticks
// of a group are expanded at compile time (std::integer_sequence), so the
// FIR ring of the previous 8 samples is 8 registers addressed by constant
// indices: tick u of a group
// reads ring[(u + j) % 8] oldest-first and overwrites ring[u % 8] with its
// sample — nothing moves per tick, as the Pallas kernel's tuple rotation.
// kGroup is a multiple of 8, so the ring is back in canonical order after
// every full group; a chunk's ragged tail group (tc % 16 ticks) is guarded
// per tick and followed by one explicit rotation.  A close writes its
// record (2 or 3 words: [charge<<16|tover, (peak<<16|ptime,) end+1]) with
// direct stores to slots[chunk][nclose][w][c] while nclose < K; nclose
// counts every close (drops included), is stored at each chunk end and
// restarts at 0.  The slot buffer must arrive zeroed (an empty slot is a
// zero end word).  State is read once and written back once, in place;
// rows outside the family's live set pass through.
//
// What bounds it on this card: the per-tick dependency chain (RS: two
// frugal updates, the division and the hit chain; FIR: the IQR and pedestal
// frugal updates, the 8-tap filter, the threshold product and the hit
// chain) at 2 B (time2, int16), 4 B (plain) or 1.75 B (packed) read per
// sample.  A few thousand channels fill only a few dozen of the 132 SMs, so
// the time of one launch is the chain's latency times the ticks; later work
// acts on that (more channels per launch, fewer threads per block, two
// ticks of ILP).
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
// words per tick.  Lanes 0-13 load them, one word each, and every lane
// takes its low and high word from them with __shfl_sync — the gather of
// _unpack14_rows_gather as a warp shuffle; the funnel shift is K4's.  A
// word is loaded once per warp instead of by about 2.3 lanes.
//
// K4b-slab (kSlab14, tpg_slab_kernel): per chunk the block first unpacks
// its 128 channels' words14 rows into a time2 slab in shared memory, tc/2
// rows x 128 words (64 KB at tc = 256, dynamic shared memory above 48 KB),
// with every load and extract of the chunk free of the chain; after a
// barrier each thread runs the time2 tick loop on its column.  tc % 16 == 0.
//
// K2b (kI16 channel types, encoding kPlain16): the I16Fx arithmetic.  CUDA
// promotes short to int, so every op that I16Fx does in int16 and that can
// leave the int16 range goes back through int16_t (w16); add_clamp, div10
// and rs_div10 widen in I16Fx too and need no wrap.  State and feed are
// int16_t, slots and nclose int32.
//
// K3b (FirPackedChannel): the IQR quantiles and accumulators ride as two
// words of biased 16-bit halves and charge/tover/prev_was_over as one, so
// the loop carries 3 registers where K3 carries 7; the frugal updates run in
// the biased domain (acc_bias = 1 << 15).  State in and out stays canonical.
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

constexpr int kBlock = 128;
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

// K4b-slab's time2 slab of one chunk: tc/2 rows of kBlock words, within the
// 227 KB of shared memory a block may use.
constexpr int kMaxSlabBytes = 232448;

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
                                 int encoding, bool lift, int32_t* scratch,
                                 cudaStream_t s);
cudaError_t launch_fir2_packed(const Params& p, const Variant& v,
                               int encoding, bool lift, int32_t* scratch,
                               cudaStream_t s);

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

// step.py::frugal_update: delta = clip(s - m, -1, 1); a bump of the median
// resets the accumulator.
template <bool kI16>
__device__ __forceinline__ void frugal(int& m, int& acc, int s, int limit) {
  acc = w16<kI16>(acc + clip1(w16<kI16>(s - m)));
  if (acc > limit) {
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

// The int32 words of a block's staging for the slots above kCarrySlots.
__host__ __device__ constexpr long long carry_stage_words(int limit,
                                                          int n_words) {
  return static_cast<long long>(limit > kCarrySlots ? limit - kCarrySlots
                                                    : 0) *
         n_words * kBlock;
}

// Dynamic shared memory of one block in bytes: K4b-slab's time2 slab of one
// chunk, then the carry layout's staging.  A launch that needs more than
// kMaxSlabBytes is refused (ops/tpg.py::carry_shared_bytes restates this
// for its own refusal; tpg_shared_bytes in tpg.cu gives the tests both).
inline long long block_shared_bytes(const Params& p, int n_words, bool slab,
                                    bool carry) {
  return 4LL * ((slab ? p.ticks_per_chunk / 2 * kBlock : 0) +
                (carry ? carry_stage_words(carry_limit(p), n_words) : 0));
}

// SLOT_WORD_CARRY: the chunk's records as kCarrySlots x kWords registers,
// each close a chain of predicated selects on nclose (_emit_records
// :426-430), and above that ceiling the thread's column of the block's
// staging in shared memory (word j of slot kCarrySlots + i at
// stage[(i * kWords + j) * kBlock]); all stored once at the chunk's end.
template <int kWords>
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
                                  kWords * kBlock;
#pragma unroll
        for (int j = 0; j < kWords; ++j) at[j * kBlock] = rec[j];
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
                                      kWords * kBlock;
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        base[(static_cast<size_t>(k) * kWords + j) * C] = at[j * kBlock];
    }
  }
};

template <int kWords>
__device__ __forceinline__ void slot_emit(CarrySlots<kWords>* slots,
                                          int& nclose, const Params&, int w0,
                                          int w1, int end_word) {
  slots->emit(nclose, w0, w1, end_word);
}

// step.py::tpg_tick: SimpleThreshold, AbsRS, StandardRS.
template <int kFamily, bool kPeakGated, bool kChargeFloor, bool kI16,
          bool kRsFloat>
struct ThresholdChannel {
  using State = StateT<kI16>;
  static constexpr int kWords = 3;
  int ped, acc, charge, tover, peak_adc, peak_time;
  int prev_over, rs, ped_rs, acc_rs, mf;
  int nclose;

  __device__ __forceinline__ void load(const State* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
    charge = st[kHitCharge * C];
    tover = st[kHitTover * C];
    peak_adc = st[kHitPeakAdc * C];
    peak_time = st[kHitPeakTime * C];
    prev_over = rs = ped_rs = acc_rs = mf = 0;
    if (kFamily == kSimpleThreshold) {
      prev_over = st[kPrevWasOver * C];
    } else {
      rs = st[kRs * C];
      ped_rs = st[kPedestalsRs * C];
      acc_rs = st[kAccumRs * C];
      mf = st[kMemoryFactor * C];
    }
  }

  __device__ __forceinline__ void store(State* st, size_t C) const {
    put(st, kPedestals, C, ped);
    put(st, kAccum, C, acc);
    put(st, kHitCharge, C, charge);
    put(st, kHitTover, C, tover);
    put(st, kHitPeakAdc, C, peak_adc);
    put(st, kHitPeakTime, C, peak_time);
    if (kFamily == kSimpleThreshold) {
      put(st, kPrevWasOver, C, prev_over);
    } else {
      put(st, kRs, C, rs);
      put(st, kPedestalsRs, C, ped_rs);
      put(st, kAccumRs, C, acc_rs);
    }
  }

  __device__ __forceinline__ void realign(int) {}

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

  // One sample; `end_word` is the window tick + 1.
  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s_raw, int end_word, Slots slots,
                                       const Params& p) {
    frugal<kI16>(ped, acc, s_raw, p.accumulator_limit);
    const int s = w16<kI16>(s_raw - ped);
    int x;
    if (kFamily == kSimpleThreshold) {
      x = s;
    } else {
      const int r = running_sum(s, p);
      frugal<kI16>(ped_rs, acc_rs, r, p.accumulator_limit);
      // float-mode rs can leave int16: its subtraction wraps (sub16)
      x = kRsFloat ? wrap_i16(r - ped_rs) : w16<kI16>(r - ped_rs);
    }
    const bool over = x > p.threshold;
    // RS derives the previous over flag from the carried (previous) rs
    bool closed;
    if (kFamily == kSimpleThreshold) {
      closed = prev_over != 0 && !over;
      prev_over = over ? 1 : 0;
    } else {
      closed = rs > p.threshold && !over;
      rs = x;
    }
    int ch = charge + (over ? s : 0);
    ch = ch < kInt16Max ? ch : kInt16Max;
    if (kChargeFloor) ch = ch > kInt16Min ? ch : kInt16Min;
    bool peak_upd = s > peak_adc;
    if (kPeakGated) peak_upd = peak_upd && over;
    const int pk = peak_upd ? s : peak_adc;
    const int pt = peak_upd ? tover : peak_time;
    int tv = tover + (over ? 1 : 0);
    tv = tv < kInt16Max ? tv : kInt16Max;
    if (closed) {
      slot_emit<kWords>(slots, nclose, p, pack16(ch, tv), pack16(pk, pt),
                        end_word);
      charge = tover = peak_adc = peak_time = 0;
    } else {
      charge = ch;
      tover = tv;
      peak_adc = pk;
      peak_time = pt;
    }
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
    if (aa > limit) {
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

// fir.py::tpg_tick_fir (unpacked layout): the FIR+IQR family, one fused
// tick (K3; K2b with kI16).
template <bool kPeakGated, bool kTrackPeaks, bool kAvx, bool kI16>
struct FirChannel {
  using State = StateT<kI16>;
  static constexpr int kWords = kTrackPeaks ? 3 : 2;
  FirFront<kI16> front;
  FirHit<kPeakGated, kTrackPeaks> hit;
  int prev_over;
  int ring[kTaps];   // previous samples; oldest at ring[u % 8] for tick u
  int nclose;

  __device__ __forceinline__ void load(const State* st, size_t C) {
    front.load(st, C);
    hit.load(st, C);
    prev_over = st[kPrevWasOver * C];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) ring[j] = st[(kFirRow0 + j) * C];
  }

  __device__ __forceinline__ void store(State* st, size_t C) const {
    front.store(st, C);
    hit.store(st, C);
    put(st, kPrevWasOver, C, prev_over);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) put(st, kFirRow0 + j, C, ring[j]);
  }

  __device__ __forceinline__ void realign(int n) { realign_ring(ring, n); }

  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s_raw, int end_word, Slots slots,
                                       const Params& p) {
    int sigma;
    const int s = front.step(s_raw, p, sigma);
    // the filter over the previous 8 samples, then the current sample
    // takes the oldest slot
    const int filt = fir_filter<kU>(ring, p);
    ring[kU % kTaps] = s;
    const bool over = fir_over<kAvx>(filt, sigma, p);
    const bool closed = prev_over != 0 && !over;
    prev_over = over ? 1 : 0;
    int w0, w1;
    hit.step(over, fir_to_add(over, filt, p), filt, closed, w0, w1);
    if (closed) slot_emit<kWords>(slots, nclose, p, w0, w1, end_word);
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

// fir.py::tpg_tick_fir with the packed SWAR carry (K3b, fir_packed): the
// loop carries qpair = (q25 + B) | (q75 + B) << 16, apair the same for the
// accumulators and ct = charge << 16 | prev_was_over << 15 | tover, packed
// from the canonical rows at load and unpacked at store
// (pallas_tpg.py:491-501, :561-574).  The hit chain is K3's, on the
// charge and tover taken out of ct each tick.
template <bool kPeakGated, bool kTrackPeaks, bool kAvx>
struct FirPackedChannel {
  using State = int32_t;
  static constexpr int kWords = kTrackPeaks ? 3 : 2;
  int ped, acc;
  int qpair, apair, ct;
  FirHit<kPeakGated, kTrackPeaks> hit;   // peaks carried; charge/tover not
  int ring[kTaps];
  int nclose;

  __device__ __forceinline__ void load(const State* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
    qpair = pack_halves((st[kQuantile25 * C] + kBias) & 0xFFFF,
                        st[kQuantile75 * C] + kBias);
    apair = pack_halves((st[kAccum25 * C] + kBias) & 0xFFFF,
                        st[kAccum75 * C] + kBias);
    ct = pack16(st[kHitCharge * C], st[kHitTover * C] & 0x7FFF) |
         (st[kPrevWasOver * C] != 0 ? 0x8000 : 0);
    hit.load(st, C);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) ring[j] = st[(kFirRow0 + j) * C];
  }

  __device__ __forceinline__ void store(State* st, size_t C) const {
    put(st, kPedestals, C, ped);
    put(st, kAccum, C, acc);
    put(st, kQuantile25, C, (qpair & 0xFFFF) - kBias);
    put(st, kQuantile75, C, ((qpair >> 16) & 0xFFFF) - kBias);
    put(st, kAccum25, C, (apair & 0xFFFF) - kBias);
    put(st, kAccum75, C, ((apair >> 16) & 0xFFFF) - kBias);
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
  __device__ __forceinline__ void tick(int s_raw, int end_word, Slots slots,
                                       const Params& p) {
    const int limit = p.accumulator_limit;
    // the two quantile chains in the biased domain, gated on the
    // pre-update median
    const int sb = s_raw + kBias;
    int q25 = qpair & 0xFFFF, a25 = apair & 0xFFFF;
    int q75 = (qpair >> 16) & 0xFFFF, a75 = (apair >> 16) & 0xFFFF;
    frugal_biased(q25, a25, sb, s_raw < ped, limit);
    frugal_biased(q75, a75, sb, s_raw > ped, limit);
    qpair = pack_halves(q25, q75);
    apair = pack_halves(a25, a75);
    const int sigma = q75 - q25;
    frugal<false>(ped, acc, s_raw, limit);
    int s = s_raw - ped;
    s = s < p.adc_max ? s : p.adc_max;
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
    if (closed) slot_emit<kWords>(slots, nclose, p, w0, w1, end_word);
  }
};

// Feed values one group holds per thread: time2 words (two ticks each; the
// slab holds time2 words too), plain samples, or the samples extracted from
// packed 14-bit words.
template <int kEnc>
constexpr bool kPairs = kEnc == kTime2 || kEnc == kSlab14;

template <int kEnc>
constexpr int kRowsPerGroup = kPairs<kEnc> ? kGroup / 2 : kGroup;

template <int kEnc>
constexpr int kRowTicks = kPairs<kEnc> ? 2 : 1;

template <int kEnc>
using FeedT = std::conditional_t<kEnc == kPlain16, int16_t, int32_t>;

// A thread's read position in the feed.  `fp` points at the current
// group's first tick; tick (or time2 row) u of the group sits at
// fp + u * stride.  Packed 14-bit words: the thread's channel c = 16g + r
// reads words j = 14r/32 and j + 1 of its 7-word group g (`lo`, `hi`
// offsets from fp) and extracts bits [14r % 32, +14) of the pair.  The
// gather (kGather14): `lo` is the word this lane loads for its warp (when
// `loads`), and the lane's own words come from lanes src_lo and src_hi of
// the warp's live lanes `mask`.
template <int kEnc>
struct Cursor {
  const FeedT<kEnc>* fp;
  size_t stride;
  size_t col;      // the channel's column, or its packed word group's base
  size_t lo, hi;
  unsigned sh;
  unsigned mask;
  int src_lo, src_hi;
  bool loads;
};

// The offset of 7-word group g's first word in a packed feed.
__device__ __forceinline__ size_t group_base(const Params& p, int g) {
  return static_cast<size_t>(g / p.groups_per_row) * p.group_outer +
         static_cast<size_t>(g % p.groups_per_row) * p.group_inner;
}

// The read position of channel c.  Packed 14-bit words: channel c = 16g + r
// sits in 7-word group g at (g / gpr) * outer + (g % gpr) * inner.
template <int kEnc>
__device__ __forceinline__ Cursor<kEnc> make_cursor(const Params& p, int c) {
  Cursor<kEnc> cur{};
  cur.stride = static_cast<size_t>(p.feed_stride);
  cur.col = static_cast<size_t>(c);
  if constexpr (kEnc == kPacked14 || kEnc == kGather14) {
    const int g = c / 16, r = c % 16;
    const int j = 14 * r / 32;
    // class 15 ends on its group's last bit: word j + 1 = 7 lies past the
    // group, and none of its bits are kept, so read word 6 twice
    const int jh = j < 6 ? j + 1 : 6;
    cur.sh = static_cast<unsigned>(14 * r % 32);
    if constexpr (kEnc == kPacked14) {
      cur.col = group_base(p, g);
      cur.lo = static_cast<size_t>(j) * p.word_stride;
      cur.hi = static_cast<size_t>(jh) * p.word_stride;
    } else {
      // a warp is 32 aligned channels, groups g0 and g0 + 1; lane k < 14
      // loads word k % 7 of group g0 + k / 7, where that group is live
      const int lane = c & 31;
      const int live = p.n_channels - (c - lane);
      cur.mask = live >= 32 ? 0xFFFFFFFFu : (1u << live) - 1u;
      const int g0 = (c - lane) / 16;
      cur.col = 0;
      cur.loads = lane < 14 && (g0 + lane / 7) * 16 < p.n_channels;
      cur.lo = cur.loads ? group_base(p, g0 + lane / 7) +
                               static_cast<size_t>(lane % 7) * p.word_stride
                         : 0;
      cur.src_lo = (g - g0) * 7 + j;
      cur.src_hi = (g - g0) * 7 + jh;
    }
  }
  return cur;
}

// Point the cursor at window tick t0 (a chunk's first sample).
template <int kEnc>
__device__ __forceinline__ void seek(Cursor<kEnc>& cur, const Params& p,
                                     int t0) {
  cur.fp = static_cast<const FeedT<kEnc>*>(p.feed) +
           static_cast<size_t>(t0 / kRowTicks<kEnc>) * cur.stride + cur.col;
}

// Tick kU of a group from its loaded feed values.
template <int kEnc, int kU>
__device__ __forceinline__ int sample(const int (&w)[kRowsPerGroup<kEnc>]) {
  if constexpr (kPairs<kEnc>) {
    return kU % 2 == 0 ? wrap_i16(w[kU / 2]) : (w[kU / 2] >> 16);
  } else {
    return w[kU];
  }
}

// Load one group's feed values (kGuard: only the first n ticks, a chunk's
// ragged tail) and step the cursor to the next group.  Every load of the
// group goes out before its ticks, so their latency overlaps the chain.
// The slab lives in shared memory: plain loads, no __ldg.
template <int kEnc, bool kGuard>
__device__ __forceinline__ void load_group(int (&w)[kRowsPerGroup<kEnc>],
                                           Cursor<kEnc>& cur, int n) {
  if constexpr (kEnc == kPacked14) {
    unsigned lo[kGroup], hi[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int32_t* row = cur.fp + static_cast<size_t>(u) * cur.stride;
      const bool live = !kGuard || u < n;
      lo[u] = live ? static_cast<unsigned>(__ldg(row + cur.lo)) : 0u;
      hi[u] = live ? static_cast<unsigned>(__ldg(row + cur.hi)) : 0u;
    }
    // the funnel shift takes the shift mod 32, so sh = 0 needs no case
    // (lo >> sh | hi << (32 - sh) would shift by 32 there)
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      w[u] = static_cast<int>(__funnelshift_r(lo[u], hi[u], cur.sh) & 0x3FFFu);
  } else if constexpr (kEnc == kGather14) {
    unsigned word[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      word[u] = cur.loads && (!kGuard || u < n)
                    ? static_cast<unsigned>(__ldg(
                          cur.fp + static_cast<size_t>(u) * cur.stride +
                          cur.lo))
                    : 0u;
    // every live lane of the warp takes part in each shuffle (n is the
    // same for the whole warp)
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      w[u] = 0;
      if (!kGuard || u < n) {
        const unsigned lo = __shfl_sync(cur.mask, word[u], cur.src_lo);
        const unsigned hi = __shfl_sync(cur.mask, word[u], cur.src_hi);
        w[u] = static_cast<int>(__funnelshift_r(lo, hi, cur.sh) & 0x3FFFu);
      }
    }
  } else if constexpr (kEnc == kSlab14) {
#pragma unroll
    for (int r = 0; r < kRowsPerGroup<kEnc>; ++r)
      w[r] = (!kGuard || r * 2 < n) ? cur.fp[static_cast<size_t>(r) *
                                             cur.stride]
                                    : 0;
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerGroup<kEnc>; ++r)
      w[r] = (!kGuard || r * kRowTicks<kEnc> < n)
                 ? static_cast<int>(
                       __ldg(cur.fp + static_cast<size_t>(r) * cur.stride))
                 : 0;
  }
  cur.fp += static_cast<size_t>(kRowsPerGroup<kEnc>) * cur.stride;
}

// The ticks of one group, expanded at compile time; kGuard runs only the
// first n (a chunk's ragged tail).
template <int kEnc, bool kGuard, class Ch, class Slots, int... kU>
__device__ __forceinline__ void run_ticks(
    Ch& ch, const int (&w)[kRowsPerGroup<kEnc>], int n, int tick0,
    Slots slots, const Params& p, std::integer_sequence<int, kU...>) {
  ((!kGuard || kU < n
        ? ch.template tick<kU>(sample<kEnc, kU>(w), tick0 + kU + 1, slots, p)
        : void()),
   ...);
}

template <int kEnc, bool kGuard, class Ch, class Slots>
__device__ __forceinline__ void run_group(Ch& ch, Cursor<kEnc>& cur, int n,
                                          int tick0, Slots slots,
                                          const Params& p) {
  int w[kRowsPerGroup<kEnc>];
  load_group<kEnc, kGuard>(w, cur, n);
  run_ticks<kEnc, kGuard>(ch, w, n, tick0, slots, p,
                          std::make_integer_sequence<int, kGroup>{});
}

// The groups of one chunk from its cursor (at the chunk's first tick), the
// ragged tail guarded.
template <int kEnc, class Ch, class Slots>
__device__ __forceinline__ void run_groups(Ch& ch, Cursor<kEnc>& cur,
                                           const Params& p, int t0,
                                           Slots slots) {
  const int tc = p.ticks_per_chunk;
  int g = 0;
  for (; g + kGroup <= tc; g += kGroup)
    run_group<kEnc, false>(ch, cur, kGroup, t0 + g, slots, p);
  if (g < tc) {
    run_group<kEnc, true>(ch, cur, tc - g, t0 + g, slots, p);
    ch.realign(tc - g);
  }
}

// One chunk of a channel's chain; `stage` is the thread's column of the
// carry layout's staging (unused by the direct store).
template <int kEnc, bool kCarry, class Ch>
__device__ __forceinline__ void run_chunk(Ch& ch, Cursor<kEnc>& cur,
                                          const Params& p, int chunk, int c,
                                          int32_t* stage) {
  const size_t C = static_cast<size_t>(p.n_channels);
  const int t0 = chunk * p.ticks_per_chunk;   // the chunk's first window tick
  ch.nclose = 0;
  int32_t* slot_base =
      p.slots + static_cast<size_t>(chunk) * p.k_slots * Ch::kWords * C + c;
  if constexpr (kCarry) {
    CarrySlots<Ch::kWords> carry;
    carry.begin(slot_base, stage, p);
    run_groups<kEnc>(ch, cur, p, t0, &carry);
    carry.flush(ch.nclose, p);
  } else {
    run_groups<kEnc>(ch, cur, p, t0, slot_base);
  }
  p.nclose[static_cast<size_t>(chunk) * C + c] = ch.nclose;
}

// The thread's column of the block's dynamic shared memory from word
// `offset` on (the carry layout's staging), or nothing for the direct store.
template <bool kCarry>
__device__ __forceinline__ int32_t* carry_stage(int offset) {
  if constexpr (kCarry) {
    TPG_DYNAMIC_SHARED(int32_t, shared_words);
    return shared_words + offset + threadIdx.x;
  } else {
    return nullptr;
  }
}

template <class Ch, int kEnc, bool kCarry = false>
__global__ void __launch_bounds__(kBlock) tpg_kernel(Params p) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= p.n_channels) return;
  const size_t C = static_cast<size_t>(p.n_channels);
  typename Ch::State* st = static_cast<typename Ch::State*>(p.state) + c;
  Ch ch;
  ch.load(st, C);
  Cursor<kEnc> cur = make_cursor<kEnc>(p, c);
  int32_t* const stage = carry_stage<kCarry>(0);
  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    seek<kEnc>(cur, p, chunk * p.ticks_per_chunk);
    run_chunk<kEnc, kCarry>(ch, cur, p, chunk, c, stage);
  }
  ch.store(st, C);
}

// K4b-slab.  Per chunk: every thread unpacks its channel's 14-bit samples
// (K4's loads and funnel shifts, 16 ticks at a time, none of them on the
// chain) into the block's time2 slab in shared memory, tick pair j of
// thread x at slab[j * 128 + x]; after a barrier the thread runs the time2
// tick loop on its column.  Threads past the last channel stay for the
// barriers.
template <class Ch, bool kCarry = false>
__global__ void __launch_bounds__(kBlock) tpg_slab_kernel(Params p) {
  // (tc / 2) x kBlock time2 words, then the carry layout's staging
  TPG_DYNAMIC_SHARED(int32_t, slab);
  const int c = blockIdx.x * kBlock + threadIdx.x;
  const bool live = c < p.n_channels;
  const size_t C = static_cast<size_t>(p.n_channels);
  const int tc = p.ticks_per_chunk;
  typename Ch::State* st = static_cast<typename Ch::State*>(p.state) + c;
  Ch ch;
  if (live) ch.load(st, C);
  Cursor<kPacked14> src = make_cursor<kPacked14>(p, live ? c : 0);
  int32_t* const stage =
      kCarry ? slab + static_cast<size_t>(tc / 2) * kBlock + threadIdx.x
             : nullptr;
  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    __syncthreads();   // the slab's previous chunk has been read
    if (live) {
      seek<kPacked14>(src, p, chunk * tc);
      for (int g = 0; g < tc; g += kGroup) {
        int v[kGroup];
        load_group<kPacked14, false>(v, src, kGroup);
#pragma unroll
        for (int u = 0; u < kGroup / 2; ++u)
          slab[static_cast<size_t>(g / 2 + u) * kBlock + threadIdx.x] =
              pack16(v[2 * u + 1], v[2 * u] & 0xFFFF);
      }
    }
    __syncthreads();
    if (live) {
      Cursor<kSlab14> cur{};
      cur.fp = slab + threadIdx.x;
      cur.stride = kBlock;
      run_chunk<kSlab14, kCarry>(ch, cur, p, chunk, c, stage);
    }
  }
  if (live) ch.store(st, C);
}

template <class Ch, int kEnc, bool kCarry = false>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.n_channels + kBlock - 1) / kBlock;
  // dynamic shared memory: the slab, then the carry layout's staging
  const long long smem_ll =
      block_shared_bytes(p, Ch::kWords, kEnc == kSlab14, kCarry);
  if (smem_ll > kMaxSlabBytes) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_ll);
  if constexpr (kEnc == kSlab14) {
#ifdef TPG_HOST_EMULATION
    // host build for the CPU tests (tests/cuda_host/cuda_runtime.h): a
    // block's threads run as host threads that meet at a real barrier
    (void)stream;
    for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks);
         ++blockIdx.x)
      host_run_block(kBlock, [&] { tpg_slab_kernel<Ch, kCarry>(p); }, smem);
#else
    cudaError_t err = cudaFuncSetAttribute(
        tpg_slab_kernel<Ch, kCarry>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    tpg_slab_kernel<Ch, kCarry><<<blocks, kBlock, smem, stream>>>(p);
#endif
  } else {
#ifdef TPG_HOST_EMULATION
    // host build: the grid runs serially, one thread after another (the
    // carry layout's staging shared by a block's threads in turn); the
    // gather's warp shuffles need a block's threads at once
    (void)stream;
    for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks);
         ++blockIdx.x) {
      if (kEnc == kGather14) {
        host_run_block(kBlock, [&] { tpg_kernel<Ch, kEnc, kCarry>(p); },
                       smem);
      } else {
        std::vector<unsigned char> shared(smem);
        host_block_shared = &shared;
        for (threadIdx.x = 0; threadIdx.x < kBlock; ++threadIdx.x)
          tpg_kernel<Ch, kEnc, kCarry>(p);
        host_block_shared = nullptr;
      }
    }
#else
    if (kCarry && smem > 0) {
      cudaError_t err = cudaFuncSetAttribute(
          tpg_kernel<Ch, kEnc, kCarry>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    tpg_kernel<Ch, kEnc, kCarry><<<blocks, kBlock, smem, stream>>>(p);
#endif
  }
  return cudaGetLastError();
}

// ---- K5: the two-pass FIR schedule ----------------------------------------
//
// Replaces fdreadoutlibs_tpu/ops/pallas_tpg.py::_fir2_kernel (:585-765,
// fir_twopass 1 and 2).  Same outputs as K3, bit for bit: the passes call
// the same pieces (FirFront, fir_over, fir_to_add, FirHit) in a split
// order.  Per tc-tick chunk, in one block of kFir2Threads threads that owns
// kFir2Channels consecutive channels:
//   pass A  one thread per channel (warp 0): the IQR and pedestal chains
//           over the chunk's ticks, decoding the feed as K1-K4 (and
//           K4b-gather) do; writes the clamped samples into the s slab
//           after its 8 ring rows (oldest first, the carried FIR history)
//           and sigma into its slab;
//   pass B  every thread of the block over (tick, channel): the 8-tap
//           filter on the s slab, the threshold, to_add (and filt for the
//           peak registers) into their slabs; with lift (fir_twopass=2)
//           then the closed slab, closed = over(t-1) && !over(t) with the
//           carried prev_was_over at t = 0;
//   pass C  one thread per channel: the hit chain over the chunk's ticks.
//           Without lift it tests the close itself and emits into the K
//           slots as K3 does; with lift it reads the closed slab and writes
//           each tick's record words into their slabs;
//   pass D  (lift) one thread per channel: a serial count of the closes
//           along the chunk, the k-th close's words into slot k < K.
// The slabs live in global scratch from the wrapper, (tc + 8) x C int32
// each; a block touches only its own channels' columns (coalesced rows of
// 32 channels), so a chunk's working set, ~2.7 MB per slab at 2560
// channels and tc = 256, stays in L2.  A later step can keep them in
// shared memory.
//
// What bounds it: the two serial chains (pass A, then pass C) per chunk,
// with one slab pass between them.  Against K3 each chain is shorter per
// tick (the filter, threshold and to_add leave the serial path) but there
// are two of them in turn, plus the slab traffic, and only a quarter of a
// block's threads run the chains.
constexpr int kFir2Channels = 32;   // channels per block: warp 0's lanes
constexpr int kFir2Threads = 128;   // threads per block in pass B

// Pass A as a channel type of run_group: tick u of the chunk writes its
// clamped sample to s-slab row 8 + u and its sigma to sigma-slab row u.
struct Fir2Front {
  FirFront<false> front;
  int32_t* s;       // the channel's column of the s slab
  int32_t* sigma;   // ... of the sigma slab
  size_t C;
  int t0;           // window tick of the chunk's first sample

  __device__ __forceinline__ void realign(int) {}

  template <int kU, class Slots>
  __device__ __forceinline__ void tick(int s_raw, int end_word, Slots,
                                       const Params& p) {
    const size_t u = static_cast<size_t>(end_word - 1 - t0);
    int sg;
    s[(kTaps + u) * C] = front.step(s_raw, p, sg);
    sigma[u * C] = sg;
  }
};

template <int kEnc, bool kPeakGated, bool kTrackPeaks, bool kAvx, bool kLift>
__global__ void __launch_bounds__(kFir2Threads)
    fir2_kernel(Params p, int32_t* scratch) {
  constexpr int kWords = kTrackPeaks ? 3 : 2;
  const size_t C = static_cast<size_t>(p.n_channels);
  const int tc = p.ticks_per_chunk;
  const size_t slab = (static_cast<size_t>(tc) + kTaps) * C;
  // slab order (ops/tpg.py::_fir2_slabs): s, sigma, over, to_add, then
  // filt (peaks), then closed, w0 and w1 (peaks) with lift
  int32_t* const s_slab = scratch;
  int32_t* const sig_slab = scratch + slab;
  int32_t* const over_slab = scratch + 2 * slab;
  int32_t* const add_slab = scratch + 3 * slab;
  int32_t* const filt_slab = scratch + 4 * slab;
  int32_t* const closed_slab = scratch + (4 + kTrackPeaks) * slab;
  int32_t* const w0_slab = closed_slab + slab;
  int32_t* const w1_slab = closed_slab + 2 * slab;
  __shared__ int prev_in[kFir2Channels];   // lift: prev_was_over at t = 0

  const int lane = threadIdx.x % kFir2Channels;
  const int c0 = blockIdx.x * kFir2Channels;
  const int c = c0 + lane;
  // warp 0 runs the chains; no thread returns early (every thread meets
  // every barrier)
  const bool chain = threadIdx.x < kFir2Channels && c < p.n_channels;
  int32_t* st = static_cast<int32_t*>(p.state) + c;
  Fir2Front a{};
  FirHit<kPeakGated, kTrackPeaks> hit{};
  int prev_over = 0;
  Cursor<kEnc> cur{};
  if (chain) {
    a.front.load(st, C);
    a.s = s_slab + c;
    a.sigma = sig_slab + c;
    a.C = C;
    hit.load(st, C);
    prev_over = st[kPrevWasOver * C];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      s_slab[j * C + c] = st[(kFirRow0 + j) * C];
    cur = make_cursor<kEnc>(p, c);
  }
  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int t0 = chunk * tc;
    // ---- pass A
    if (chain) {
      if (chunk > 0) {
        // the ring carries on as the last 8 samples of the previous chunk,
        // s rows tc..tc+7 (row tc + j is read before row j + tc is written)
        for (int j = 0; j < kTaps; ++j)
          s_slab[j * C + c] = s_slab[(tc + j) * C + c];
      }
      a.t0 = t0;
      seek<kEnc>(cur, p, t0);
      int g = 0;
      for (; g + kGroup <= tc; g += kGroup)
        run_group<kEnc, false>(a, cur, kGroup, t0 + g, nullptr, p);
      if (g < tc) run_group<kEnc, true>(a, cur, tc - g, t0 + g, nullptr, p);
      if (kLift) prev_in[lane] = prev_over;
    }
    __syncthreads();
    // ---- pass B
    for (int i = threadIdx.x; i < tc * kFir2Channels; i += kFir2Threads) {
      const size_t cc = static_cast<size_t>(c0 + i % kFir2Channels);
      if (cc >= C) continue;
      const size_t at = static_cast<size_t>(i / kFir2Channels) * C + cc;
      uint32_t f = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j)
        f += static_cast<uint32_t>(p.taps[j]) *
             static_cast<uint32_t>(s_slab[at + j * C]);
      const int filt = wrap_i16(static_cast<int>(f));
      const bool over = fir_over<kAvx>(filt, sig_slab[at], p);
      over_slab[at] = over ? 1 : 0;
      add_slab[at] = fir_to_add(over, filt, p);
      if (kTrackPeaks) filt_slab[at] = filt;
    }
    if (kLift) {
      __syncthreads();
      for (int i = threadIdx.x; i < tc * kFir2Channels; i += kFir2Threads) {
        const int t = i / kFir2Channels;
        const size_t cc = static_cast<size_t>(c0 + i % kFir2Channels);
        if (cc >= C) continue;
        const size_t at = static_cast<size_t>(t) * C + cc;
        const int prev = t == 0 ? prev_in[i % kFir2Channels]
                                : over_slab[at - C];
        closed_slab[at] = (prev != 0 && over_slab[at] == 0) ? 1 : 0;
      }
    }
    __syncthreads();
    // ---- pass C (and D with lift); the next chunk's pass B writes these
    // slabs only after the barrier that follows its pass A, which warp 0
    // reaches after this
    if (chain) {
      int32_t* slot_base =
          p.slots + static_cast<size_t>(chunk) * p.k_slots * kWords * C + c;
      int nclose = 0;
      for (int t = 0; t < tc; ++t) {
        const size_t at = static_cast<size_t>(t) * C + c;
        const bool over = over_slab[at] != 0;
        const int filt = kTrackPeaks ? filt_slab[at] : 0;
        int w0, w1;
        if (kLift) {
          hit.step(over, add_slab[at], filt, closed_slab[at] != 0, w0, w1);
          w0_slab[at] = w0;
          if (kTrackPeaks) w1_slab[at] = w1;
        } else {
          const bool closed = prev_over != 0 && !over;
          prev_over = over ? 1 : 0;
          hit.step(over, add_slab[at], filt, closed, w0, w1);
          if (closed) emit<kWords>(nclose, slot_base, p, w0, w1, t0 + t + 1);
        }
      }
      if (kLift) {
        prev_over = over_slab[static_cast<size_t>(tc - 1) * C + c];
        for (int t = 0; t < tc; ++t) {
          const size_t at = static_cast<size_t>(t) * C + c;
          if (closed_slab[at] != 0)
            emit<kWords>(nclose, slot_base, p, w0_slab[at],
                         kTrackPeaks ? w1_slab[at] : 0, t0 + t + 1);
        }
      }
      p.nclose[static_cast<size_t>(chunk) * C + c] = nclose;
    }
  }
  if (chain) {
    a.front.store(st, C);
    hit.store(st, C);
    st[kPrevWasOver * C] = prev_over;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      st[(kFirRow0 + j) * C] = s_slab[(p.ticks_per_chunk + j) * C + c];
  }
}

template <int kEnc, bool kPeakGated, bool kTrackPeaks, bool kAvx, bool kLift>
cudaError_t launch_fir2(const Params& p, int32_t* scratch,
                        cudaStream_t stream) {
  const int blocks = (p.n_channels + kFir2Channels - 1) / kFir2Channels;
#ifdef TPG_HOST_EMULATION
  // host build for the CPU tests: each block's threads run as host
  // threads and __syncthreads() is a barrier among them; blocks in turn
  (void)stream;
  for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks);
       ++blockIdx.x)
    host_run_block(kFir2Threads, [&] {
      fir2_kernel<kEnc, kPeakGated, kTrackPeaks, kAvx, kLift>(p, scratch);
    });
#else
  fir2_kernel<kEnc, kPeakGated, kTrackPeaks, kAvx, kLift>
      <<<blocks, kFir2Threads, 0, stream>>>(p, scratch);
#endif
  return cudaGetLastError();
}

// Runtime flag -> compile-time flag.
template <class F>
cudaError_t pick(bool flag, F&& f) {
  return flag ? f(std::true_type{}) : f(std::false_type{});
}

// The fused tick (K1-K4 and their variants) of every family on encoding
// kEnc, with the direct store or the carry layout (kCarry): only the combinations the JAX package admits are instantiated
// (the peak gate only with peak registers, the charge floor of the RS
// families always on, rs_float for the RS families, the SWAR carry for
// FIR on an int32 state).
template <int kEnc, bool kCarry = false>
cudaError_t dispatch_fused(const Params& p, const Variant& v,
                           cudaStream_t s) {
  constexpr bool kI16 = kEnc == kPlain16;
  return pick(v.peak_gated, [&](auto gated) -> cudaError_t {
    constexpr bool kGated = decltype(gated)::value;
    if (v.family == kFIR) {
      return pick(v.track_peaks, [&](auto tp) {
        constexpr bool kPeaks = decltype(tp)::value;
        return pick(v.avx, [&](auto av) -> cudaError_t {
          constexpr bool kAvx = decltype(av)::value;
          if constexpr (!kI16) {
            if (v.fir_packed)
              return launch<FirPackedChannel<kPeaks && kGated, kPeaks, kAvx>,
                            kEnc, kCarry>(p, s);
          }
          return launch<FirChannel<kPeaks && kGated, kPeaks, kAvx, kI16>,
                        kEnc, kCarry>(p, s);
        });
      });
    }
    switch (v.family) {
      case kSimpleThreshold:
        return pick(v.charge_floor, [&](auto fl) {
          return launch<ThresholdChannel<kSimpleThreshold, kGated,
                                         decltype(fl)::value, kI16, false>,
                        kEnc, kCarry>(p, s);
        });
      case kAbsRS:
        return pick(v.rs_float, [&](auto rf) {
          return launch<ThresholdChannel<kAbsRS, kGated, true, kI16,
                                         decltype(rf)::value>,
                        kEnc, kCarry>(p, s);
        });
      case kStandardRS:
        return pick(v.rs_float, [&](auto rf) {
          return launch<ThresholdChannel<kStandardRS, kGated, true, kI16,
                                         decltype(rf)::value>,
                        kEnc, kCarry>(p, s);
        });
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// K5 on encoding kEnc (the FIR family; the peak gate only with peaks).
template <int kEnc>
cudaError_t dispatch_fir2(const Params& p, const Variant& v, bool lift,
                          int32_t* scratch, cudaStream_t s) {
  return pick(v.track_peaks, [&](auto tp) {
    constexpr bool kPeaks = decltype(tp)::value;
    return pick(kPeaks && v.peak_gated, [&](auto gated) {
      constexpr bool kGated = kPeaks && decltype(gated)::value;
      return pick(v.avx, [&](auto av) {
        return pick(lift, [&](auto lf) {
          return launch_fir2<kEnc, kGated, kPeaks, decltype(av)::value,
                             decltype(lf)::value>(p, scratch, s);
        });
      });
    });
  });
}

}  // namespace
