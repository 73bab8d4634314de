// The SWTPG tick for Hopper: K1-K5 of ROADMAP.md in one source.
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
// and pallas_tpg.py::_fir2_kernel:
//   K5  the two-pass FIR schedule (fir_twopass 1 and 2, :585-765), on any
//       datapath (its note is at fir2_kernel below).
// The input encoding is the template parameter kEnc; the family is the
// channel type.
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
// chain) at 2 B (time2), 4 B (plain) or 1.75 B (packed) read per sample.
// A few thousand channels fill only a few dozen of the 132 SMs, so the
// time of one launch is the chain's latency times the ticks; later work
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
// Integer exactness: left shifts and the wrapping products (the FIR
// filter, the threshold product wrap_i16((sigma_c << e) * threshold), the
// naive threshold product) run on uint32_t and wrap through int16_t or
// int32_t, which is the JAX package's int32 arithmetic mod 2^32; nothing
// relies on undefined signed behaviour.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int kBlock = 128;
constexpr int kGroup = 16;   // ticks per unrolled group; a multiple of kTaps
constexpr int kTaps = 8;
constexpr int kInt16Max = 32767;
constexpr int kInt16Min = -32768;

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

enum Family : int {
  kSimpleThreshold = 0,
  kAbsRS = 1,
  kStandardRS = 2,
  kFIR = 3
};

__device__ __forceinline__ int wrap_i16(int x) {
  return static_cast<int>(static_cast<int16_t>(x));
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
__device__ __forceinline__ void frugal(int& m, int& acc, int s, int limit) {
  acc += clip1(s - m);
  if (acc > limit) {
    m += 1;
    acc = 0;
  } else if (acc < -limit) {
    m -= 1;
    acc = 0;
  }
}

struct Params {
  const int32_t* feed;   // time2 words, samples or packed 14-bit words
  int feed_stride;       // between rows (time2, plain) or ticks (packed)
  // packed 14-bit words: the layout of the 7-word channel groups
  int groups_per_row;
  int group_outer;
  int group_inner;
  int word_stride;
  int n_chunks;
  int ticks_per_chunk;   // tc
  int32_t* state;        // (KSTATE, C)
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

// step.py::tpg_tick: SimpleThreshold, AbsRS, StandardRS.
template <int kFamily, bool kPeakGated, bool kChargeFloor>
struct ThresholdChannel {
  static constexpr int kWords = 3;
  int ped, acc, charge, tover, peak_adc, peak_time;
  int prev_over, rs, ped_rs, acc_rs, mf;
  int nclose;

  __device__ __forceinline__ void load(const int32_t* st, size_t C) {
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

  __device__ __forceinline__ void store(int32_t* st, size_t C) const {
    st[kPedestals * C] = ped;
    st[kAccum * C] = acc;
    st[kHitCharge * C] = charge;
    st[kHitTover * C] = tover;
    st[kHitPeakAdc * C] = peak_adc;
    st[kHitPeakTime * C] = peak_time;
    if (kFamily == kSimpleThreshold) {
      st[kPrevWasOver * C] = prev_over;
    } else {
      st[kRs * C] = rs;
      st[kPedestalsRs * C] = ped_rs;
      st[kAccumRs * C] = acc_rs;
    }
  }

  __device__ __forceinline__ void realign(int) {}

  // One sample; `end_word` is the window tick + 1.
  template <int kU>
  __device__ __forceinline__ void tick(int s_raw, int end_word,
                                       int32_t* slot_base, const Params& p) {
    frugal(ped, acc, s_raw, p.accumulator_limit);
    const int s = s_raw - ped;
    int x;
    if (kFamily == kSimpleThreshold) {
      x = s;
    } else {
      const int second =
          kFamily == kAbsRS ? (s < 0 ? -s : s) * p.rs_scale_factor_x10 : s;
      // fixedpoint.rs_div10_unwrapped: mulhrs(wrap_i16(sum), 3276)
      const int r = (wrap_i16(rs * mf + second) * 3276 + 16384) >> 15;
      frugal(ped_rs, acc_rs, r, p.accumulator_limit);
      x = r - ped_rs;
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
      emit<kWords>(nclose, slot_base, p, pack16(ch, tv), pack16(pk, pt),
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
struct FirFront {
  int ped, acc, q25, q75, a25, a75;

  __device__ __forceinline__ void load(const int32_t* st, size_t C) {
    ped = st[kPedestals * C];
    acc = st[kAccum * C];
    q25 = st[kQuantile25 * C];
    q75 = st[kQuantile75 * C];
    a25 = st[kAccum25 * C];
    a75 = st[kAccum75 * C];
  }

  __device__ __forceinline__ void store(int32_t* st, size_t C) const {
    st[kPedestals * C] = ped;
    st[kAccum * C] = acc;
    st[kQuantile25 * C] = q25;
    st[kQuantile75 * C] = q75;
    st[kAccum25 * C] = a25;
    st[kAccum75 * C] = a75;
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
    aa += (lt || gt) ? clip1(s_raw - qa) : 0;
    if (aa > limit) {
      qa += 1;
      aa = 0;
    } else if (aa < -limit) {
      qa -= 1;
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
    sigma = q75 - q25;
    frugal(ped, acc, s_raw, limit);
    const int s = s_raw - ped;
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

// fir_hit_update after the close test: the saturating charge/tover chain
// and the optional peak registers.  Writes the record words
// w0 = charge<<16|tover, w1 = peak<<16|ptime, and zeroes the hit on a
// close.
template <bool kPeakGated, bool kTrackPeaks>
struct FirHit {
  int charge, tover, peak_adc, peak_time;

  __device__ __forceinline__ void load(const int32_t* st, size_t C) {
    charge = st[kHitCharge * C];
    tover = st[kHitTover * C];
    peak_adc = peak_time = 0;
    if (kTrackPeaks) {
      peak_adc = st[kHitPeakAdc * C];
      peak_time = st[kHitPeakTime * C];
    }
  }

  __device__ __forceinline__ void store(int32_t* st, size_t C) const {
    st[kHitCharge * C] = charge;
    st[kHitTover * C] = tover;
    if (kTrackPeaks) {
      st[kHitPeakAdc * C] = peak_adc;
      st[kHitPeakTime * C] = peak_time;
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

// fir.py::tpg_tick_fir (unpacked layout): the FIR+IQR family, one fused
// tick (K3).
template <bool kPeakGated, bool kTrackPeaks, bool kAvx>
struct FirChannel {
  static constexpr int kWords = kTrackPeaks ? 3 : 2;
  FirFront front;
  FirHit<kPeakGated, kTrackPeaks> hit;
  int prev_over;
  int ring[kTaps];   // previous samples; oldest at ring[u % 8] for tick u
  int nclose;

  __device__ __forceinline__ void load(const int32_t* st, size_t C) {
    front.load(st, C);
    hit.load(st, C);
    prev_over = st[kPrevWasOver * C];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) ring[j] = st[(kFirRow0 + j) * C];
  }

  __device__ __forceinline__ void store(int32_t* st, size_t C) const {
    front.store(st, C);
    hit.store(st, C);
    st[kPrevWasOver * C] = prev_over;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) st[(kFirRow0 + j) * C] = ring[j];
  }

  // After a guarded tail group of n ticks the oldest sample sits at
  // ring[n % 8]: rotate left by n % 8 to restore oldest-first order.
  __device__ __forceinline__ void realign(int n) {
    for (int k = 0; k < (n & (kTaps - 1)); ++k) {
      const int first = ring[0];
#pragma unroll
      for (int j = 0; j + 1 < kTaps; ++j) ring[j] = ring[j + 1];
      ring[kTaps - 1] = first;
    }
  }

  template <int kU>
  __device__ __forceinline__ void tick(int s_raw, int end_word,
                                       int32_t* slot_base, const Params& p) {
    int sigma;
    const int s = front.step(s_raw, p, sigma);
    // fir_filter over the previous 8 samples, oldest-first, then the
    // current sample takes the oldest slot
    uint32_t f = 0;
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      f += static_cast<uint32_t>(p.taps[j]) *
           static_cast<uint32_t>(ring[(kU + j) % kTaps]);
    const int filt = wrap_i16(static_cast<int>(f));
    ring[kU % kTaps] = s;
    const bool over = fir_over<kAvx>(filt, sigma, p);
    const bool closed = prev_over != 0 && !over;
    prev_over = over ? 1 : 0;
    int w0, w1;
    hit.step(over, fir_to_add(over, filt, p), filt, closed, w0, w1);
    if (closed) emit<kWords>(nclose, slot_base, p, w0, w1, end_word);
  }
};

// Input encodings (the C entry's `encoding`).
enum Encoding : int { kPlain = 0, kTime2 = 1, kPacked14 = 2 };

// Feed values one group holds per thread: time2 words (two ticks each),
// plain samples, or the samples extracted from packed 14-bit words.
template <int kEnc>
constexpr int kRowsPerGroup = kEnc == kTime2 ? kGroup / 2 : kGroup;

template <int kEnc>
constexpr int kRowTicks = kEnc == kTime2 ? 2 : 1;

// A thread's read position in the feed.  `fp` points at the current
// group's first tick; tick (or time2 row) u of the group sits at
// fp + u * stride.  Packed 14-bit words: the thread's channel c = 16g + r
// reads words j = 14r/32 and j + 1 of its 7-word group g (`lo`, `hi`
// offsets from fp) and extracts bits [14r % 32, +14) of the pair.
struct Cursor {
  const int32_t* fp;
  size_t stride;
  size_t col;      // the channel's column, or its packed word group's base
  size_t lo, hi;
  unsigned sh;
};

// The read position of channel c.  Packed 14-bit words: channel c = 16g + r
// sits in 7-word group g at (g / gpr) * outer + (g % gpr) * inner.
template <int kEnc>
__device__ __forceinline__ Cursor make_cursor(const Params& p, int c) {
  Cursor cur{};
  cur.stride = static_cast<size_t>(p.feed_stride);
  cur.col = static_cast<size_t>(c);
  if constexpr (kEnc == kPacked14) {
    const int g = c / 16, r = c % 16;
    const int j = 14 * r / 32;
    cur.col = static_cast<size_t>(g / p.groups_per_row) * p.group_outer +
              static_cast<size_t>(g % p.groups_per_row) * p.group_inner;
    cur.lo = static_cast<size_t>(j) * p.word_stride;
    // class 15 ends on its group's last bit: word j + 1 = 7 lies past the
    // group, and none of its bits are kept, so read word 6 twice
    cur.hi = static_cast<size_t>(j < 6 ? j + 1 : 6) * p.word_stride;
    cur.sh = static_cast<unsigned>(14 * r % 32);
  }
  return cur;
}

// Point the cursor at window tick t0 (a chunk's first sample).
template <int kEnc>
__device__ __forceinline__ void seek(Cursor& cur, const Params& p, int t0) {
  cur.fp = p.feed + static_cast<size_t>(t0 / kRowTicks<kEnc>) * cur.stride +
           cur.col;
}

// Tick kU of a group from its loaded feed values.
template <int kEnc, int kU>
__device__ __forceinline__ int sample(const int (&w)[kRowsPerGroup<kEnc>]) {
  if constexpr (kEnc == kTime2) {
    return kU % 2 == 0 ? wrap_i16(w[kU / 2]) : (w[kU / 2] >> 16);
  } else {
    return w[kU];
  }
}

// Load one group's feed values (kGuard: only the first n ticks, a chunk's
// ragged tail) and step the cursor to the next group.  Every load of the
// group goes out before its ticks, so their latency overlaps the chain.
template <int kEnc, bool kGuard>
__device__ __forceinline__ void load_group(int (&w)[kRowsPerGroup<kEnc>],
                                           Cursor& cur, int n) {
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
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerGroup<kEnc>; ++r)
      w[r] = (!kGuard || r * kRowTicks<kEnc> < n)
                 ? __ldg(cur.fp + static_cast<size_t>(r) * cur.stride)
                 : 0;
  }
  cur.fp += static_cast<size_t>(kRowsPerGroup<kEnc>) * cur.stride;
}

// The ticks of one group, expanded at compile time; kGuard runs only the
// first n (a chunk's ragged tail).
template <int kEnc, bool kGuard, class Ch, int... kU>
__device__ __forceinline__ void run_ticks(
    Ch& ch, const int (&w)[kRowsPerGroup<kEnc>], int n, int tick0,
    int32_t* slot_base, const Params& p, std::integer_sequence<int, kU...>) {
  ((!kGuard || kU < n
        ? ch.template tick<kU>(sample<kEnc, kU>(w), tick0 + kU + 1,
                               slot_base, p)
        : void()),
   ...);
}

template <int kEnc, bool kGuard, class Ch>
__device__ __forceinline__ void run_group(Ch& ch, Cursor& cur, int n,
                                          int tick0, int32_t* slot_base,
                                          const Params& p) {
  int w[kRowsPerGroup<kEnc>];
  load_group<kEnc, kGuard>(w, cur, n);
  run_ticks<kEnc, kGuard>(ch, w, n, tick0, slot_base, p,
                          std::make_integer_sequence<int, kGroup>{});
}

template <class Ch, int kEnc>
__global__ void __launch_bounds__(kBlock) tpg_kernel(Params p) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= p.n_channels) return;
  const size_t C = static_cast<size_t>(p.n_channels);
  int32_t* st = p.state + c;
  Ch ch;
  ch.load(st, C);
  Cursor cur = make_cursor<kEnc>(p, c);
  const int tc = p.ticks_per_chunk;
  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    ch.nclose = 0;
    const int t0 = chunk * tc;   // window tick of the chunk's first sample
    seek<kEnc>(cur, p, t0);
    int32_t* slot_base =
        p.slots + static_cast<size_t>(chunk) * p.k_slots * Ch::kWords * C + c;
    int g = 0;
    for (; g + kGroup <= tc; g += kGroup)
      run_group<kEnc, false>(ch, cur, kGroup, t0 + g, slot_base, p);
    if (g < tc) {
      run_group<kEnc, true>(ch, cur, tc - g, t0 + g, slot_base, p);
      ch.realign(tc - g);
    }
    p.nclose[static_cast<size_t>(chunk) * C + c] = ch.nclose;
  }
  ch.store(st, C);
}

template <class Ch, int kEnc>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.n_channels + kBlock - 1) / kBlock;
#ifdef TPG_HOST_EMULATION
  // host build for the CPU tests (tests/cuda_host/cuda_runtime.h): the
  // grid runs serially, one thread after another
  (void)stream;
  for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks);
       ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < kBlock; ++threadIdx.x)
      tpg_kernel<Ch, kEnc>(p);
#else
  tpg_kernel<Ch, kEnc><<<blocks, kBlock, 0, stream>>>(p);
#endif
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
//           over the chunk's ticks, decoding the feed as K1-K4 do; writes
//           the clamped samples into the s slab after its 8 ring rows
//           (oldest first, the carried FIR history) and sigma into its slab;
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
  FirFront front;
  int32_t* s;       // the channel's column of the s slab
  int32_t* sigma;   // ... of the sigma slab
  size_t C;
  int t0;           // window tick of the chunk's first sample

  __device__ __forceinline__ void realign(int) {}

  template <int kU>
  __device__ __forceinline__ void tick(int s_raw, int end_word, int32_t*,
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
  int32_t* st = p.state + c;
  Fir2Front a{};
  FirHit<kPeakGated, kTrackPeaks> hit{};
  int prev_over = 0;
  Cursor cur{};
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

template <class F>
cudaError_t pick_encoding(int encoding, F&& f) {
  switch (encoding) {
    case kPlain:
      return f(std::integral_constant<int, kPlain>{});
    case kTime2:
      return f(std::integral_constant<int, kTime2>{});
    case kPacked14:
      return f(std::integral_constant<int, kPacked14>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// The C entries' shared arguments -> Params; false on a value the kernels
// do not take.
bool make_params(Params& p, const void* feed, int feed_stride, int encoding,
                 int groups_per_row, int group_outer, int group_inner,
                 int word_stride, int n_chunks, int ticks_per_chunk,
                 void* state, int n_channels, void* slots, void* nclose,
                 int k_slots, int threshold, int accumulator_limit,
                 int rs_scale_factor_x10, const int* taps, int tap_exponent,
                 int adc_max, int sigma_cap, int thr_mult) {
  const bool packed = encoding == kPacked14;
  const bool bad_layout =
      packed ? (n_channels % 16 || groups_per_row <= 0 || group_outer < 0 ||
                group_inner < 0 || word_stride <= 0 || feed_stride <= 0)
             : feed_stride < n_channels;
  if (n_channels <= 0 || n_chunks <= 0 || ticks_per_chunk <= 0 ||
      k_slots <= 0 || bad_layout ||
      (encoding == kTime2 && ticks_per_chunk % 2) || tap_exponent < 0 ||
      tap_exponent > 15 || taps == nullptr)
    return false;
  p = Params{};
  p.feed = static_cast<const int32_t*>(feed);
  p.feed_stride = feed_stride;
  p.groups_per_row = groups_per_row;
  p.group_outer = group_outer;
  p.group_inner = group_inner;
  p.word_stride = word_stride;
  p.n_chunks = n_chunks;
  p.ticks_per_chunk = ticks_per_chunk;
  p.state = static_cast<int32_t*>(state);
  p.n_channels = n_channels;
  p.slots = static_cast<int32_t*>(slots);
  p.nclose = static_cast<int32_t*>(nclose);
  p.k_slots = k_slots;
  p.threshold = threshold;
  p.accumulator_limit = accumulator_limit;
  p.rs_scale_factor_x10 = rs_scale_factor_x10;
  for (int j = 0; j < kTaps; ++j) p.taps[j] = taps[j];
  p.tap_exponent = tap_exponent;
  p.adc_max = adc_max;
  p.sigma_cap = sigma_cap;
  p.thr_mult = thr_mult;
  return true;
}

}  // namespace

// Plain C entries for ctypes.  Each returns the cudaError_t of the launch
// (cudaGetLastError right after it); the caller raises when it is not 0.
// `taps` is a host array of 8 ints (read only for the FIR family).
// `encoding` is kPlain or kTime2 (rows of feed_stride >= n_channels
// values) or kPacked14: word (t, j) of channel group g sits at
// (g / groups_per_row) * group_outer + (g % groups_per_row) * group_inner
// + t * feed_stride + j * word_stride (the group_* and word_stride
// arguments are read only for kPacked14).
//
// tpg_launch: K1-K4, the fused tick of every family.
extern "C" int tpg_launch(const void* feed, int feed_stride, int encoding,
                          int groups_per_row, int group_outer,
                          int group_inner, int word_stride, int n_chunks,
                          int ticks_per_chunk, void* state, int n_channels,
                          void* slots, void* nclose, int k_slots, int family,
                          int peak_gated, int charge_floor, int track_peaks,
                          int avx, int threshold, int accumulator_limit,
                          int rs_scale_factor_x10, const int* taps,
                          int tap_exponent, int adc_max, int sigma_cap,
                          int thr_mult, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  if (!make_params(p, feed, feed_stride, encoding, groups_per_row,
                   group_outer, group_inner, word_stride, n_chunks,
                   ticks_per_chunk, state, n_channels, slots, nclose, k_slots,
                   threshold, accumulator_limit, rs_scale_factor_x10, taps,
                   tap_exponent, adc_max, sigma_cap, thr_mult))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  return static_cast<int>(pick_encoding(encoding, [&](auto enc) {
    constexpr int kEnc = decltype(enc)::value;
    return pick(peak_gated != 0, [&](auto gated) {
      constexpr bool kGated = decltype(gated)::value;
      if (family == kFIR) {
        return pick(track_peaks != 0, [&](auto tp) {
          return pick(avx != 0, [&](auto av) {
            return launch<FirChannel<kGated, decltype(tp)::value,
                                     decltype(av)::value>,
                          kEnc>(p, s);
          });
        });
      }
      return pick(charge_floor != 0, [&](auto fl) {
        constexpr bool kFloor = decltype(fl)::value;
        switch (family) {
          case kSimpleThreshold:
            return launch<ThresholdChannel<kSimpleThreshold, kGated, kFloor>,
                          kEnc>(p, s);
          case kAbsRS:
            return launch<ThresholdChannel<kAbsRS, kGated, kFloor>, kEnc>(
                p, s);
          case kStandardRS:
            return launch<ThresholdChannel<kStandardRS, kGated, kFloor>,
                          kEnc>(p, s);
          default:
            return cudaErrorInvalidValue;
        }
      });
    });
  }));
}

// tpg_fir2_launch: K5, the two-pass FIR schedule (the FIR family only;
// `family` and `charge_floor` are taken for a common argument list and
// must be kFIR and anything).  `lift` selects fir_twopass=2.  `scratch`
// holds the slabs, (tc + 8) x n_channels int32 each: 4, + 1 with
// track_peaks, + 2 (+ 1 with track_peaks) with lift.
extern "C" int tpg_fir2_launch(
    const void* feed, int feed_stride, int encoding, int groups_per_row,
    int group_outer, int group_inner, int word_stride, int n_chunks,
    int ticks_per_chunk, void* state, int n_channels, void* slots,
    void* nclose, int k_slots, int family, int peak_gated, int charge_floor,
    int track_peaks, int avx, int threshold, int accumulator_limit,
    int rs_scale_factor_x10, const int* taps, int tap_exponent, int adc_max,
    int sigma_cap, int thr_mult, int lift, void* scratch, int device,
    void* stream) {
  (void)charge_floor;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  if (family != kFIR || scratch == nullptr ||
      !make_params(p, feed, feed_stride, encoding, groups_per_row,
                   group_outer, group_inner, word_stride, n_chunks,
                   ticks_per_chunk, state, n_channels, slots, nclose, k_slots,
                   threshold, accumulator_limit, rs_scale_factor_x10, taps,
                   tap_exponent, adc_max, sigma_cap, thr_mult))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* const sc = static_cast<int32_t*>(scratch);

  return static_cast<int>(pick_encoding(encoding, [&](auto enc) {
    constexpr int kEnc = decltype(enc)::value;
    return pick(track_peaks != 0, [&](auto tp) {
      constexpr bool kPeaks = decltype(tp)::value;
      // peak_gated reads nothing without the peak registers
      return pick(kPeaks && peak_gated != 0, [&](auto gated) {
        constexpr bool kGated = kPeaks && decltype(gated)::value;
        return pick(avx != 0, [&](auto av) {
          return pick(lift != 0, [&](auto lf) {
            return launch_fir2<kEnc, kGated, kPeaks, decltype(av)::value,
                               decltype(lf)::value>(p, sc, s);
          });
        });
      });
    });
  }));
}
