// K1 for Hopper: the SWTPG tick over the time2 feed, for the
// SimpleThreshold, AbsRS and StandardRS families.
//
// Replaces fdreadoutlibs_tpu/ops/pallas_tpg.py::_tpg_kernel on its time2
// datapath (time_packed=True, reached through
// fdreadoutlibs_tpu/ops/ingest.py::process_time2_feed).  The arithmetic is
// fdreadoutlibs_tpu/ops/step.py::tpg_tick, which stays the single source of
// tick semantics: the plain version beside this kernel
// (fdreadoutlibs_tpu_torch/ops/tpg.py::process_window_plain) runs that very
// function on torch tensors, and the two are compared bit for bit.
//
// Design.  One thread owns one channel; consecutive threads take
// consecutive channels, so every feed-word load and slot store of a warp is
// coalesced.  The grid is ceil(C/128) blocks of 128 threads.  Inside a
// thread a serial loop runs over chunks and ticks with the whole live
// ChanState in registers; a feed word holds two ticks (t0 = sign-extended
// low half, t1 = arithmetic >> 16), and kPrefetch words are loaded ahead
// of the ticks that consume them so their latency overlaps the chain.  A
// close writes its 3-word record [charge<<16|tover, peak<<16|ptime, end+1]
// with direct stores to slots[chunk][nclose][w][c] while nclose < K;
// nclose counts every close (drops included), is stored at each chunk end
// and restarts at 0.  The slot buffer must arrive zeroed (an empty slot is
// a zero end word).  State is read once and written back once, in place.
//
// What bounds it on this card: the per-tick dependency chain (two frugal
// updates, the RS division and the hit chain: ~30 dependent integer ops per
// tick) at about 2 B read per sample.  One 40-link APA is 2560 channels =
// 20 blocks of 4 warps, so it fills only about 20 of the 132 SMs with one
// block each; later work measures and acts on that (more APAs per launch,
// fewer threads per block).
//
// Shifts on negative ints: left shifts run on uint32_t and int16 wraps go
// through int16_t, so nothing relies on undefined signed behaviour.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kPrefetch = 8;
constexpr int kRecordWords = 3;
constexpr int kInt16Max = 32767;
constexpr int kInt16Min = -32768;

// State rows (fdreadoutlibs_tpu/ops/chanstate.py FIELDS order, then
// rs_memory_factor); rows not named here pass through untouched.
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
  kMemoryFactor = 14,
};

enum Family : int { kSimpleThreshold = 0, kAbsRS = 1, kStandardRS = 2 };

__device__ __forceinline__ int wrap_i16(int x) {
  return static_cast<int>(static_cast<int16_t>(x));
}

__device__ __forceinline__ int pack16(int hi, int lo) {
  return static_cast<int>((static_cast<uint32_t>(hi) << 16) |
                          static_cast<uint32_t>(lo));
}

// step.py::frugal_update: delta = clip(s - m, -1, 1); a bump of the median
// resets the accumulator.
__device__ __forceinline__ void frugal(int& m, int& acc, int s, int limit) {
  const int d = s - m;
  acc += d > 1 ? 1 : (d < -1 ? -1 : d);
  if (acc > limit) {
    m += 1;
    acc = 0;
  } else if (acc < -limit) {
    m -= 1;
    acc = 0;
  }
}

struct Params {
  const int32_t* feed;   // (T/2, feed_stride) time-paired words
  int feed_stride;
  int n_chunks;
  int words_per_chunk;   // tc / 2
  int32_t* state;        // (KSTATE, C)
  int n_channels;
  int32_t* slots;        // (n_chunks, K, 3, C), zeroed
  int32_t* nclose;       // (n_chunks, C)
  int k_slots;
  int threshold;
  int accumulator_limit;
  int rs_scale_factor_x10;
};

template <int kFamily, bool kPeakGated, bool kChargeFloor>
struct Channel {
  int ped, acc, charge, tover, peak_adc, peak_time;
  int prev_over, rs, ped_rs, acc_rs, mf;
  int nclose;

  // step.py::tpg_tick for one sample; `end_word` is the window tick + 1.
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
      if (nclose < p.k_slots) {
        const size_t C = static_cast<size_t>(p.n_channels);
        int32_t* rec = slot_base + static_cast<size_t>(nclose) * kRecordWords * C;
        rec[0] = pack16(ch, tv);
        rec[C] = pack16(pk, pt);
        rec[2 * C] = end_word;
      }
      ++nclose;
      charge = tover = peak_adc = peak_time = 0;
    } else {
      charge = ch;
      tover = tv;
      peak_adc = pk;
      peak_time = pt;
    }
  }
};

template <int kFamily, bool kPeakGated, bool kChargeFloor>
__global__ void __launch_bounds__(kBlock) tpg_time2_kernel(Params p) {
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= p.n_channels) return;
  const size_t C = static_cast<size_t>(p.n_channels);
  int32_t* st = p.state + c;

  Channel<kFamily, kPeakGated, kChargeFloor> ch;
  ch.ped = st[kPedestals * C];
  ch.acc = st[kAccum * C];
  ch.charge = st[kHitCharge * C];
  ch.tover = st[kHitTover * C];
  ch.peak_adc = st[kHitPeakAdc * C];
  ch.peak_time = st[kHitPeakTime * C];
  ch.prev_over = ch.rs = ch.ped_rs = ch.acc_rs = ch.mf = 0;
  if (kFamily == kSimpleThreshold) {
    ch.prev_over = st[kPrevWasOver * C];
  } else {
    ch.rs = st[kRs * C];
    ch.ped_rs = st[kPedestalsRs * C];
    ch.acc_rs = st[kAccumRs * C];
    ch.mf = st[kMemoryFactor * C];
  }

  const int wpc = p.words_per_chunk;
  const size_t stride = static_cast<size_t>(p.feed_stride);
  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    ch.nclose = 0;
    const int32_t* fp = p.feed + static_cast<size_t>(chunk) * wpc * stride + c;
    int32_t* slot_base =
        p.slots + static_cast<size_t>(chunk) * p.k_slots * kRecordWords * C + c;
    int end_word = chunk * 2 * wpc;  // window tick before the next sample
    for (int j0 = 0; j0 < wpc; j0 += kPrefetch) {
      int w[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u)
        w[u] = j0 + u < wpc ? __ldg(fp + static_cast<size_t>(j0 + u) * stride) : 0;
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (j0 + u < wpc) {
          ch.tick(wrap_i16(w[u]), end_word + 1, slot_base, p);
          ch.tick(w[u] >> 16, end_word + 2, slot_base, p);
        }
        end_word += 2;
      }
    }
    p.nclose[static_cast<size_t>(chunk) * C + c] = ch.nclose;
  }

  st[kPedestals * C] = ch.ped;
  st[kAccum * C] = ch.acc;
  st[kHitCharge * C] = ch.charge;
  st[kHitTover * C] = ch.tover;
  st[kHitPeakAdc * C] = ch.peak_adc;
  st[kHitPeakTime * C] = ch.peak_time;
  if (kFamily == kSimpleThreshold) {
    st[kPrevWasOver * C] = ch.prev_over;
  } else {
    st[kRs * C] = ch.rs;
    st[kPedestalsRs * C] = ch.ped_rs;
    st[kAccumRs * C] = ch.acc_rs;
  }
}

template <int kFamily, bool kPeakGated, bool kChargeFloor>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.n_channels + kBlock - 1) / kBlock;
  tpg_time2_kernel<kFamily, kPeakGated, kChargeFloor>
      <<<blocks, kBlock, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int kFamily, bool kPeakGated>
cudaError_t pick_floor(bool with_floor, const Params& p, cudaStream_t stream) {
  return with_floor ? launch<kFamily, kPeakGated, true>(p, stream)
                    : launch<kFamily, kPeakGated, false>(p, stream);
}

template <int kFamily>
cudaError_t pick_gate(bool gated, bool with_floor, const Params& p,
                      cudaStream_t stream) {
  return gated ? pick_floor<kFamily, true>(with_floor, p, stream)
               : pick_floor<kFamily, false>(with_floor, p, stream);
}

}  // namespace

// Plain C entry for ctypes.  Returns the cudaError_t of the launch
// (cudaGetLastError right after it); the caller raises when it is not 0.
extern "C" int tpg_time2_launch(const void* feed, int feed_stride,
                                int n_chunks, int words_per_chunk, void* state,
                                int n_channels, void* slots, void* nclose,
                                int k_slots, int family, int peak_gated,
                                int charge_floor, int threshold,
                                int accumulator_limit, int rs_scale_factor_x10,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_channels <= 0 || n_chunks <= 0 || words_per_chunk <= 0 ||
      k_slots <= 0 || feed_stride < n_channels)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const int32_t*>(feed), feed_stride, n_chunks,
           words_per_chunk, static_cast<int32_t*>(state), n_channels,
           static_cast<int32_t*>(slots), static_cast<int32_t*>(nclose),
           k_slots, threshold, accumulator_limit, rs_scale_factor_x10};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gated = peak_gated != 0, with_floor = charge_floor != 0;
  switch (family) {
    case kSimpleThreshold:
      err = pick_gate<kSimpleThreshold>(gated, with_floor, p, s);
      break;
    case kAbsRS:
      err = pick_gate<kAbsRS>(gated, with_floor, p, s);
      break;
    case kStandardRS:
      err = pick_gate<kStandardRS>(gated, with_floor, p, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
