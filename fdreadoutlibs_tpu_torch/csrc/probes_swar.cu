// P3: the frugal pedestal chain alone, one channel per 32-bit register
// against two.
//
// Replaces scripts/bench_swar_frugal.py (pl.pallas_call at :128 over
// _unpacked_kernel :35-51 and _packed_kernel :54-89).  Per tick and channel:
// delta = clip(s - m, -1, 1); acc += delta; the median m moves one step and
// the accumulator restarts when |acc| passes the limit of 10 — the pedestal
// update of every TPG family (csrc/tpg.cuh::frugal).  Arms:
//   unpacked     one thread per channel on (T, C) int32 samples;
//   packed       one thread per channel pair on (T, C / 2) words, channel 2i
//                in the low and 2i + 1 in the high half, values biased by
//                1 << 14 and accumulators by 1 << 7 so that no half ever
//                borrows; the arithmetic is the JAX kernel's, int32 shifts
//                and compares per half (:64-86);
//   packed_simd  the same chain on the SIMD-in-word intrinsics (__vcmpgts2,
//                __vcmplts2, __vsub2, __vadd2), bit-equal under the same
//                bias invariants;
//   packed_minmax packed_simd with the clip as __vmaxs2(__vmins2(d, 1), -1)
//                on the per-half difference (P2 records what the per-half
//                minimum and maximum become on this card).
// One launch walks the whole window, 16 ticks at a time: a group's loads
// go out before its chain so their latency overlaps it.  m and acc are updated in place.
//
// What bounds it: the chain's latency times the ticks.  2560 channels are 20
// blocks of 128 threads on 132 SMs (10 blocks when packed), so packing
// halves the threads of a card that is mostly idle already and pays only if
// the packed chain per tick is shorter than two unpacked ones in turn.
#include "probes.cuh"

namespace {

using namespace probes;

enum Arm : int { kUnpacked = 0, kPacked = 1, kPackedSimd = 2, kPackedMinmax = 3 };
constexpr int kLimit = 10;
constexpr int kBC = 1 << 7;            // the accumulator halves' bias
constexpr int kGroup = 16;             // ticks per unrolled group
constexpr uint32_t kOnes = 0x00010001u;

template <int kArm>
__device__ __forceinline__ void frugal_step(int s, int& m, int& acc) {
  if constexpr (kArm == kUnpacked) {
    const int d = s - m;
    acc += d > 1 ? 1 : (d < -1 ? -1 : d);
    const bool over = acc > kLimit, under = acc < -kLimit;
    m = over ? m + 1 : (under ? m - 1 : m);
    acc = (over || under) ? 0 : acc;
  } else if constexpr (kArm == kPacked) {
    // per-half compares: the low halves moved to the top, the high halves
    // by an arithmetic shift
    const int s_lo = wshl(s, 16), m_lo = wshl(m, 16);
    const int s_hi = s >> 16, m_hi = m >> 16;
    const int gt_lo = s_lo > m_lo, lt_lo = s_lo < m_lo;
    const int gt_hi = s_hi > m_hi, lt_hi = s_hi < m_hi;
    acc = wadd(acc, wadd(gt_lo - lt_lo, wshl(gt_hi - lt_hi, 16)));
    const int a_lo = wshl(acc, 16), a_hi = acc >> 16;
    const int ov_lo = a_lo > ((kLimit + kBC) << 16);
    const int un_lo = a_lo < ((-kLimit + kBC) << 16);
    const int ov_hi = a_hi > kLimit + kBC, un_hi = a_hi < -kLimit + kBC;
    m = wadd(m, wadd(ov_lo - un_lo, wshl(ov_hi - un_hi, 16)));
    acc = (ov_lo | un_lo) ? ((acc & ~0xFFFF) | kBC) : acc;
    acc = (ov_hi | un_hi) ? ((acc & 0xFFFF) | (kBC << 16)) : acc;
  } else {
    const uint32_t us = static_cast<uint32_t>(s);
    uint32_t um = static_cast<uint32_t>(m), ua = static_cast<uint32_t>(acc);
    uint32_t delta;
    if constexpr (kArm == kPackedMinmax) {
      delta = __vmaxs2(__vmins2(__vsub2(us, um), kOnes), 0xFFFFFFFFu);
    } else {
      // a true half is 0xFFFF = -1: lt - gt is -1, 0 or +1 per half
      delta = __vsub2(__vcmplts2(us, um), __vcmpgts2(us, um));
    }
    ua = __vadd2(ua, delta);
    const uint32_t ov = __vcmpgts2(ua, (kLimit + kBC) * kOnes);
    const uint32_t un = __vcmplts2(ua, (-kLimit + kBC) * kOnes);
    um = __vadd2(um, __vsub2(un, ov));
    const uint32_t bump = ov | un;
    ua = (ua & ~bump) | ((kBC * kOnes) & bump);
    m = static_cast<int>(um);
    acc = static_cast<int>(ua);
  }
}

template <int kArm>
__global__ void __launch_bounds__(kBlock)
    frugal_kernel(const int32_t* adc, int stride, int n_ticks, int32_t* m_io,
                  int32_t* acc_io, int n) {
  const int c = global_thread();
  if (c >= n) return;
  int m = m_io[c], acc = acc_io[c];
  const int32_t* p = adc + c;
  int t = 0;
  for (; t + kGroup <= n_ticks; t += kGroup) {
    int s[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      s[u] = __ldg(p + static_cast<size_t>(t + u) * stride);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) frugal_step<kArm>(s[u], m, acc);
  }
  for (; t < n_ticks; ++t)
    frugal_step<kArm>(__ldg(p + static_cast<size_t>(t) * stride), m, acc);
  m_io[c] = m;
  acc_io[c] = acc;
}

template <int kArm>
cudaError_t launch_frugal(const int32_t* adc, int stride, int n_ticks,
                          int32_t* m, int32_t* acc, int n, cudaStream_t s) {
  auto* kern = &frugal_kernel<kArm>;
  PROBE_LAUNCH(kern, (n + kBlock - 1) / kBlock, kBlock, s, adc, stride,
               n_ticks, m, acc, n);
  return cudaGetLastError();
}

}  // namespace

// adc: (n_ticks, stride >= n) int32 samples (arm 0) or packed words (arms
// 1-3); m, acc: (n,) int32, updated in place.
extern "C" int probe_swar_launch(const void* adc, int stride, int n_ticks,
                                 void* m, void* acc, int n, int arm,
                                 int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  if (n <= 0 || n_ticks < 0 || stride < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* a = static_cast<const int32_t*>(adc);
  int32_t* mi = static_cast<int32_t*>(m);
  int32_t* ai = static_cast<int32_t*>(acc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kUnpacked:
      return static_cast<int>(launch_frugal<kUnpacked>(a, stride, n_ticks, mi, ai, n, s));
    case kPacked:
      return static_cast<int>(launch_frugal<kPacked>(a, stride, n_ticks, mi, ai, n, s));
    case kPackedSimd:
      return static_cast<int>(launch_frugal<kPackedSimd>(a, stride, n_ticks, mi, ai, n, s));
    case kPackedMinmax:
      return static_cast<int>(launch_frugal<kPackedMinmax>(a, stride, n_ticks, mi, ai, n, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
