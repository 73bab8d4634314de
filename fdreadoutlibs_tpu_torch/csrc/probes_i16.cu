// P2: what int16 arithmetic costs on this card.
//
// Replaces scripts/probe_i16_ops.py: (a) _try_op (:32-60, pl.pallas_call at
// :47) over OPS (:63-84) and narrow_i16 (:96-99), one-op kernels on int16
// vectors; (b) _mix_kernel (:110-132, pl.pallas_call at :146), a
// compare-free op mix (sub, sign shift, xor, and, add) chained through 8
// arrays, int16 against int32.
//
// (a) nvcc compiles every op (the TPU's compiler refuses some), so the
// record here is what each op became: the caller disassembles the library
// and reports each kernel's instructions beyond those of the copy kernel
// (kCopy), which shows where sign extensions and byte permutes land.  CUDA
// has no 16-bit ALU path for integers: short promotes to int, and the store
// narrows.  Beside the script's ops the matrix holds the SIMD-in-word forms
// on two int16 per 32-bit register (__vadd2 ...) and two of Hopper's DPX
// forms (__vimax3_s16x2 and __viaddmax_s16x2, with a zero third operand), on
// int32 words.
//
// (b) per element one serial chain: each step runs the 8 arrays in turn,
// array j's update taking array j-1's new value (prev = x), 5 operations
// each.  Three arms on the same element count: int32; int16 as K2b does it
// (csrc/tpg.cuh::w16: an int register re-narrowed after each op that can
// leave the range); two int16 per register with __vsub2 / __vcmplts2 /
// __vadd2 (xor and and are plain), half the threads.  The mix has no clip
// or maximum, so it admits no DPX arm; P3's chain has the clip (its
// packed_minmax arm).  Array j's
// element i is at a[j * n + i], n the elements (or words) per array.
//
// What bounds it: the chain's latency at few warps per SM, the int32 issue
// rate at a saturating geometry.
#include "probes.cuh"

namespace {

using namespace probes;

// The order of fdreadoutlibs_tpu_torch/probes/i16_ops.py::OP_NAMES.
enum Op : int {
  kAdd, kSub, kMul, kShlConst, kShrsConst, kShrs15, kShrVec, kAnd, kOr, kXor,
  kNot, kNeg, kSelectMask, kCmpiGt, kMinimum, kWidenI32, kMulWiden,
  kIotaLike, kNarrowI16, kCopy,
  // two int16 per int32 word
  kVadd2, kVsub2, kVcmplts2, kVcmpgts2, kVmaxs2, kVmins2, kVimax3S16x2,
  kViaddmaxS16x2,
  kNumOps
};

template <int kOp>
constexpr bool kWordOp = kOp >= kVadd2;
template <int kOp>
using InT = std::conditional_t<kOp == kNarrowI16 || kWordOp<kOp>, int32_t,
                               int16_t>;
template <int kOp>
using OutT = std::conditional_t<kOp == kWidenI32 || kOp == kMulWiden ||
                                    kWordOp<kOp>,
                                int32_t, int16_t>;

// The op on promoted values; the caller's store narrows an int16 result
// (mod 2^16, as the JAX int16 arithmetic).
template <int kOp>
__device__ __forceinline__ int apply(int a, int b) {
  const uint32_t ua = static_cast<uint32_t>(a), ub = static_cast<uint32_t>(b);
  if constexpr (kOp == kAdd) return a + b;
  else if constexpr (kOp == kSub) return a - b;
  else if constexpr (kOp == kMul) return a * b;
  else if constexpr (kOp == kShlConst) return wshl(a, 2);
  else if constexpr (kOp == kShrsConst) return a >> 3;
  else if constexpr (kOp == kShrs15) return wrap16(a - b) >> 15;
  else if constexpr (kOp == kShrVec) return a >> (b & 3);
  else if constexpr (kOp == kAnd) return a & b;
  else if constexpr (kOp == kOr) return a | b;
  else if constexpr (kOp == kXor) return a ^ b;
  else if constexpr (kOp == kNot) return ~a;
  else if constexpr (kOp == kNeg) return -a;
  else if constexpr (kOp == kSelectMask)
    return b ^ ((a ^ b) & (wrap16(a - b) >> 15));
  else if constexpr (kOp == kCmpiGt) return a > b ? 1 : 0;
  else if constexpr (kOp == kMinimum) return a < b ? a : b;
  else if constexpr (kOp == kWidenI32) return a;
  else if constexpr (kOp == kMulWiden) return a * b;
  else if constexpr (kOp == kIotaLike) return a + 5;
  else if constexpr (kOp == kNarrowI16) return wadd(a, b);
  else if constexpr (kOp == kCopy) return a;
  else if constexpr (kOp == kVadd2) return static_cast<int>(__vadd2(ua, ub));
  else if constexpr (kOp == kVsub2) return static_cast<int>(__vsub2(ua, ub));
  else if constexpr (kOp == kVcmplts2)
    return static_cast<int>(__vcmplts2(ua, ub));
  else if constexpr (kOp == kVcmpgts2)
    return static_cast<int>(__vcmpgts2(ua, ub));
  else if constexpr (kOp == kVmaxs2) return static_cast<int>(__vmaxs2(ua, ub));
  else if constexpr (kOp == kVmins2) return static_cast<int>(__vmins2(ua, ub));
  else if constexpr (kOp == kVimax3S16x2)
    return static_cast<int>(__vimax3_s16x2(ua, ub, 0u));
  else
    return static_cast<int>(__viaddmax_s16x2(ua, ub, 0u));
}

template <int kOp>
__global__ void op_kernel(const void* a, const void* b, void* out, int n) {
  const int i = global_thread();
  if (i >= n) return;
  const int x = static_cast<const InT<kOp>*>(a)[i];
  const int y = static_cast<const InT<kOp>*>(b)[i];
  static_cast<OutT<kOp>*>(out)[i] = static_cast<OutT<kOp>>(apply<kOp>(x, y));
}

template <int kOp>
cudaError_t launch_op(const void* a, const void* b, void* out, int n,
                      cudaStream_t s) {
  auto* kern = &op_kernel<kOp>;
  PROBE_LAUNCH(kern, (n + kBlock - 1) / kBlock, kBlock, s, a, b, out, n);
  return cudaGetLastError();
}

template <int... kOps>
cudaError_t dispatch_op(int op, const void* a, const void* b, void* out,
                        int n, cudaStream_t s,
                        std::integer_sequence<int, kOps...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((op == kOps ? (err = launch_op<kOps>(a, b, out, n, s), 0) : 0), ...);
  return err;
}

// ---- (b) the op mix --------------------------------------------------------

enum MixArm : int { kMixI32 = 0, kMixI16 = 1, kMixPacked = 2 };
constexpr int kArrays = 8;
constexpr int kC1 = 0x1D;

// One step of one array: m = (x - prev) >> (bits - 1); x = ((x ^ m) & prev)
// + c1.
template <int kArm>
__device__ __forceinline__ int mix_step(int x, int prev) {
  if constexpr (kArm == kMixI32) {
    const int m = wsub(x, prev) >> 31;
    return wadd((x ^ m) & prev, kC1);
  } else if constexpr (kArm == kMixI16) {
    const int m = wrap16(x - prev) >> 15;
    return wrap16(((x ^ m) & prev) + kC1);
  } else {
    const uint32_t ux = static_cast<uint32_t>(x);
    const uint32_t up = static_cast<uint32_t>(prev);
    const uint32_t m = __vcmplts2(__vsub2(ux, up), 0u);
    return static_cast<int>(__vadd2((ux ^ m) & up, (kC1 << 16) | kC1));
  }
}

template <int kArm>
__global__ void mix_kernel(const void* a, void* out, int n_iters, int n) {
  using T = std::conditional_t<kArm == kMixI16, int16_t, int32_t>;
  const int i = global_thread();
  if (i >= n) return;
  int x[kArrays];
#pragma unroll
  for (int j = 0; j < kArrays; ++j)
    x[j] = static_cast<const T*>(a)[static_cast<size_t>(j) * n + i];
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    int prev = x[kArrays - 1];
#pragma unroll
    for (int j = 0; j < kArrays; ++j) {
      x[j] = mix_step<kArm>(x[j], prev);
      prev = x[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kArrays; ++j)
    static_cast<T*>(out)[static_cast<size_t>(j) * n + i] =
        static_cast<T>(x[j]);
}

template <int kArm>
cudaError_t launch_mix(const void* a, void* out, int n_iters, int blocks,
                       int threads, cudaStream_t s) {
  auto* kern = &mix_kernel<kArm>;
  PROBE_LAUNCH(kern, blocks, threads, s, a, out, n_iters, blocks * threads);
  return cudaGetLastError();
}

}  // namespace

// One op on n elements: a, b int16 (int32 for narrow_i16 and the word ops),
// out int16 (int32 for widen_i32, mul_widen and the word ops).
extern "C" int probe_i16_op_launch(const void* a, const void* b, void* out,
                                   int op, int n, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch_op(op, a, b, out, n, static_cast<cudaStream_t>(stream),
                  std::make_integer_sequence<int, kNumOps>{}));
}

// The mix on (8, blocks * threads) elements of the arm's type (int32, int16,
// or int32 words of two int16), n_iters steps.
extern "C" int probe_i16_mix_launch(const void* a, void* out, int arm,
                                    int n_iters, int blocks, int threads,
                                    int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  if (n_iters < 0 || bad_geometry(blocks, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kMixI32:
      return static_cast<int>(launch_mix<kMixI32>(a, out, n_iters, blocks, threads, s));
    case kMixI16:
      return static_cast<int>(launch_mix<kMixI16>(a, out, n_iters, blocks, threads, s));
    case kMixPacked:
      return static_cast<int>(launch_mix<kMixPacked>(a, out, n_iters, blocks, threads, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
