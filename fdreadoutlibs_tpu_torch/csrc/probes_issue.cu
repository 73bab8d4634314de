// P1: the int32 issue rate and the latency of a dependent op.
//
// Replaces scripts/roofline.py::probe_issue_rate (the kernel nested at
// :164-180, pl.pallas_call at :182).  One thread holds kIlp independent
// chains in registers; a step of a chain is the JAX body's
// x = x + 0x9E3779B9; x = x ^ (x >> 7) (add, arithmetic shift, xor: three
// dependent int32 operations with no foldable structure), and one iteration
// runs 32 / kIlp steps on each chain, so every arm does 96 operations per
// thread per iteration whatever its ILP.  Where the TPU sweeps the tile's
// rows, the caller sweeps what hides latency here: warps per SM and blocks
// (run-time geometry).  Element i of chain j is x[j * n + i], n = blocks x
// threads.
//
// What bounds it: at one warp per scheduler the chain's latency (a few
// cycles per dependent op), with enough warps or chains in flight the SM's
// int32 issue rate (64 lanes per clock nominal).  The compiler may fold the
// shift and xor into fewer or other instructions: the caller reads the loop
// body's SASS and reports its instruction count beside every rate.
#include "probes.cuh"

namespace {

using namespace probes;

constexpr int kUnits = 32;                  // steps per iteration over all chains
constexpr int kGolden = static_cast<int>(0x9E3779B9u);

template <int kIlp>
__global__ void issue_kernel(const int32_t* x, int32_t* out, int n_iters,
                             int n) {
  constexpr int kPerChain = kUnits / kIlp;
  const int i = global_thread();
  if (i >= n) return;
  int ch[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) ch[j] = x[static_cast<size_t>(j) * n + i];
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      int v = ch[j];
#pragma unroll
      for (int k = 0; k < kPerChain; ++k) {
        v = wadd(v, kGolden);
        v = v ^ (v >> 7);
      }
      ch[j] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) out[static_cast<size_t>(j) * n + i] = ch[j];
}

template <int kIlp>
cudaError_t launch_issue(const int32_t* x, int32_t* out, int n_iters,
                         int blocks, int threads, cudaStream_t s) {
  auto* kern = &issue_kernel<kIlp>;
  PROBE_LAUNCH(kern, blocks, threads, s, x, out, n_iters, blocks * threads);
  return cudaGetLastError();
}

}  // namespace

// x, out: (ilp, blocks * threads) int32; ilp in {1, 2, 4, 8, 16}.  Returns
// the cudaError_t of the launch.
extern "C" int probe_issue_launch(const void* x, void* out, int ilp,
                                  int n_iters, int blocks, int threads,
                                  int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess)
    return static_cast<int>(scope.error());
  if (n_iters < 0 || bad_geometry(blocks, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* oi = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ilp) {
    case 1:
      return static_cast<int>(launch_issue<1>(xi, oi, n_iters, blocks, threads, s));
    case 2:
      return static_cast<int>(launch_issue<2>(xi, oi, n_iters, blocks, threads, s));
    case 4:
      return static_cast<int>(launch_issue<4>(xi, oi, n_iters, blocks, threads, s));
    case 8:
      return static_cast<int>(launch_issue<8>(xi, oi, n_iters, blocks, threads, s));
    case 16:
      return static_cast<int>(launch_issue<16>(xi, oi, n_iters, blocks, threads, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
