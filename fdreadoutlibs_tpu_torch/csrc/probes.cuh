// The probe kernels for Hopper, shared by the translation units
// csrc/probes_*.cu (ops/_build.py library "probes"; plain C entries loaded
// with ctypes by fdreadoutlibs_tpu_torch/probes/*.py):
//   P1  probes_issue.cu  the int32 issue-rate and dependent-op latency probe
//       (scripts/roofline.py::probe_issue_rate, pl.pallas_call at :182);
//   P2  probes_i16.cu    the one-op int16 kernels and the compare-free op
//       mix, int32 against int16 against two int16 per register
//       (scripts/probe_i16_ops.py::_try_op :47 and ::_mix_kernel :146);
//   P3  probes_swar.cu   the frugal pedestal chain alone, one channel per
//       register against two (scripts/bench_swar_frugal.py :128).
// Each is a register-resident dependent chain, which is the thing measured:
// iteration counts and geometry are run-time arguments, everything else is
// a template parameter, and every chain's result is stored so nothing is
// dead.  The TPU kernels' (8, 128) tiles are not carried over: a tile has
// no meaning on this card, an element is a thread's register.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "device_scope.cuh"

// Launch `kern` (a pointer to a __global__ function) on blocks x threads.
#ifdef TPG_HOST_EMULATION
// host build for the CPU tests (tests/cuda_host/cuda_runtime.h): no probe
// kernel has a barrier, so the grid runs serially, one thread after another
#define PROBE_LAUNCH(kern, blocks, threads, stream, ...)                     \
  do {                                                                       \
    (void)(stream);                                                          \
    blockDim.x = static_cast<unsigned>(threads);                             \
    for (blockIdx.x = 0; blockIdx.x < static_cast<unsigned>(blocks);         \
         ++blockIdx.x)                                                       \
      for (threadIdx.x = 0; threadIdx.x < static_cast<unsigned>(threads);    \
           ++threadIdx.x)                                                    \
        kern(__VA_ARGS__);                                                   \
  } while (0)
#else
#define PROBE_LAUNCH(kern, blocks, threads, stream, ...) \
  kern<<<(blocks), (threads), 0, (stream)>>>(__VA_ARGS__)
#endif

namespace probes {

// Threads per block of the kernels that take one thread per channel.
constexpr int kBlock = 128;

__device__ __forceinline__ int global_thread() {
  return static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
}

// int32 arithmetic mod 2^32, as the JAX kernels' (no undefined signed
// overflow or shift).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) +
                          static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) -
                          static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wshl(int a, int n) {
  return static_cast<int>(static_cast<uint32_t>(a) << n);
}
__device__ __forceinline__ int wrap16(int x) {
  return static_cast<int>(static_cast<int16_t>(x));
}

inline bool bad_geometry(int blocks, int threads) {
  return blocks <= 0 || threads <= 0 || threads > 1024;
}

}  // namespace probes
