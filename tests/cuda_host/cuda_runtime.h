// Host stand-in for the CUDA runtime, for the CPU tests only: enough of it
// to compile fdreadoutlibs_tpu_torch/csrc/tpg.cu with a C++ compiler and
// -DTPG_HOST_EMULATION, which runs the kernel's grid serially on the CPU
// (tests/test_torch_kernel_host.py).  The kernel's arithmetic and
// addressing are the card's; its scheduling, caching and timing are not.
#pragma once

#include <cstdint>

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline HostDim3 blockIdx, threadIdx;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;

inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// The low 32 bits of (hi:lo) >> (sh mod 32), as the PTX funnel shift.
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  const unsigned long long v = (static_cast<unsigned long long>(hi) << 32) | lo;
  return static_cast<unsigned>(v >> (sh & 31u));
}
