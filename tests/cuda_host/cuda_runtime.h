// Host stand-in for the CUDA runtime, for the CPU tests only: enough of it
// to compile fdreadoutlibs_tpu_torch/csrc/tpg.cu with a C++ compiler and
// -DTPG_HOST_EMULATION (tests/test_torch_kernel_host.py).  A grid without
// barriers runs serially, one thread after another; a block whose threads
// meet at __syncthreads() runs as that many host threads (host_run_block),
// the barrier a real one among them, and its __shared__ arrays are shared
// by them.  The kernel's arithmetic and addressing are the card's; its
// scheduling, caching and timing are not.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)
// blocks run one at a time, so one static array serves as a block's
#define __shared__ static

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline HostDim3 blockIdx;
inline thread_local HostDim3 threadIdx;

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

// A reusable barrier for the n threads of one block.
class HostBarrier {
 public:
  explicit HostBarrier(unsigned n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mu_);
    const unsigned gen = gen_;
    if (++waiting_ == n_) {
      waiting_ = 0;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lock, [&] { return gen_ != gen; });
    }
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  const unsigned n_;
  unsigned waiting_ = 0;
  unsigned gen_ = 0;
};

inline HostBarrier* host_block_barrier = nullptr;

inline void __syncthreads() { host_block_barrier->wait(); }

// Run `body` as one block of n threads (threadIdx.x = 0..n-1).
template <class F>
void host_run_block(unsigned n, F body) {
  HostBarrier barrier(n);
  host_block_barrier = &barrier;
  std::vector<std::thread> threads;
  threads.reserve(n);
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&body, t] {
      threadIdx.x = t;
      body();
    });
  for (std::thread& th : threads) th.join();
  host_block_barrier = nullptr;
}
