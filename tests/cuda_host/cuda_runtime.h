// Host stand-in for the CUDA runtime, for the CPU tests only: enough of it
// to compile fdreadoutlibs_tpu_torch/csrc/tpg*.cu and csrc/probes*.cu with a
// C++ compiler and -DTPG_HOST_EMULATION (tests/test_torch_kernel_host.py).  A grid without
// barriers (the probes') runs serially, one thread after another; a block
// of the pipeline, whose threads meet at __syncthreads() or __syncwarp()
// and pass its stages, runs as that many host threads (host_run_block),
// the barrier a real one among them, a stage barrier a host barrier with
// the mbarrier's arrive and parity wait, its asynchronous copy a plain
// one, and its __shared__ arrays (static and dynamic) are shared by them.
// The kernel's arithmetic and addressing are the card's; its scheduling,
// caching and timing are not.
#pragma once

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
// blocks run one at a time, so one static array serves as a block's
#define __shared__ static

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline HostDim3 blockIdx;
inline HostDim3 blockDim;
inline thread_local HostDim3 threadIdx;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;

// the calling thread's current device, as the runtime keeps it; the CPU
// tests read it after a C entry through cuda_host_current_device
inline thread_local int host_current_device = 0;
inline cudaError_t cudaSetDevice(int device) {
  host_current_device = device;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* device) {
  *device = host_current_device;
  return cudaSuccess;
}
extern "C" __attribute__((weak, visibility("default"))) int
cuda_host_current_device() {
  return host_current_device;
}
extern "C" __attribute__((weak, visibility("default"))) void
cuda_host_set_device(int device) {
  host_current_device = device;
}
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

// float ops rounded on their own (no contraction into an FMA)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

// The SIMD-in-word intrinsics on two signed 16-bit halves, as per-half
// arithmetic (the probes' packed arms).
template <class F>
inline unsigned host_per_half(unsigned a, unsigned b, F f) {
  const unsigned lo = static_cast<uint16_t>(
      f(static_cast<int16_t>(a), static_cast<int16_t>(b)));
  const unsigned hi = static_cast<uint16_t>(
      f(static_cast<int16_t>(a >> 16), static_cast<int16_t>(b >> 16)));
  return lo | (hi << 16);
}
inline unsigned __vadd2(unsigned a, unsigned b) {
  return host_per_half(a, b, [](int x, int y) { return x + y; });
}
inline unsigned __vsub2(unsigned a, unsigned b) {
  return host_per_half(a, b, [](int x, int y) { return x - y; });
}
inline unsigned __vcmplts2(unsigned a, unsigned b) {
  return host_per_half(a, b, [](int x, int y) { return x < y ? 0xFFFF : 0; });
}
inline unsigned __vcmpgts2(unsigned a, unsigned b) {
  return host_per_half(a, b, [](int x, int y) { return x > y ? 0xFFFF : 0; });
}
inline unsigned __vmaxs2(unsigned a, unsigned b) {
  return host_per_half(a, b, [](int x, int y) { return x > y ? x : y; });
}
inline unsigned __vmins2(unsigned a, unsigned b) {
  return host_per_half(a, b, [](int x, int y) { return x < y ? x : y; });
}
// two of Hopper's DPX forms: max(a, b, c) and max(a + b, c) per half
inline unsigned __vimax3_s16x2(unsigned a, unsigned b, unsigned c) {
  return __vmaxs2(__vmaxs2(a, b), c);
}
inline unsigned __viaddmax_s16x2(unsigned a, unsigned b, unsigned c) {
  return __vmaxs2(__vadd2(a, b), c);
}

// A reusable barrier for n threads (a block's, or a warp's 32 lanes).
class HostBarrier {
 public:
  explicit HostBarrier(unsigned n = 32) : n_(n) {}
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
inline HostBarrier* host_block_warps = nullptr;   // one per warp
inline std::vector<unsigned char>* host_block_shared = nullptr;

inline void __syncthreads() { host_block_barrier->wait(); }

// A warp's lanes meet (all 32 of them).
inline void __syncwarp() { host_block_warps[threadIdx.x / 32].wait(); }

// The FIR pipeline's stage barrier (an mbarrier on the card): `count`
// arrivals complete a phase; a wait for parity p returns once the phase of
// that parity has completed, as mbarrier.try_wait.parity does.
struct StageBar {
  std::mutex mu;
  std::condition_variable cv;
  unsigned count = 0, pending = 0, phase = 0;   // phase: phases completed
};

inline void stage_bar_init(StageBar* bar, unsigned count) {
  std::lock_guard<std::mutex> lock(bar->mu);
  bar->count = bar->pending = count;
  bar->phase = 0;
}

inline void stage_bar_arrive(StageBar* bar) {
  std::lock_guard<std::mutex> lock(bar->mu);
  if (--bar->pending == 0) {
    bar->pending = bar->count;
    ++bar->phase;
    bar->cv.notify_all();
  }
}

inline void stage_bar_wait(StageBar* bar, unsigned parity) {
  std::unique_lock<std::mutex> lock(bar->mu);
  bar->cv.wait(lock, [&] { return (bar->phase & 1u) != parity; });
}

// The pipeline's asynchronous copy of 4 bytes as a plain one, landed at
// once (by bytes: the int16 feed's words are two samples), and its arrival
// on the stage's barrier.
inline void stage_copy(int32_t* dst, const int32_t* src) {
  std::memcpy(dst, src, sizeof(int32_t));
}
inline void stage_copy_arrive(StageBar* bar) { stage_bar_arrive(bar); }

// The block's dynamic shared memory (the launch's byte count).
template <class T>
T* host_dynamic_shared() {
  return reinterpret_cast<T*>(host_block_shared->data());
}

// Run `body` as one block of n threads (threadIdx.x = 0..n-1) with
// `shared_bytes` of dynamic shared memory.
template <class F>
void host_run_block(unsigned n, F body, size_t shared_bytes = 0) {
  HostBarrier barrier(n);
  std::unique_ptr<HostBarrier[]> warps(new HostBarrier[(n + 31) / 32]);
  std::vector<unsigned char> shared(shared_bytes);
  host_block_barrier = &barrier;
  host_block_warps = warps.get();
  host_block_shared = &shared;
  std::vector<std::thread> threads;
  threads.reserve(n);
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&body, t] {
      threadIdx.x = t;
      body();
    });
  for (std::thread& th : threads) th.join();
  host_block_barrier = nullptr;
  host_block_warps = nullptr;
  host_block_shared = nullptr;
}
