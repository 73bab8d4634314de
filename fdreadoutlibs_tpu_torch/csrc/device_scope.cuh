// The C entries' device handling, shared by the kernel libraries (tpg.cu,
// probes.cuh): an entry launches on the device it is given and leaves the
// calling thread's current device as it found it, so an allocation or a
// stream query that relies on the current device after a launch on another
// card does not land on that card.
#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  // cudaSuccess, or the error of reading or setting the device
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};
