// Makes the tensors' device current for one entry point of the library.
//
// A kernel launch goes to the calling thread's current device, so a launch
// on a stream of another device is refused.  Every entry point therefore
// needs the right device current; calling cudaSetDevice on each call costs
// the host a call below the runtime although, with one card or with
// PyTorch's device already set, nothing changes.  The guard reads the
// current device (a thread-local read in the runtime), switches only if it
// differs, and switches back when the entry point returns.
#pragma once

#include <cuda_runtime.h>

namespace mcmctof {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

// What an entry point returns when a runtime call other than a launch
// failed: the error's code, with the runtime's record of it cleared so
// that the next entry point's cudaGetLastError() does not report it again.
inline int failed(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace mcmctof
