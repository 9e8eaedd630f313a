// An empty kernel, launched like every other kernel of the library: the
// yardstick for kernels of a few microseconds.  Timed in a replayed CUDA
// graph (utils/devtime.py::launch_floor_ms) it gives what the card takes
// between two dependent kernels, the floor under the device time of any
// kernel measured the same way.  It replaces no TPU kernel and no path of
// the forward model calls it.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace mcmctof {
namespace {

__global__ void empty_kernel() {}

}  // namespace
}  // namespace mcmctof

extern "C" int mcmctof_empty_kernel(int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  mcmctof::empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
