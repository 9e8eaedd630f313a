// Kernel K3: weighted histograms of many rows with np.histogram's rules.
//
// Replaces the TPU kernel mcmctoffitting_tpu/ops/pallas_hist.py::
// _hist_kernel (pl.pallas_call at :84), which was built to replace
// ops/histogram.py::weighted_histogram.  Plain PyTorch version:
// mcmctoffitting_tpu_torch/ops/cuda_hist.py::weighted_histogram_plain.
// Wrapper and dispatch: ops/cuda_hist.py::weighted_histogram.  On the mc
// path with xs_mode='exact' the rows are the (walker, run, x-bin) triples,
// the values the transported energies and the weights their cross
// sections.
//
// What it computes, per row of a (rows, row_len) pair of float32 arrays,
// over the first n_valid entries (a padded tail is masked, as n_valid
// does in the TPU kernel):
//   idx = clamp(floor((v - lo) * scale), 0, n_bins - 1), counted only when
//   lo <= v <= hi (v == hi lands in the last bin, v == lo in the first;
//   values outside and NaN are dropped), out[row, idx] += w.
// scale is float32(n_bins / (hi - lo)), fixed on the host.
//
// Weights stay float32 (the TPU kernel's bf16 one-hot product on the
// matrix unit belongs to the TPU) and are summed in float64: a bin of the
// 'exact' path sums up to 200k weights, where a float32 sum in the
// atomics' arbitrary order drifts by ~1e-5 of the row total between runs;
// in float64 the kernel and its plain version (which also sums in
// float64) agree to the final float32 rounding.
//
// Design: one block per row; a float64 histogram of n_bins per warp in
// shared memory (atomics contend only within a warp); the threads stride
// over the row, neighbouring threads on neighbouring addresses, four
// loads in flight per thread; at the end the warp copies are summed in a
// fixed order and the row written once, rounded to float32.
//
// What bounds it on an H100: bytes.  Every value and weight is read once
// and used for a handful of operations: at the slice's half-step (5,120
// rows x 200k samples) that is 8.2 GB, ~2.4 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace mcmctof {
namespace {

constexpr int kWhThreads = 256;
constexpr int kWhWarps = kWhThreads / 32;

__global__ void weighted_hist_kernel(const float* __restrict__ values,
                                     const float* __restrict__ weights,
                                     float* __restrict__ out,
                                     long long row_len, long long n_valid,
                                     float lo, float hi, float scale,
                                     int n_bins) {
  extern __shared__ double hist[];
  const long long row = blockIdx.x;
  for (int j = threadIdx.x; j < n_bins * kWhWarps; j += blockDim.x)
    hist[j] = 0.0;
  __syncthreads();

  double* my_hist = hist + (threadIdx.x >> 5) * n_bins;
  const float* v_row = values + row * row_len;
  const float* w_row = weights + row * row_len;
  const int nb1 = n_bins - 1;
  constexpr int kUnroll = 4;
  const long long stride = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = threadIdx.x; base < n_valid; base += stride) {
    float v[kUnroll], w[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      const bool ok = i < n_valid;
      v[k] = ok ? v_row[i] : lo - 1.0f;
      w[k] = ok ? w_row[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (v[k] >= lo && v[k] <= hi) {
        int idx = static_cast<int>(floorf((v[k] - lo) * scale));
        idx = min(max(idx, 0), nb1);
        atomicAdd(&my_hist[idx], static_cast<double>(w[k]));
      }
    }
  }
  __syncthreads();
  float* row_out = out + row * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    double sum = 0.0;
    for (int k = 0; k < kWhWarps; ++k) sum += hist[k * n_bins + j];
    row_out[j] = static_cast<float>(sum);
  }
}

}  // namespace
}  // namespace mcmctof

extern "C" int mcmctof_weighted_hist(const float* values,
                                     const float* weights, float* out,
                                     int n_rows, long long row_len,
                                     long long n_valid, float lo, float hi,
                                     float scale, int n_bins, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bins < 1 || n_valid > row_len || n_valid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(n_bins) * mcmctof::kWhWarps * sizeof(double);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(mcmctof::weighted_hist_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    mcmctof::weighted_hist_kernel<<<n_rows, mcmctof::kWhThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        values, weights, out, row_len, n_valid, lo, hi, scale, n_bins);
  }
  return static_cast<int>(cudaGetLastError());
}
