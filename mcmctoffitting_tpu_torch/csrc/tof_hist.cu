// Kernel K2: zero-degree-segment TOF histograms of the forward model.
//
// Replaces the TPU kernel mcmctoffitting_tpu/ops/pallas_tof.py::_tof_kernel
// (pl.pallas_call at :127).  Plain PyTorch version: the expand-then-
// histogram path in mcmctoffitting_tpu_torch/ops/cuda_tof.py::
// tof_hist_segments_plain.  Wrapper and dispatch: ops/cuda_tof.py::
// tof_hist_segments.
//
// What it computes, per (walker, run) row: the M * Be lattice cells, each
// spread over the K zero-degree segments, give M * Be * K samples
//   v = base_tof[m, b] + zt[b, k],   w = draws[m, b] * zw[b, k],
// histogrammed into the run's window with np.histogram's rules:
//   idx = clamp(floor((v - lo) * scale), 0, n_bins - 1), counted only when
//   lo <= v <= hi (so v == hi lands in the last bin).
// scale is float32(n_bins / (hi - lo)), fixed on the host.  Output rows are
// padded to n_pad bins; bins at or beyond the run's n_bins stay zero.
//
// Weights stay float32.  The TPU kernel rounds them to bf16 because it
// histograms with one-hot products on the matrix unit; that rounding
// belongs to the TPU's schedule, not to the model, and the JAX package's
// own CPU path sums in float32 too.
//
// Design: one thread block per (walker, run) row, a float32 histogram of
// n_pad bins in shared memory (no cap on the bin count), threads striding
// over the row's samples and accumulating with shared-memory atomicAdd, then
// one coalesced write of the row.  Summation order follows the atomics, so
// results agree with the plain version to float32 rounding, not bitwise.
//
// What bounds it on an H100: neither bytes nor flops.  A row reads 2 * M*Be
// floats (40 KB at M = 10, Be = 50) and does ~5k adds; at 512-1024 rows per
// launch the kernel is bound by shared-memory atomic throughput on the
// busiest bins and by launch latency.

#include <cuda_runtime.h>

namespace mcmctof {
namespace {

constexpr int kThreads = 256;

__global__ void tof_hist_kernel(const float* __restrict__ base,
                                const float* __restrict__ draws,
                                const float* __restrict__ zt,
                                const float* __restrict__ zw,
                                const float* __restrict__ win_lo,
                                const float* __restrict__ win_hi,
                                const float* __restrict__ win_scale,
                                const int* __restrict__ win_nb1,
                                float* __restrict__ out, int n_runs,
                                int n_cells, int n_ed, int n_seg,
                                int n_pad) {
  extern __shared__ float hist[];
  const int row = blockIdx.x;
  const int run = row % n_runs;
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x) hist[j] = 0.0f;
  __syncthreads();

  const float lo = win_lo[run];
  const float hi = win_hi[run];
  const float scale = win_scale[run];
  const int nb1 = win_nb1[run];
  const float* row_base = base + static_cast<long long>(row) * n_cells;
  const float* row_draws = draws + static_cast<long long>(row) * n_cells;
  const int n_samples = n_cells * n_seg;
  for (int s = threadIdx.x; s < n_samples; s += blockDim.x) {
    const int cell = s / n_seg;
    const int seg = s - cell * n_seg;
    const int tab = (cell % n_ed) * n_seg + seg;
    const float v = row_base[cell] + zt[tab];
    if (v >= lo && v <= hi) {
      int idx = static_cast<int>(floorf((v - lo) * scale));
      idx = min(max(idx, 0), nb1);
      atomicAdd(&hist[idx], row_draws[cell] * zw[tab]);
    }
  }
  __syncthreads();
  float* row_out = out + static_cast<long long>(row) * n_pad;
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x) row_out[j] = hist[j];
}

}  // namespace
}  // namespace mcmctof

extern "C" int mcmctof_tof_hist(const float* base, const float* draws,
                                const float* zt, const float* zw,
                                const float* lo, const float* hi,
                                const float* scale, const int* nb1,
                                float* out, int n_rows, int n_runs,
                                int n_cells, int n_ed, int n_seg, int n_pad,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    const size_t smem = static_cast<size_t>(n_pad) * sizeof(float);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(mcmctof::tof_hist_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    mcmctof::tof_hist_kernel<<<n_rows, mcmctof::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        base, draws, zt, zw, lo, hi, scale, nb1, out, n_runs, n_cells, n_ed,
        n_seg, n_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
