// Kernel K4: fused RK4 Bethe transport + within-bin moment histograms.
//
// Replaces the TPU kernel mcmctoffitting_tpu/ops/pallas_forward.py::
// _fused_kernel (pl.pallas_call at :121).  Plain PyTorch version:
// mcmctoffitting_tpu_torch/ops/cuda_transport.py::transport_moments_plain
// (ops/stopping.py::rk4_transport, then a scatter_add of the moments).
// Wrapper and dispatch: ops/cuda_transport.py::transport_moments.
//
// What it computes, per row (one (walker, run) pair) of N initial deuteron
// energies e0: each sample is integrated with fixed-step RK4 through the
// M x-bin centres of the gas cell,
//   dE/dx = -(A/E) (P + Q ln E),   E clamped to the 20 keV floor,
// and at every depth m its energy e adds the within-bin offset moments
// (1, d, d^2, d^3) to bin idx of the eD histogram, where
//   u = (e - lo) * inv_width, idx = clamp(floor(u), 0, Be - 1),
//   d = u - idx - 0.5, counted only when lo <= e <= hi.
// Output: (rows, M, 4, Be) float32.
//
// The operation order is rk4_transport's: a sample at or below the floor
// is frozen; k1..k4 clamp their argument to the floor inside dE/dx;
// e_new = max(e + h/6 (k1 + 2 k2 + 2 k3 + k4), floor).  A/E is a true
// division, and h, h/2, h/6 and every constant are float32 values fixed on
// the host.  Built with -fmad=false and without --use_fast_math, the
// kernel then rounds like its plain version: the transported energies, and
// so the bins, agree bit for bit wherever logf agrees (CUDA's logf on both
// sides on the card).  The clamp keeps NaN, as torch.clamp_min does.
//
// The TPU kernel reduced each depth's channels against a one-hot on the
// matrix unit; that is a device of the TPU.  Here the moments go straight
// into shared-memory histograms with atomics: one (M, 4, Be) copy per
// warp where shared memory allows it (8 KB each at M = 10, Be = 50), so
// only the lanes of one warp contend for an address.  A block owns a slice
// of one row's samples (grid.y splits a row when there are few rows, to
// fill the 132 SMs); at the end it sums its copies in a fixed order and
// adds them into the row's output with global atomics (the wrapper zeroes
// the output).  The optional e_out receives the transported energies
// (rows, M, N) for checks.
//
// What bounds it on an H100: operations.  Per (sample, depth) four dE/dx
// evaluations (a division and a logf each) and the RK4 and binning
// arithmetic, ~60 float32 operations; the input is 4 bytes per sample.  At
// the slice's half-step, 512 rows x 200k samples x 10 depths, that is
// ~6.1e10 operations against 0.4 GB read: the float32 rate, not the
// memory, sets the bound, and shared-memory atomic throughput
// (4 channels x 10 depths per sample) is the next limit.

#include <cuda_runtime.h>

namespace mcmctof {
namespace {

constexpr int kTmThreads = 256;
constexpr int kTmMaxSpans = 64;
constexpr int kTmSmemLimit = 200 * 1024;

struct TmParams {
  float a, p, q, floor_e, lo, hi, inv_width;
  int n_x, n_sub, n_bins, n_copies;
};

__device__ __forceinline__ float clamp_floor(float e, float f) {
  return e < f ? f : e;  // NaN stays NaN, as torch.clamp_min
}

__device__ __forceinline__ float dedx(float e, const TmParams& c) {
  e = clamp_floor(e, c.floor_e);
  const float l = logf(e);
  return -(c.a / e) * (c.q * l + c.p);
}

__global__ void transport_moments_kernel(const float* __restrict__ e0,
                                         const float* __restrict__ steps,
                                         float* __restrict__ out,
                                         float* __restrict__ e_out,
                                         long long n, TmParams c) {
  extern __shared__ float smem[];
  __shared__ float s_h[kTmMaxSpans], s_half[kTmMaxSpans], s_sixth[kTmMaxSpans];
  const int per_copy = c.n_x * 4 * c.n_bins;
  const long long row = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;

  for (int j = threadIdx.x; j < per_copy * c.n_copies; j += blockDim.x)
    smem[j] = 0.0f;
  for (int j = threadIdx.x; j < c.n_x; j += blockDim.x) {
    s_h[j] = steps[j];
    s_half[j] = steps[c.n_x + j];
    s_sixth[j] = steps[2 * c.n_x + j];
  }
  __syncthreads();

  float* hist = smem + ((threadIdx.x >> 5) % c.n_copies) * per_copy;
  const long long begin = (n * split) / n_split;
  const long long end = (n * (split + 1)) / n_split;
  const float* row_e0 = e0 + row * n;

  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    float e = row_e0[i];
    for (int m = 0; m < c.n_x; ++m) {
      const float h = s_h[m];
      const float half_h = s_half[m];
      const float sixth_h = s_sixth[m];
      for (int s = 0; s < c.n_sub; ++s) {
        const bool stopped = e <= c.floor_e;
        const float k1 = dedx(e, c);
        const float k2 = dedx(e + half_h * k1, c);
        const float k3 = dedx(e + half_h * k2, c);
        const float k4 = dedx(e + h * k3, c);
        const float step = ((k1 + 2.0f * k2) + 2.0f * k3) + k4;
        const float e_new = clamp_floor(e + sixth_h * step, c.floor_e);
        e = stopped ? e : e_new;
      }
      if (e_out != nullptr) e_out[(row * c.n_x + m) * n + i] = e;
      if (e >= c.lo && e <= c.hi) {
        const float u = (e - c.lo) * c.inv_width;
        int idx = static_cast<int>(floorf(u));
        idx = min(max(idx, 0), c.n_bins - 1);
        const float d = (u - static_cast<float>(idx)) - 0.5f;
        const float d2 = d * d;
        float* cell = hist + m * 4 * c.n_bins + idx;
        atomicAdd(cell, 1.0f);
        atomicAdd(cell + c.n_bins, d);
        atomicAdd(cell + 2 * c.n_bins, d2);
        atomicAdd(cell + 3 * c.n_bins, d2 * d);
      }
    }
  }
  __syncthreads();

  float* row_out = out + row * per_copy;
  for (int j = threadIdx.x; j < per_copy; j += blockDim.x) {
    float sum = 0.0f;
    for (int k = 0; k < c.n_copies; ++k) sum += smem[k * per_copy + j];
    if (n_split == 1) {
      row_out[j] = sum;
    } else if (sum != 0.0f) {
      atomicAdd(row_out + j, sum);
    }
  }
}

}  // namespace
}  // namespace mcmctof

// steps: device float32 (3, n_x) = (h, h/2, h/6) per x interval.
// out must be zeroed by the caller when n_split > 1.
extern "C" int mcmctof_transport_moments(
    const float* e0, const float* steps, float* out, float* e_out,
    int n_rows, long long n, int n_x, int n_sub, int n_bins, float a,
    float p, float q, float floor_e, float lo, float hi, float inv_width,
    int n_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_x < 1 || n_x > mcmctof::kTmMaxSpans || n_bins < 1 || n_sub < 1 ||
      n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_copy =
      static_cast<size_t>(n_x) * 4 * n_bins * sizeof(float);
  if (per_copy > mcmctof::kTmSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_copies = static_cast<int>(mcmctof::kTmSmemLimit / per_copy);
  n_copies = min(n_copies, mcmctof::kTmThreads / 32);
  const size_t smem = per_copy * n_copies;
  if (n_rows > 0 && n > 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(mcmctof::transport_moments_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    mcmctof::TmParams c{a, p, q, floor_e, lo, hi, inv_width,
                        n_x, n_sub, n_bins, n_copies};
    dim3 grid(n_rows, n_split);
    mcmctof::transport_moments_kernel<<<grid, mcmctof::kTmThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
        e0, steps, out, e_out, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}
