// The counts estimator's rate stage: Poisson rates and conditional moments
// of the F fine cells and the two overflow cells, for every walker, in one
// launch.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses it (mcmctoffitting_tpu/ops/e0grid.py::counts_lambdas).  Plain
// PyTorch version, op for op the same arithmetic:
// mcmctoffitting_tpu_torch/ops/e0grid.py::counts_lambdas (with
// expected_moments, _lognorm_w_machinery and expected_e0_mean).  Wrapper
// and dispatch: ops/cuda_rates.py::counts_rates.
//
// Why a kernel: the plain version is some 500 (exact closure, truncated:
// simultFit) or 290 (oneBD) small PyTorch operations an evaluation, each a
// launch of a few microseconds of work on (W, F+1) values, and the host's
// time to enqueue them (5-6 ms an evaluation on the H100's host) held the
// card idle most of a fit.  The stage is pure arithmetic on the walker's
// four parameters and the grid's edges: no random numbers, no sum across
// walkers.
//
// What it computes, per walker (beamE, eLoss, scale, s), W = exp(s Z):
//   edges    w_e = (beamE - edge_e - eLoss) / scale (truncated: at most
//            w(e0 = 0)), and ndtr(ln(w_e) / s - j s) for j < 4 (exact
//            closure) or j < 2 ('cell'), over the F+1 fine-cell edges;
//   cells    the partial moments of W in each cell, their t-moments S_k
//            (exact binomial algebra, or the within-cell linear density of
//            the 'cell' closure), scaled to n_samples draws; the rate lam =
//            S_0 and the conditional moments m_k = S_k / S_0;
//   scalars  the normaliser (truncated), the rates and conditional e0 means
//            of the draws below and above the grid, and the closed-form e0
//            mean.
// Every operation is the plain version's, in its order and precision:
// erff / erfcf / logf / expf from the CUDA maths library, IEEE divisions,
// no contracted multiply-add (the library is built with -fmad=false), a
// division by a Python number as a product with its reciprocal, taken in
// float64 and rounded to float32 (how PyTorch's CUDA division by a Python
// number computes; a float32 reciprocal of the rounded number differs by
// an ulp on oneBD's grid), clamp_min and minimum / maximum passing NaN on
// as PyTorch's do, a ** 3 as (a * a) * a.  The result is the plain
// version's on the card bit for bit.
//
// What bounds it on an H100: neither bytes nor operations.  At the
// production half-step (128 walkers, F = 512) it writes 1.3 MB (0.4 us at
// 3.35 TB/s) and evaluates 263k ndtr; the card's floor between two
// dependent kernels is about 1 us.
//
// Design: one block per walker, 1,024 threads.
//   * The threads walk the F+1 edges; each computes its edge's ndtr values
//     once and keeps them in shared memory, where the two cells that share
//     the edge read them.
//   * Meanwhile the block's last six threads, which get no second edge,
//     compute the walker's six scalars (two ndtr and two logf each) into
//     shared memory.
//   * After one barrier the threads walk the F cells, the output's fastest
//     axis, so that a warp writes 32 neighbouring words of every row.
//   * One output buffer: lam (W, F+2), then m (W, 4, F), then the three
//     (W,) means; K1 reads lam as it lies.
//   * The parameters are read in place through their strides (simultFit's
//     are the first four columns of the (W, D) walkers).
// The time is latency: a thread's chain of dependent ndtr and divisions.
// Measured on the H100 (device time in a replayed graph, 128 walkers,
// F = 512 / 1,024): 256 threads with the scalars on the first six 6.7 /
// 8.2 us, on the last six 5.9 / 7.5 us; with them on the last six, 512
// threads 5.3 / 5.8 us and 1,024 threads 4.9 / 5.3 us, against a floor of
// 1.0 us between two dependent kernels.
// The closure and the truncation are template parameters.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace mcmctof {
namespace {

constexpr int kRatesThreads = 1024;

// float32 of the plain version's Python constants
constexpr float kHalfSqrt2 = static_cast<float>(0.70710678118654752440);
constexpr float kTiny = static_cast<float>(1e-30);
constexpr float kTinyS0 = static_cast<float>(1e-12);
constexpr float kInf = __builtin_huge_valf();

struct RatesConsts {
  float t_ref;       // float32(t_ref)
  float inv_tscale;  // float32(1 / t_scale), the reciprocal in float64
  float e0_lo;       // float32(e0_lo)
  float e0_hi;       // float32(e0_hi)
  float n_samples;   // float32(n_samples)
  float hh12;        // float32(h * h / 12), 'cell' closure (h in float64)
  float h2_tenth;    // float32(0.1 * h * h), 'cell' closure
};

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fffffff);
}

// torch.clamp_min: NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || b != b) ? nan_value() : fminf(a, b);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a || b != b) ? nan_value() : fmaxf(a, b);
}

// e0grid.py::relu_split: 0.5 (x + |x|)
__device__ __forceinline__ float relu_split(float x) {
  return 0.5f * (x + fabsf(x));
}

// pdfs.py::ndtr: erf near 0, erfc in the tails
__device__ __forceinline__ float ndtr(float x) {
  const float w = x * kHalfSqrt2;
  const float z = fabsf(w);
  const float y = z < kHalfSqrt2 ? 1.0f + erff(w)
                                 : (w > 0.0f ? 2.0f - erfcf(z) : erfcf(z));
  return 0.5f * y;
}

// e0grid.py::_lognorm_w_machinery's partial: E[W^j; lo < W < hi] (no hi:
// +inf); j is 0 or 1, half_jj = float64(0.5 j j) in float32
__device__ __forceinline__ float partial(float j, float half_jj, float lo,
                                         float hi, bool has_hi, float s) {
  const float lo_c = clamp_min(lo, kTiny);
  const float top =
      has_hi ? ndtr(logf(clamp_min(hi, kTiny)) / s - s * j) : 1.0f;
  const float amt = top - ndtr(logf(lo_c) / s - s * j);
  return expf(half_jj * s * s) * relu_split(amt);
}

// cond_mean_e0 of counts_lambdas
__device__ __forceinline__ float cond_mean(float p0, float p1, float beam,
                                           float eloss, float safe_scale) {
  return p0 > kTiny ? (beam - eloss) - safe_scale * p1 / clamp_min(p0, kTiny)
                    : 0.0f;
}

template <bool kTruncated, bool kExact>
__global__ void __launch_bounds__(kRatesThreads)
counts_rates_kernel(const float* __restrict__ params, long long row_stride,
                    long long col_stride, const float* __restrict__ edges,
                    const float* __restrict__ t_edges,
                    float* __restrict__ out, int n_walkers, int n_fine,
                    RatesConsts c) {
  constexpr int kRows = kExact ? 4 : 2;
  extern __shared__ float nd[];          // (kRows, F + 1)
  __shared__ float scalars[6];
  const int walker = blockIdx.x;
  const int n_edges = n_fine + 1;
  const float* p = params + walker * row_stride;
  const float beam = p[0];
  const float eloss = p[col_stride];
  const float scale = p[2 * col_stride];
  const float s_raw = p[3 * col_stride];
  const bool valid = (scale > 0.0f) && (s_raw > 0.0f);
  const float safe_scale = scale > 0.0f ? scale : 1.0f;
  const float s = s_raw > 0.0f ? s_raw : 1.0f;
  const float w_max = (beam - 0.0f - eloss) / safe_scale;

  // the walker's scalars: the normaliser, the overflow partials, the mean
  const int t = threadIdx.x;
  const int lane = t - (kRatesThreads - 6);
  if (lane >= 0) {
    const float w_lo = (beam - c.e0_lo - eloss) / safe_scale;
    const float w_hi = (beam - c.e0_hi - eloss) / safe_scale;
    float v = 1.0f;
    if (lane == 0) {
      if (kTruncated) v = partial(0.0f, 0.0f, 0.0f, w_max, true, s);
    } else if (lane <= 2) {
      const float j = lane == 1 ? 0.0f : 1.0f;
      v = partial(j, 0.5f * j, w_lo, w_max, kTruncated, s);
    } else if (lane <= 4) {
      const float j = lane == 3 ? 0.0f : 1.0f;
      v = partial(j, 0.5f * j, 0.0f, w_hi, true, s);
    } else {                             // e0grid.py::expected_e0_mean
      float mean_w;
      if (kTruncated) {
        const float zmax =
            logf(clamp_min((beam - eloss) / safe_scale, kTiny)) / s;
        float norm = ndtr(zmax);
        norm = (valid && norm > 0.0f) ? norm : 1.0f;
        mean_w = expf(s * 0.5f * s) * ndtr(zmax - s) / norm;
      } else {
        mean_w = expf(s * 0.5f * s);
      }
      v = (beam - eloss) - safe_scale * mean_w;
    }
    scalars[lane] = v;
  }

  // the ndtr chain over the edges, each edge once
  for (int e = t; e < n_edges; e += kRatesThreads) {
    float w = (beam - edges[e] - eloss) / safe_scale;
    if (kTruncated) w = minimum(w, w_max);
    const float logw = logf(clamp_min(w, kTiny)) / s;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      nd[j * n_edges + e] = ndtr(logw - static_cast<float>(j) * s);
    }
  }
  __syncthreads();

  float norm = 1.0f;
  if (kTruncated) {
    norm = scalars[0];
    norm = (valid && norm > 0.0f) ? norm : 1.0f;
  }
  const float factor = 1.0f / norm * c.n_samples;
  // t = a - b W
  const float a_c = (beam - c.t_ref - eloss) * c.inv_tscale;
  const float b_c = safe_scale * c.inv_tscale;
  float coef[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float jf = static_cast<float>(j);
    coef[j] = expf(jf * 0.5f * jf * s * s);
  }
  float* lam = out + static_cast<long long>(walker) * (n_fine + 2);
  float* m = out + static_cast<long long>(n_walkers) * (n_fine + 2)
             + static_cast<long long>(walker) * 4 * n_fine;
  for (int f = t; f < n_fine; f += kRatesThreads) {
    float pm[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      pm[j] = coef[j]
              * relu_split(nd[j * n_edges + f] - nd[j * n_edges + f + 1]);
    }
    float sk[4];
    sk[0] = pm[0];
    sk[1] = a_c * pm[0] - b_c * pm[1];
    if constexpr (kExact) {
      sk[2] = a_c * a_c * pm[0] - 2.0f * a_c * b_c * pm[1]
              + b_c * b_c * pm[2];
      const float a3 = a_c * a_c * a_c;
      const float b3 = b_c * b_c * b_c;
      sk[3] = a3 * pm[0] - 3.0f * a_c * a_c * b_c * pm[1]
              + 3.0f * a_c * b_c * b_c * pm[2] - b3 * pm[3];
    } else {
      // the within-cell linear density pinned by the conditional mean
      const float t_lo = t_edges[f];
      const float t_hi = t_edges[f + 1];
      const float t_c = 0.5f * (t_lo + t_hi);
      const float m1 =
          minimum(maximum(sk[1] / clamp_min(sk[0], kTinyS0), t_lo), t_hi);
      const float dm = m1 - t_c;
      const float v = relu_split(c.hh12 - dm * dm);
      const float mu3 = (2.0f * dm * dm - c.h2_tenth) * dm;
      sk[2] = sk[0] * (m1 * m1 + v);
      sk[3] = sk[0] * (m1 * (m1 * m1 + 3.0f * v) + mu3);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) sk[k] = valid ? sk[k] * factor : 0.0f;
    const float s0 = sk[0];
    lam[f] = fabsf(s0) < kInf ? clamp_min(s0, 0.0f) : 0.0f;   // isfinite
    const float den = clamp_min(s0, kTinyS0);
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k * n_fine + f] = sk[k] / den;
  }

  if (t == 0) {
    const float p0_below = scalars[1], p1_below = scalars[2];
    const float p0_above = scalars[3], p1_above = scalars[4];
    lam[n_fine] = valid ? c.n_samples * p0_below / norm : 0.0f;
    lam[n_fine + 1] = valid ? c.n_samples * p0_above / norm : 0.0f;
    float* means = out + static_cast<long long>(n_walkers) * (n_fine + 2)
                   + static_cast<long long>(n_walkers) * 4 * n_fine;
    means[walker] = cond_mean(p0_below, p1_below, beam, eloss, safe_scale);
    means[n_walkers + walker] =
        cond_mean(p0_above, p1_above, beam, eloss, safe_scale);
    means[2 * n_walkers + walker] = scalars[5];
  }
}

template <bool kTruncated, bool kExact>
cudaError_t launch(const float* params, long long row_stride,
                   long long col_stride, const float* edges,
                   const float* t_edges, float* out, int n_walkers,
                   int n_fine, const RatesConsts& c, cudaStream_t stream) {
  constexpr int kRows = kExact ? 4 : 2;
  const size_t shared = sizeof(float) * kRows * (n_fine + 1);
  auto kernel = counts_rates_kernel<kTruncated, kExact>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_walkers, kRatesThreads, shared, stream>>>(
      params, row_stride, col_stride, edges, t_edges, out, n_walkers, n_fine,
      c);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mcmctof

// params: (W, >= 4) float32 read through (row_stride, col_stride) in
// elements; edges, t_edges: (F+1,); out: W (F+2) + 4 W F + 3 W floats.
// Returns a cudaError_t.
extern "C" int mcmctof_counts_rates(
    const float* params, long long row_stride, long long col_stride,
    const float* edges, const float* t_edges, float* out, int n_walkers,
    int n_fine, int truncated, int exact, float t_ref, float inv_tscale,
    float e0_lo, float e0_hi, float n_samples, float hh12, float h2_tenth,
    int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (n_walkers <= 0) return 0;
  if (n_fine < 1) return static_cast<int>(cudaErrorInvalidValue);
  const mcmctof::RatesConsts c{t_ref, inv_tscale, e0_lo, e0_hi, n_samples,
                               hh12, h2_tenth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (truncated) {
    err = exact ? mcmctof::launch<true, true>(params, row_stride, col_stride,
                                              edges, t_edges, out, n_walkers,
                                              n_fine, c, s)
                : mcmctof::launch<true, false>(params, row_stride, col_stride,
                                               edges, t_edges, out, n_walkers,
                                               n_fine, c, s);
  } else {
    err = exact ? mcmctof::launch<false, true>(params, row_stride, col_stride,
                                               edges, t_edges, out, n_walkers,
                                               n_fine, c, s)
                : mcmctof::launch<false, false>(params, row_stride,
                                                col_stride, edges, t_edges,
                                                out, n_walkers, n_fine, c, s);
  }
  return err == cudaSuccess ? 0 : mcmctof::failed(err);
}
