// Kernel K1: exact Poisson draws for the counts-mode forward model.
//
// Replaces the TPU kernel mcmctoffitting_tpu/ops/pallas_poisson.py::
// _poisson_kernel (pl.pallas_call at :178).  Plain PyTorch version, same
// random stream and same formulas: mcmctoffitting_tpu_torch/ops/poisson.py::
// poisson_ptrs.  Wrapper and dispatch: ops/cuda_poisson.py::poisson.
//
// What it computes, per element of a float32 rate array:
//   lam < 10   CDF inversion over 48 fixed rounds from one uniform, the
//              survival accumulated downward, v = max(1 - u, 1e-5);
//   lam >= 10  Hormann's PTRS transformed rejection, at most 64 rounds
//              (break on acceptance), then rint(lam); the slow-accept test
//              uses the cancellation-free log-pmf with the in-place log1p
//              series for |t| <= 1/16 and the shifted-Stirling gammaln.
// Random bits: Philox4x32-10, key = the two seed words of the launch,
// counter = (element index lo, hi, round, 0); inversion lanes use word 0 of
// round 0, PTRS round r uses words 0 (u) and 1 (v).
//
// What bounds it on an H100: not bytes (8 bytes per element in and out).
// At the forward model's shape (walkers x runs x (F + 2) ~ 263k rates per
// half-step) it is bound by latency and launch cost: one thread per element,
// a few hundred dependent instructions each (10 Philox rounds per draw,
// log/exp/log1p, up to 48 inversion rounds), and divergence between the
// inversion and PTRS lanes of a warp.  The design keeps everything in
// registers and each element independent, so the card's occupancy hides
// the latency; there is no shared memory and no synchronisation.
//
// Build without --use_fast_math (approximate log/log1p skew the acceptance
// test and bias the sampled variance) and with -fmad=false, so every
// operation rounds as in the plain version.  Constants are written as
// (float)<double literal>, the rounding PyTorch applies to a Python float.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace mcmctof {
namespace {

#define F32(x) static_cast<float>(x)

constexpr float kSmallCutoff = 10.0f;
constexpr int kInvRounds = 48;
constexpr int kMaxPtrsRounds = 64;
constexpr float kTiny = 1.17549435e-38f;  // float32 tiny

__device__ __forceinline__ float gammaln_stirling(float x) {
  const float xs = fminf(x, 8.0f);
  const float z = x < 8.0f ? x + 8.0f : x;
  const float zi = 1.0f / z;
  const float s = (z - 0.5f) * logf(z) - z + F32(0.9189385332046727) +
                  zi * (F32(1.0 / 12.0) - zi * zi * F32(1.0 / 360.0));
  const float prod = xs * (xs + 1.0f) * (xs + 2.0f) * (xs + 3.0f) *
                     (xs + 4.0f) * (xs + 5.0f) * (xs + 6.0f) * (xs + 7.0f);
  return x < 8.0f ? s - logf(prod) : s;
}

__device__ __forceinline__ float ptrs_log_pmf(float k, float lam,
                                              float loglam) {
  const float d = k - lam;
  const float kk = fmaxf(k, 1.0f);
  const float t = k >= 8.0f ? d / lam : 0.0f;
  const float r =
      t * t *
      (F32(-1.0 / 2.0) +
       t * (F32(1.0 / 3.0) +
            t * (F32(-1.0 / 4.0) +
                 t * (F32(1.0 / 5.0) +
                      t * (F32(-1.0 / 6.0) + t * F32(1.0 / 7.0))))));
  const float core =
      fabsf(t) <= 0.0625f ? -(d * d) / lam - k * r : d - k * log1pf(t);
  if (k >= 8.0f) {
    return core - 0.5f * logf(F32(6.283185307179586) * kk) -
           (F32(1.0 / 12.0) - F32(1.0 / 360.0) * (1.0f / (kk * kk))) / kk;
  }
  return k * loglam - lam - gammaln_stirling(k + 1.0f);
}

__device__ __forceinline__ float small_inversion(float u, float lam) {
  const float v = fmaxf(1.0f - u, F32(1e-5));
  float p = expf(-lam);
  float s = 1.0f;
  float cnt = 0.0f;
#pragma unroll
  for (int i = 0; i < kInvRounds; ++i) {
    s = s - p;
    cnt = cnt + (s >= v ? 1.0f : 0.0f);
    p = p * lam * F32(1.0 / (i + 1.0));
  }
  return cnt;
}

__global__ void poisson_kernel(const float* __restrict__ lam_in,
                               float* __restrict__ out, long long n,
                               uint32_t seed0, uint32_t seed1) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float lam = lam_in[i];
  lam = lam > 0.0f ? lam : 0.0f;  // NaN and negative rates draw 0
  const uint2 key = make_uint2(seed0, seed1);
  const uint32_t c_lo = static_cast<uint32_t>(i);
  const uint32_t c_hi = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);

  uint4 bits = philox4x32_10(make_uint4(c_lo, c_hi, 0u, 0u), key);
  if (lam < kSmallCutoff) {
    out[i] = small_inversion(unit_float(bits.x), lam);
    return;
  }

  const float slam = sqrtf(lam);
  const float loglam = logf(lam);
  const float b = F32(0.931) + F32(2.53) * slam;
  const float a = F32(-0.059) + F32(0.02483) * b;
  const float log_invalpha =
      logf(F32(1.1239) + F32(1.1328) * (1.0f / (b - F32(3.4))));
  const float vr = F32(0.9277) - F32(3.6224) * (1.0f / (b - 2.0f));

  for (int r = 0; r < kMaxPtrsRounds; ++r) {
    if (r) {
      bits = philox4x32_10(
          make_uint4(c_lo, c_hi, static_cast<uint32_t>(r), 0u), key);
    }
    const float u = unit_float(bits.x) - 0.5f;
    const float v = fmaxf(unit_float(bits.y), kTiny);
    const float us = 0.5f - fabsf(u);
    const float k =
        floorf((2.0f * a / fmaxf(us, kTiny) + b) * u + lam + F32(0.43));
    const bool fast = us >= F32(0.07) && v <= vr;
    const bool reject = k < 0.0f || (us < F32(0.013) && v > us);
    if (fast) {
      out[i] = k;
      return;
    }
    if (!reject) {
      const float log_acc =
          logf(v) + log_invalpha - logf(a / fmaxf(us * us, kTiny) + b);
      if (log_acc <= ptrs_log_pmf(k, lam, loglam)) {
        out[i] = k;
        return;
      }
    }
  }
  out[i] = rintf(lam);
}

__global__ void philox_kernel(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* w = in + 6 * i;
  const uint4 r = philox4x32_10(make_uint4(w[0], w[1], w[2], w[3]),
                                make_uint2(w[4], w[5]));
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace mcmctof

extern "C" int mcmctof_poisson(const float* lam, float* out, long long n,
                               uint32_t seed0, uint32_t seed1, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mcmctof::poisson_kernel<<<mcmctof::blocks_for(n), mcmctof::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        lam, out, n, seed0, seed1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Philox4x32-10 on given (counter, key) words: the known-answer check of
// the generator the Poisson kernel uses.
extern "C" int mcmctof_philox(const uint32_t* in, uint32_t* out,
                              long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mcmctof::philox_kernel<<<mcmctof::blocks_for(n), mcmctof::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(in, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mcmctof_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
