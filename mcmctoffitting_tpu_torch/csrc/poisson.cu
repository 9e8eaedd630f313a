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
// The rates may be given once per walker, (W, C), and drawn for R runs: the
// output is (W, R, C) and element (w, r, c) reads rate (w, c).  The counter
// of a draw is the index of its output element, so the draws equal those of
// the rates copied R times.  A launch may draw a part of a larger array
// (a shard of the walkers): the counter is then the element's index in
// that array, the launch's index plus an offset, and where the part is
// blocks of `block` elements one every `stride` elements (a shard of every
// rung of a tempered ensemble), each block's start in it.  The part then
// draws exactly the larger array's numbers.  The two key words come by value, or from two
// int64 words in device memory read when the kernel runs, so that a launch
// captured in a CUDA graph can be replayed with another seed.
//
// What bounds it on an H100: not bytes (8 bytes per element in and out).
// At the forward model's shape (128 walkers x 4 runs x 514 rates per
// half-step, 263k draws; 43% of the rates below 10, 28% exactly 0, the rest
// up to ~4,700) the first design (one thread per element, each running its
// branch to the end in registers) took 10.4 us against a floor of 0.8 us
// between two dependent kernels: 4.5 us when all rates are small (48 fixed
// inversion rounds, also for a rate of 0), 10.0 us when all are large.  It
// is bound by instruction issue: a warp of PTRS lanes pays for the slow
// acceptance test (four logf of 25 instructions each, a log1pf, three
// divisions) and for a second and third round (a Philox block of 10 rounds
// each) whenever one of its 32 lanes needs them, which is nearly always,
// though three lanes in four are done after the cheap first test.  At 39
// registers six blocks fit an SM, so the 1,028 blocks ran as two waves.
//
// Design:
//   * Inversion lanes stop at the first round whose survival falls below
//     the uniform: the survival only falls, so the count is final there (a
//     rate of 0 stops in the first round).  The draws are unchanged.
//   * PTRS in two phases.  Phase 1, every thread: the first proposal and
//     its cheap acceptance test (no logarithm); the three in four that
//     pass write their draw.  The rest put their element's index on a
//     list in shared memory (one native int32 atomicAdd per warp).  Phase
//     2, the block's first threads, one per listed element: the full
//     rejection loop from round 0, as the first design ran it.  The slow
//     test and the later rounds then run in one or two full warps of a
//     block instead of in all eight at a few lanes each.  A draw depends
//     only on (seed, element, round), not on which thread computes it, so
//     the draws are unchanged.
//   * __launch_bounds__(256, 8): 32 registers, eight blocks an SM, and the
//     half-step's 1,028 blocks are resident at once (held to six blocks it
//     takes 10.3 us).
//   * The rates are read once per walker: the run axis is an index
//     computation (two divisions by multiplication, fast_div.cuh), not a
//     copy of the rates and a kernel of its own before this one.
// Each element is independent; the only synchronisation is the block's
// barrier between the phases.  Measured at the shape above: 8.6-8.8 us
// (10.4 before, 12.4 with the copy it needed), 4.0 of them the first
// phase; all rates 0: 2.7 us (4.5 before); all 1000: 9.4 (10.0).  What is
// left is the PTRS arithmetic of the second phase, on few warps.
//
// Build without --use_fast_math (approximate log/log1p skew the acceptance
// test and bias the sampled variance) and with -fmad=false, so every
// operation rounds as in the plain version.  Constants are written as
// (float)<double literal>, the rounding PyTorch applies to a Python float.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "fast_div.cuh"
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

// The survival s only falls (p >= 0), so at the first round with s < v the
// count is final: stopping there gives the count of all kInvRounds rounds.
__device__ __forceinline__ float small_inversion(float u, float lam) {
  const float v = fmaxf(1.0f - u, F32(1e-5));
  float p = expf(-lam);
  float s = 1.0f;
  float cnt = 0.0f;
#pragma unroll
  for (int i = 0; i < kInvRounds; ++i) {
    s = s - p;
    if (!(s >= v)) break;
    cnt = cnt + 1.0f;
    p = p * lam * F32(1.0 / (i + 1.0));
  }
  return cnt;
}

// The rate-dependent constants of the PTRS proposal and its cheap test.
struct PtrsFast {
  float a, b, vr;
};

__device__ __forceinline__ PtrsFast ptrs_fast_constants(float lam) {
  PtrsFast c;
  c.b = F32(0.931) + F32(2.53) * sqrtf(lam);
  c.a = F32(-0.059) + F32(0.02483) * c.b;
  c.vr = F32(0.9277) - F32(3.6224) * (1.0f / (c.b - 2.0f));
  return c;
}

// One PTRS proposal from the words (x, y) of a Philox block: the candidate
// k and the two numbers its tests read.
struct PtrsProposal {
  float k, us, v;
};

__device__ __forceinline__ PtrsProposal ptrs_propose(uint4 bits, float lam,
                                                     const PtrsFast& c) {
  PtrsProposal q;
  const float u = unit_float(bits.x) - 0.5f;
  q.v = fmaxf(unit_float(bits.y), kTiny);
  q.us = 0.5f - fabsf(u);
  q.k = floorf((2.0f * c.a / fmaxf(q.us, kTiny) + c.b) * u + lam + F32(0.43));
  return q;
}

__device__ __forceinline__ bool ptrs_fast_accept(const PtrsProposal& q,
                                                 const PtrsFast& c) {
  return q.us >= F32(0.07) && q.v <= c.vr;
}

// The full rejection loop of one element with lam >= kSmallCutoff, from
// round 0 (bits0 is its Philox block of round 0).
__device__ float ptrs_draw(float lam, uint4 bits0, uint32_t c_lo,
                           uint32_t c_hi, uint2 key) {
  const PtrsFast c = ptrs_fast_constants(lam);
  const float loglam = logf(lam);
  const float log_invalpha =
      logf(F32(1.1239) + F32(1.1328) * (1.0f / (c.b - F32(3.4))));
  uint4 bits = bits0;
  for (int r = 0; r < kMaxPtrsRounds; ++r) {
    if (r) {
      bits = philox4x32_10(
          make_uint4(c_lo, c_hi, static_cast<uint32_t>(r), 0u), key);
    }
    const PtrsProposal q = ptrs_propose(bits, lam, c);
    if (ptrs_fast_accept(q, c)) return q.k;
    const bool reject = q.k < 0.0f || (q.us < F32(0.013) && q.v > q.us);
    if (!reject) {
      const float log_acc = logf(q.v) + log_invalpha -
                            logf(c.a / fmaxf(q.us * q.us, kTiny) + c.b);
      if (log_acc <= ptrs_log_pmf(q.k, lam, loglam)) return q.k;
    }
  }
  return rintf(lam);
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// Division of an index by a divisor that is fixed for the launch: 32-bit
// indices divide by a multiplication (fast_div.cuh), 64-bit indices (more
// than 2^32 draws in a launch) plainly.
template <typename Index>
struct Divider;

template <>
struct Divider<uint32_t> : FastDiv {
  explicit Divider(unsigned long long divisor)
      : FastDiv(static_cast<uint32_t>(divisor)) {}
};

template <>
struct Divider<unsigned long long> {
  unsigned long long d;
  explicit Divider(unsigned long long divisor) : d(divisor) {}
  __device__ __forceinline__ unsigned long long div(
      unsigned long long n) const {
    return n / d;
  }
};

// Rate of output element i: the rates are (n / (n_rep * row_len), row_len)
// and the output repeats every row n_rep times.
template <typename Index>
__device__ __forceinline__ float load_rate(const float* __restrict__ lam_in,
                                           Index i,
                                           const Divider<Index>& row_len,
                                           const Divider<Index>& n_rep) {
  if (n_rep.d > 1) {
    const Index row = row_len.div(i);
    i = n_rep.div(row) * row_len.d + (i - row * row_len.d);
  }
  const float lam = lam_in[i];
  return lam > 0.0f ? lam : 0.0f;  // NaN and negative rates draw 0
}

// The Philox counter of element i of the launch: its index in the array the
// launch is a part of (see the top of the file).  stride 0: one block.
template <typename Index>
struct CounterMap {
  unsigned long long offset, stride;
  Divider<Index> block;
  __device__ __forceinline__ uint64_t operator()(Index i) const {
    uint64_t c = static_cast<uint64_t>(i);
    if (stride != 0ull) {
      const Index q = block.div(i);
      c = static_cast<uint64_t>(q) * stride + (i - q * block.d);
    }
    return offset + c;
  }
};

template <typename Index>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    poisson_kernel(const float* __restrict__ lam_in, float* __restrict__ out,
                   Index n, const Divider<Index> row_len,
                   const Divider<Index> n_rep,
                   const long long* __restrict__ seed_words, uint32_t seed0,
                   uint32_t seed1, const CounterMap<Index> counter) {
  __shared__ int s_count;
  __shared__ int s_slow[kThreads];     // threads of the block left to phase 2
  __shared__ float s_slow_lam[kThreads];   // and their rates
  const int tid = threadIdx.x;
  if (tid == 0) s_count = 0;
  __syncthreads();

  uint2 key = make_uint2(seed0, seed1);
  if (seed_words != nullptr) {
    key = make_uint2(static_cast<uint32_t>(seed_words[0]),
                     static_cast<uint32_t>(seed_words[1]));
  }
  const Index first = static_cast<Index>(blockIdx.x) * kThreads;

  // phase 1: inversion, or the first PTRS proposal and its cheap test
  const Index i = first + static_cast<Index>(tid);
  bool slow = false;
  float lam = 0.0f;
  if (i < n) {
    lam = load_rate(lam_in, i, row_len, n_rep);
    const uint64_t ctr = counter(i);
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(ctr),
                   static_cast<uint32_t>(ctr >> 32), 0u, 0u), key);
    if (lam < kSmallCutoff) {
      out[i] = small_inversion(unit_float(bits.x), lam);
    } else {
      const PtrsFast c = ptrs_fast_constants(lam);
      const PtrsProposal q = ptrs_propose(bits, lam, c);
      if (ptrs_fast_accept(q, c)) {
        out[i] = q.k;
      } else {
        slow = true;
      }
    }
  }
  const unsigned lane = static_cast<unsigned>(tid) & 31u;
  const unsigned mask = __ballot_sync(0xffffffffu, slow);
  if (mask != 0u) {
    const int leader = __ffs(mask) - 1;
    int at = 0;
    if (static_cast<int>(lane) == leader) {
      at = atomicAdd(&s_count, __popc(mask));
    }
    at = __shfl_sync(0xffffffffu, at, leader);
    if (slow) {
      at += __popc(mask & ((1u << lane) - 1u));
      s_slow[at] = tid;
      s_slow_lam[at] = lam;
    }
  }
  __syncthreads();

  // phase 2: the listed elements, one per thread, the whole loop (dealing
  // them out over more warps at fewer lanes each was slower, 10.1-12.7 us)
  const int n_slow = s_count;
  if (tid < n_slow) {
    const Index j = first + static_cast<Index>(s_slow[tid]);
    const uint64_t ctr = counter(j);
    const uint32_t c_lo = static_cast<uint32_t>(ctr);
    const uint32_t c_hi = static_cast<uint32_t>(ctr >> 32);
    const uint4 bits = philox4x32_10(make_uint4(c_lo, c_hi, 0u, 0u), key);
    out[j] = ptrs_draw(s_slow_lam[tid], bits, c_lo, c_hi, key);
  }
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

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace mcmctof

// lam: (n / (n_rep * row_len), row_len) rates; out: n draws, every row of
// rates drawn n_rep times (n_rep = 1: lam has n elements, row_len is not
// read).  seed_words: two int64 words in device memory holding the 32-bit
// key words, or null for the key (seed0, seed1).  offset, block, stride:
// the Philox counter of output element i is offset + i, or with stride > 0
// offset + (i / block) * stride + i % block (block <= stride).
extern "C" int mcmctof_poisson(const float* lam, float* out, long long n,
                               long long row_len, long long n_rep,
                               const long long* seed_words, uint32_t seed0,
                               uint32_t seed1, unsigned long long offset,
                               long long block, unsigned long long stride,
                               int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (n <= 0) return 0;
  if (n_rep < 1 || (n_rep > 1 && (row_len < 1 || n % (n_rep * row_len)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (stride != 0ull &&
      (block < 1 || stride < static_cast<unsigned long long>(block))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rep == 1) row_len = 1;   // not read
  if (stride == 0ull) block = 1;  // not read
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = mcmctof::blocks_for(n);
  if (n <= 0xffffffffll - mcmctof::kThreads) {
    using Div = mcmctof::Divider<uint32_t>;
    const mcmctof::CounterMap<uint32_t> counter{offset, stride, Div(block)};
    mcmctof::poisson_kernel<uint32_t><<<blocks, mcmctof::kThreads, 0, s>>>(
        lam, out, static_cast<uint32_t>(n), Div(row_len), Div(n_rep),
        seed_words, seed0, seed1, counter);
  } else {
    using Div = mcmctof::Divider<unsigned long long>;
    const mcmctof::CounterMap<unsigned long long> counter{offset, stride,
                                                          Div(block)};
    mcmctof::poisson_kernel<unsigned long long>
        <<<blocks, mcmctof::kThreads, 0, s>>>(
            lam, out, static_cast<unsigned long long>(n), Div(row_len),
            Div(n_rep), seed_words, seed0, seed1, counter);
  }
  return static_cast<int>(cudaGetLastError());
}

// Philox4x32-10 on given (counter, key) words: the known-answer check of
// the generator the Poisson kernel uses.
extern "C" int mcmctof_philox(const uint32_t* in, uint32_t* out,
                              long long n, int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (n > 0) {
    mcmctof::philox_kernel<<<mcmctof::blocks_for(n), mcmctof::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(in, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mcmctof_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
