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
// so the bins, agree bit for bit (CUDA's logf on both sides on the card).
// The clamp keeps NaN, as torch.clamp_min does.  The optional e_out
// receives the transported energies (rows, M, N) for checks.
//
// What bounds it on an H100: instruction issue.  (The roofline, which
// counts logf and the division as one operation each at 67e12/s, is
// 0.92 ms.)  In the SASS (sm_90a, read by perf/kernel_split.py) one RK4
// substep is ~187 instructions per sample: four dE/dx, each a logf (25
// instructions in a chain, no MUFU) and an IEEE division (9: MUFU.RCP,
// FCHK, five FFMA and a branch around the slow path), plus the RK4 sums.
// With the binning, ~236 instructions run per (sample, depth): at 512
// rows x 200k samples x 10 depths that is ~2.4e11 lane-instructions,
// ~7.2 ms at one warp-instruction per scheduler per cycle on 132 SMs at
// 1.98 GHz.  The previous design (a float32 histogram per warp) took
// 23.3 ms: its float32 shared-memory atomicAdds compile to LDS + FADD +
// ATOMS.CAST.SPIN retry loops, and four of them per (sample, depth) cost
// more than the transport (perf/kernel_split.py on an H100: histogram
// removed 7.6 ms, transport removed 17.4 ms).
//
// The design, against that:
// - the histogram holds integers and is updated with native 32-bit
//   shared atomics (ATOMS.ADD, no retry loop): the count channel counts,
//   and d, d^2, d^3 are fixed point, rounded to the nearest multiple of
//   2^-14, 2^-15, 2^-16 (each |value x scale| <= 2^13).  A block adds at
//   most kTmWindow = 2^17 samples to a copy before it flushes, so a copy's
//   sum stays below 2^30 in magnitude.  Integer sums do not depend on the
//   order of the atomics; the error against the float sum is at most half
//   a fixed-point step per sample (<= 2^-15 absolute), far inside the
//   kernel's gate of 1e-5 of the row total;
// - two histogram copies per block (16 KB at M = 10, Be = 50) instead of
//   eight, so that the registers, not shared memory, set the occupancy;
// - each thread carries kTmSamples = 2 independent samples through the
//   depths together, so the scheduler has a second dependency chain;
// - a persistent grid: as many blocks as fit on the card at once, each
//   owning one contiguous range of the (row, sample) space, equal in
//   size, so there is no tail wave.  A block flushes its copies when its
//   range leaves a row or fills a window: each cell's exact sum is added
//   to an int64 workspace (rows, M, 4, Be) with a 64-bit integer atomic
//   (two's complement makes the signed sums exact; integer addition does
//   not depend on order), and a second small kernel then writes the
//   float32 output once: sum x step in float64, rounded once.  The output
//   is the same bits on every call, whatever the blocks' order.  Bound:
//   each per-sample term is at most 2^13 in magnitude and a row has at
//   most 2^31 samples (the wrapper checks), so a cell stays below 2^44:
//   no int64 overflow, and exact in float64 before the one rounding.
// It runs in 8.5 ms at (512, 200k) on an H100 80GB HBM3 (PERF.md), ~85%
// of the issue rate above; the division's branch and the binning's ~50
// instructions per (sample, depth) are what is left to cut.
//
// Many depths (the templates' M = 100, Be = 150: one copy of the whole
// histogram would be 240,000 B, above the 200 KiB a block may take): the
// depths go in tiles of mcmctof_transport_moments_tile() spans, one tile's
// copies (2 x 24 KB at most) in shared memory at a time.  Each block walks
// its sample range once per tile, in the same launch: it integrates the
// tile's spans, bins them, flushes the tile's copies into the tile's part
// of the workspace and stores every sample's energy at the tile's last
// depth in a (rows, N) float32 carry buffer, from which the next tile
// starts.  The thread that stores an energy is the thread that loads it
// again, so no synchronisation is needed, and no RK4 step is done twice;
// the carry costs 8 bytes per sample and tile.  The fixed point, its
// window and the flush are those of the one-tile kernel, which is the
// instance kTiled = false: a copy still takes at most 2^17 samples
// between flushes, each adding at most 2^13 to a cell, so every shared
// cell stays below 2^30 at any shape.  At the templates' (128, 200k),
// M = 100, Be = 150, 4 substeps, it runs in 73.3 ms on an H100 80GB HBM3
// at 700 W (chip_smoke.py phase 20a), 73% of its instruction-issue
// floor's rate.

#include <cuda_runtime.h>

#include <algorithm>

#include "device_guard.cuh"

namespace mcmctof {
namespace {

constexpr int kTmThreads = 256;
constexpr int kTmSamples = 2;        // independent samples per thread
constexpr int kTmMaxCopies = 2;      // histogram copies per block
constexpr int kTmMaxSpans = 64;      // spans of one launch, or of a tile
constexpr int kTmSmemLimit = 200 * 1024;
constexpr int kTmTileBytes = 24 * 1024;   // one histogram copy of a tile
constexpr long long kTmWindow = 1LL << 17;   // samples per flush
// fixed-point scales of the d, d^2, d^3 channels (the count counts)
constexpr float kTmScaleD1 = 16384.0f;
constexpr float kTmScaleD2 = 32768.0f;
constexpr float kTmScaleD3 = 65536.0f;

struct TmParams {
  float a, p, q, floor_e, lo, hi, inv_width;
  int n_x, n_sub, n_bins, n_copies;
  int tile;   // spans per tile (n_x with one tile)
};

__device__ __forceinline__ float clamp_floor(float e, float f) {
  return e < f ? f : e;  // NaN stays NaN, as torch.clamp_min
}

__device__ __forceinline__ float dedx(float e, const TmParams& c) {
  e = clamp_floor(e, c.floor_e);
  const float l = logf(e);
  return -(c.a / e) * (c.q * l + c.p);
}

// Add the first n_cells sums of every copy (copies per_copy apart) into
// the row's int64 workspace, and zero them.
__device__ void flush(int* hist, unsigned long long* row_acc, int per_copy,
                      int n_cells, const TmParams& c) {
  __syncthreads();
  for (int j = threadIdx.x; j < n_cells; j += blockDim.x) {
    long long sum = 0;
    for (int k = 0; k < c.n_copies; ++k) {
      sum += hist[k * per_copy + j];
      hist[k * per_copy + j] = 0;
    }
    if (sum != 0)
      atomicAdd(row_acc + j, static_cast<unsigned long long>(sum));
  }
  __syncthreads();
}

// The float32 output from the int64 workspace: sum x step in float64 (the
// sum is below 2^44, so exact), rounded once.  The steps are powers of
// two: 1 for the counts, 2^-14, 2^-15, 2^-16 for d, d^2, d^3.
__global__ void fixed_point_to_float(const long long* __restrict__ acc,
                                     float* __restrict__ out,
                                     long long n_cells, int n_bins) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < n_cells; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>((j / n_bins) & 3);
    const double step = ch == 0   ? 1.0
                        : ch == 1 ? 1.0 / kTmScaleD1
                        : ch == 2 ? 1.0 / kTmScaleD2
                                  : 1.0 / kTmScaleD3;
    out[j] = static_cast<float>(static_cast<double>(acc[j]) * step);
  }
}

// kTiled = false: every span in one tile (n_x <= kTmMaxSpans), carry
// unused.  kTiled = true: tiles of c.tile spans, the energies carried
// between them in carry (rows, N).
template <bool kTiled>
__global__ void __launch_bounds__(kTmThreads)
transport_moments_kernel(const float* __restrict__ e0,
                         const float* __restrict__ steps,
                         unsigned long long* __restrict__ acc,
                         float* __restrict__ e_out,
                         float* __restrict__ carry, long long n_rows,
                         long long n, TmParams c) {
  extern __shared__ int hist[];
  __shared__ float s_h[kTmMaxSpans], s_half[kTmMaxSpans], s_sixth[kTmMaxSpans];
  const int per_span = 4 * c.n_bins;
  const int per_copy = c.tile * per_span;
  for (int j = threadIdx.x; j < per_copy * c.n_copies; j += blockDim.x)
    hist[j] = 0;
  if (!kTiled) {
    for (int j = threadIdx.x; j < c.n_x; j += blockDim.x) {
      s_h[j] = steps[j];
      s_half[j] = steps[c.n_x + j];
      s_sixth[j] = steps[2 * c.n_x + j];
    }
  }
  __syncthreads();

  int* my_hist = hist + ((threadIdx.x >> 5) % c.n_copies) * per_copy;
  const int n_tiles = kTiled ? (c.n_x + c.tile - 1) / c.tile : 1;
  const long long total = n_rows * n;
  const long long stop = total * (blockIdx.x + 1) / gridDim.x;
  for (long long g = total * blockIdx.x / gridDim.x; g < stop;) {
    // one segment: within one row and one window
    const long long row = g / n;
    const long long seg_end = min(stop, min((row + 1) * n, g + kTmWindow));
    const float* row_e0 = e0 + row * n;
    float* row_carry = kTiled ? carry + row * n : nullptr;
    const long long i_end = seg_end - row * n;
    for (int t = 0; t < n_tiles; ++t) {
      const int m0 = kTiled ? t * c.tile : 0;
      const int m1 = kTiled ? min(c.n_x, m0 + c.tile) : c.n_x;
      if (kTiled) {
        // the tile's steps; the flush before ended with a barrier, so no
        // thread still reads the previous tile's
        for (int j = threadIdx.x; j < m1 - m0; j += blockDim.x) {
          s_h[j] = steps[m0 + j];
          s_half[j] = steps[c.n_x + m0 + j];
          s_sixth[j] = steps[2 * c.n_x + m0 + j];
        }
        __syncthreads();
      }
      const float* src = (kTiled && t > 0) ? row_carry : row_e0;
      for (long long base = g - row * n; base < i_end;
           base += kTmThreads * kTmSamples) {
        float e[kTmSamples];
        bool ok[kTmSamples];
#pragma unroll
        for (int k = 0; k < kTmSamples; ++k) {
          const long long i = base + k * kTmThreads + threadIdx.x;
          ok[k] = i < i_end;
          e[k] = ok[k] ? src[i] : 0.0f;   // a lane past the end: frozen
        }
        for (int m = m0; m < m1; ++m) {
          const float h = s_h[m - m0], half_h = s_half[m - m0],
                      sixth_h = s_sixth[m - m0];
          for (int s = 0; s < c.n_sub; ++s) {
            float k1[kTmSamples], k2[kTmSamples], k3[kTmSamples],
                k4[kTmSamples];
#pragma unroll
            for (int k = 0; k < kTmSamples; ++k) k1[k] = dedx(e[k], c);
#pragma unroll
            for (int k = 0; k < kTmSamples; ++k)
              k2[k] = dedx(e[k] + half_h * k1[k], c);
#pragma unroll
            for (int k = 0; k < kTmSamples; ++k)
              k3[k] = dedx(e[k] + half_h * k2[k], c);
#pragma unroll
            for (int k = 0; k < kTmSamples; ++k)
              k4[k] = dedx(e[k] + h * k3[k], c);
#pragma unroll
            for (int k = 0; k < kTmSamples; ++k) {
              const float step =
                  ((k1[k] + 2.0f * k2[k]) + 2.0f * k3[k]) + k4[k];
              const float e_new =
                  clamp_floor(e[k] + sixth_h * step, c.floor_e);
              e[k] = e[k] <= c.floor_e ? e[k] : e_new;
            }
          }
#pragma unroll
          for (int k = 0; k < kTmSamples; ++k) {
            if (!ok[k]) continue;
            if (e_out != nullptr)
              e_out[(row * c.n_x + m) * n + base + k * kTmThreads +
                    threadIdx.x] = e[k];
            if (e[k] >= c.lo && e[k] <= c.hi) {
              const float u = (e[k] - c.lo) * c.inv_width;
              int idx = static_cast<int>(floorf(u));
              idx = min(max(idx, 0), c.n_bins - 1);
              const float d = (u - static_cast<float>(idx)) - 0.5f;
              const float d2 = d * d;
              int* cell = my_hist + (m - m0) * per_span + idx;
              atomicAdd(cell, 1);
              atomicAdd(cell + c.n_bins, __float2int_rn(d * kTmScaleD1));
              atomicAdd(cell + 2 * c.n_bins,
                        __float2int_rn(d2 * kTmScaleD2));
              atomicAdd(cell + 3 * c.n_bins,
                        __float2int_rn((d2 * d) * kTmScaleD3));
            }
          }
        }
        if (kTiled && t + 1 < n_tiles) {
          // the energies at the tile's last depth, for the next tile
#pragma unroll
          for (int k = 0; k < kTmSamples; ++k)
            if (ok[k]) row_carry[base + k * kTmThreads + threadIdx.x] = e[k];
        }
      }
      flush(hist, acc + (row * c.n_x + m0) * per_span, per_copy,
            (m1 - m0) * per_span, c);
    }
    g = seg_end;
  }
}

// Spans per tile at (n_x, n_bins): n_x where one launch holds every span
// (the one-tile kernel), fewer where it cannot, 0 where not even one span
// fits in shared memory.
int tile_spans(int n_x, int n_bins) {
  const size_t span_bytes = static_cast<size_t>(4) * n_bins * sizeof(int);
  if (span_bytes > static_cast<size_t>(kTmSmemLimit)) return 0;
  if (n_x <= kTmMaxSpans &&
      span_bytes * n_x <= static_cast<size_t>(kTmSmemLimit))
    return n_x;
  const int fit = static_cast<int>(
      std::max<size_t>(1, kTmTileBytes / span_bytes));
  return std::min(std::min(fit, kTmMaxSpans), n_x);
}

template <bool kTiled>
int launch(const float* e0, const float* steps, long long* acc, float* out,
           float* e_out, float* carry, int n_rows, long long n, TmParams c,
           int device, cudaStream_t stream) {
  const size_t per_copy =
      static_cast<size_t>(c.tile) * 4 * c.n_bins * sizeof(int);
  c.n_copies = std::min(static_cast<int>(kTmSmemLimit / per_copy),
                        kTmMaxCopies);
  const size_t smem = per_copy * c.n_copies;
  const long long total = static_cast<long long>(n_rows) * n;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(transport_moments_kernel<kTiled>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // persistent grid: the blocks that fit on the card at once, no more
  // than there are rounds of samples
  int per_sm = 0, n_sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, transport_moments_kernel<kTiled>, kTmThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_round = kTmThreads * kTmSamples;
  const long long blocks =
      std::min(static_cast<long long>(std::max(per_sm, 1)) * n_sms,
               (total + per_round - 1) / per_round);
  transport_moments_kernel<kTiled>
      <<<static_cast<int>(blocks), kTmThreads, smem, stream>>>(
          e0, steps, reinterpret_cast<unsigned long long*>(acc), e_out,
          carry, n_rows, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_cells =
      static_cast<long long>(n_rows) * c.n_x * 4 * c.n_bins;
  const long long conv_blocks =
      std::min<long long>((n_cells + kTmThreads - 1) / kTmThreads,
                          static_cast<long long>(n_sms) * 16);
  fixed_point_to_float<<<static_cast<int>(conv_blocks), kTmThreads, 0,
                         stream>>>(acc, out, n_cells, c.n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mcmctof

// Spans per tile for (n_x, n_bins): n_x when one tile holds them all, 0
// when the kernel cannot take the shape.
extern "C" int mcmctof_transport_moments_tile(int n_x, int n_bins) {
  if (n_x < 1 || n_bins < 1) return 0;
  return mcmctof::tile_spans(n_x, n_bins);
}

// steps: device float32 (3, n_x) = (h, h/2, h/6) per x interval.
// acc: int64 (n_rows, n_x, 4, n_bins) workspace, zeroed by the caller;
// out: float32 of the same shape, every cell written.  carry: float32
// (n_rows, n) scratch, needed (non-null) when
// mcmctof_transport_moments_tile(n_x, n_bins) < n_x, else unused.  n must
// be below 2^31 (the bound of the int64 sums).
extern "C" int mcmctof_transport_moments(
    const float* e0, const float* steps, long long* acc, float* out,
    float* e_out, float* carry, int n_rows, long long n, int n_x, int n_sub,
    int n_bins, float a, float p, float q, float floor_e, float lo, float hi,
    float inv_width, int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = n_x < 1 || n_bins < 1 || n_sub < 1
                       ? 0 : mcmctof::tile_spans(n_x, n_bins);
  if (tile < 1 || (tile < n_x && carry == nullptr) || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n_rows) * n;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  mcmctof::TmParams c{a, p, q, floor_e, lo, hi, inv_width,
                      n_x, n_sub, n_bins, 0, tile};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == n_x)
    return mcmctof::launch<false>(e0, steps, acc, out, e_out, nullptr,
                                  n_rows, n, c, device, s);
  return mcmctof::launch<true>(e0, steps, acc, out, e_out, carry, n_rows, n,
                               c, device, s);
}
