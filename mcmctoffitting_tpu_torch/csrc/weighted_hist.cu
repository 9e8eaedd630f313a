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
// matrix unit belongs to the TPU) and are summed in float64, as the plain
// version sums them: a bin of the 'exact' path sums up to 200k weights,
// where a float32 sum in an arbitrary order drifts by ~1e-5 of the row
// total between runs.
//
// What bounds it on an H100: bytes.  Every value and weight is read once
// and used for a handful of operations: one 'exact' chunk (670 rows x
// 200k) is 1.07 GB, 0.32 ms at 3.35 TB/s.  The previous design (a float64
// histogram per warp) took 0.76 ms (perf/kernel_split.py):
// its float64 shared-memory atomicAdd compiles to LDS.64 + DADD +
// ATOMS.CAST.SPIN.64, a retry loop that serialises the lanes of a warp
// that hit one bin (the energies of one row crowd into a few 20 keV
// bins), and 670 one-row blocks made 1.3 waves on the card.
//
// The design, against that:
// - no atomics: every thread keeps a private float64 histogram in shared
//   memory (bin j of thread t at [j * blockDim + t], so a warp's lanes
//   fall on distinct banks whatever bins they hit) and adds to it with a
//   plain load, add, store;
// - 16-byte loads of values and weights (four entries per thread and
//   load, kWhUnroll loads of each in flight), when the rows are 16-byte
//   aligned, else four 4-byte loads;
// - a persistent grid: as many blocks as fit on the card at once, each
//   owning one contiguous range of the (row, quad) space, equal in size.
//   When its range leaves a row, a block sums its threads' histograms in
//   a fixed order (float64).  A row inside one block's range is written
//   at once; a row split between blocks leaves each block's float64 sum
//   in a slot of a small workspace (two slots per block), and a second
//   kernel adds the slots of each such row in block order and writes the
//   row.  The sums are thus in a fixed order: the result is the same on
//   every call, and rounds to float32 once, as the plain version does.
// The private histograms take n_bins x 8 bytes per thread: the block has
// min(128, 200 KB / (n_bins x 8 bytes)) threads, a multiple of 32, so the
// kernel takes at most kWhMaxBins = 800 bins; mcmctof_weighted_hist_max_bins
// tells the wrapper, and mcmctof_weighted_hist_blocks how large a
// workspace to give.  It runs in 0.48 ms per (670, 200k) chunk on an H100
// 80GB HBM3, ~66% of the bytes bound (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>

#include "device_guard.cuh"

namespace mcmctof {
namespace {

constexpr int kWhMaxThreads = 128;
constexpr int kWhMinThreads = 32;
constexpr int kWhUnroll = 4;
constexpr int kWhSmemLimit = 200 * 1024;
constexpr int kWhMaxBins = kWhSmemLimit / (kWhMinThreads * sizeof(double));

struct WhParams {
  long long row_len, n_valid, n_quads;   // quads of 4 entries per row
  float lo, hi, scale;
  int n_bins;
};

// Block b of n_blocks owns the quads [range_start(b), range_start(b + 1))
// of the total.  With at least one quad per block no range is empty.
__device__ __forceinline__ long long range_start(long long total,
                                                 long long b,
                                                 long long n_blocks) {
  return total * b / n_blocks;
}

// The block whose range holds quad x.
__device__ long long owner(long long x, long long total, long long n_blocks) {
  long long b = x * n_blocks / total;    // range_start(b) <= x
  while (b + 1 < n_blocks && range_start(total, b + 1, n_blocks) <= x) ++b;
  return b;
}

__device__ __forceinline__ void add(double* mine, float v, float w,
                                    const WhParams& c) {
  if (v >= c.lo && v <= c.hi) {
    int idx = static_cast<int>(floorf((v - c.lo) * c.scale));
    idx = min(max(idx, 0), c.n_bins - 1);
    mine[idx * blockDim.x] += static_cast<double>(w);
  }
}

// Sum the threads' histograms of one row segment in a fixed order, zero
// them, and write the sums: as the row's output (float32) when `part` is
// null, else into the block's workspace slot `part` (float64).
__device__ void flush(double* hist, float* row_out, double* part,
                      int n_bins) {
  __syncthreads();
  const int n_threads = blockDim.x;
  for (int j = threadIdx.x; j < n_bins; j += n_threads) {
    double sum = 0.0;
    for (int t = 0; t < n_threads; ++t) {
      sum += hist[j * n_threads + t];
      hist[j * n_threads + t] = 0.0;
    }
    if (part != nullptr)
      part[j] = sum;
    else
      row_out[j] = static_cast<float>(sum);
  }
  __syncthreads();
}

template <bool kVector>
__global__ void __launch_bounds__(kWhMaxThreads)
weighted_hist_kernel(const float* __restrict__ values,
                     const float* __restrict__ weights,
                     float* __restrict__ out, double* __restrict__ parts,
                     long long n_rows, WhParams c) {
  extern __shared__ double hist[];
  for (int j = threadIdx.x; j < c.n_bins * blockDim.x; j += blockDim.x)
    hist[j] = 0.0;
  __syncthreads();

  double* mine = hist + threadIdx.x;
  const long long total = n_rows * c.n_quads;
  const long long start = range_start(total, blockIdx.x, gridDim.x);
  const long long stop = range_start(total, blockIdx.x + 1, gridDim.x);
  for (long long g = start; g < stop;) {
    const long long row = g / c.n_quads;
    const long long seg_end = min(stop, (row + 1) * c.n_quads);
    const float* v_row = values + row * c.row_len;
    const float* w_row = weights + row * c.row_len;
    const long long q_end = seg_end - row * c.n_quads;
    for (long long q = g - row * c.n_quads + threadIdx.x; q < q_end;
         q += static_cast<long long>(blockDim.x) * kWhUnroll) {
      float v[kWhUnroll][4], w[kWhUnroll][4];
#pragma unroll
      for (int u = 0; u < kWhUnroll; ++u) {
        const long long qq = q + static_cast<long long>(u) * blockDim.x;
        const long long i = qq * 4;
        if (kVector && qq < q_end && i + 4 <= c.n_valid) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(v_row + i));
          const float4 b = __ldg(reinterpret_cast<const float4*>(w_row + i));
          v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
          w[u][0] = b.x; w[u][1] = b.y; w[u][2] = b.z; w[u][3] = b.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // past the range or the valid length: a value that no bin takes
            const bool ok = qq < q_end && i + k < c.n_valid;
            v[u][k] = ok ? v_row[i + k] : c.lo - 1.0f;
            w[u][k] = ok ? w_row[i + k] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kWhUnroll; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) add(mine, v[u][k], w[u][k], c);
    }
    // a split row's segment is this block's first (slot 0) or last (1)
    const bool whole =
        g == row * c.n_quads && seg_end == (row + 1) * c.n_quads;
    double* part = whole ? nullptr
                         : parts + (2LL * blockIdx.x + (g == start ? 0 : 1)) *
                                       c.n_bins;
    flush(hist, out + row * c.n_bins, part, c.n_bins);
    g = seg_end;
  }
}

// One thread per (row, bin) of the rows split between blocks: the blocks'
// float64 sums in block order, rounded to float32 once.
__global__ void combine_kernel(const double* __restrict__ parts,
                               float* __restrict__ out, long long n_rows,
                               long long n_blocks, WhParams c) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n_rows * c.n_bins) return;
  const long long row = t / c.n_bins;
  const int j = static_cast<int>(t % c.n_bins);
  const long long total = n_rows * c.n_quads;
  const long long first = row * c.n_quads;
  const long long b0 = owner(first, total, n_blocks);
  const long long b1 = owner(first + c.n_quads - 1, total, n_blocks);
  if (b0 == b1) return;                  // written by its block
  double sum = 0.0;
  for (long long b = b0; b <= b1; ++b) {
    const int slot = range_start(total, b, n_blocks) >= first ? 0 : 1;
    sum += parts[(2 * b + slot) * c.n_bins + j];
  }
  out[row * c.n_bins + j] = static_cast<float>(sum);
}

struct WhGrid {
  int threads;
  size_t smem;
  long long blocks;
};

template <bool kVector>
cudaError_t blocks_per_sm(const WhGrid& g, int* per_sm) {
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        weighted_hist_kernel<kVector>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, weighted_hist_kernel<kVector>, g.threads, g.smem);
}

// The block size, shared memory and persistent grid for `total` quads in
// n_bins bins: as many blocks as fit on the card at once (the fewer of
// the two versions of the kernel), and no more than one per `threads`
// quads, so that no block's range is empty.
cudaError_t plan(long long total, int n_bins, int device, WhGrid* g) {
  g->threads = std::min(
      kWhMaxThreads,
      static_cast<int>(kWhSmemLimit / (n_bins * sizeof(double))) / 32 * 32);
  if (g->threads < kWhMinThreads) return cudaErrorInvalidValue;
  g->smem = static_cast<size_t>(n_bins) * g->threads * sizeof(double);
  int per_sm_scalar = 0, per_sm_vector = 0, n_sms = 0;
  cudaError_t err = blocks_per_sm<false>(*g, &per_sm_scalar);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm<true>(*g, &per_sm_vector);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  const int per_sm = std::max(std::min(per_sm_scalar, per_sm_vector), 1);
  g->blocks = std::min(static_cast<long long>(per_sm) * n_sms,
                       (total + g->threads - 1) / g->threads);
  return cudaSuccess;
}

cudaError_t check_sizes(int n_rows, long long row_len, long long n_valid,
                        int n_bins) {
  if (n_rows < 0 || n_bins < 1 || n_bins > kWhMaxBins || n_valid < 0 ||
      n_valid > row_len)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
}  // namespace mcmctof

// The most bins mcmctof_weighted_hist takes.
extern "C" int mcmctof_weighted_hist_max_bins() { return mcmctof::kWhMaxBins; }

// The number of blocks mcmctof_weighted_hist launches for these sizes:
// when it is more than one, the call needs a float64 workspace of
// 2 x blocks x n_bins, for the sums of the rows that blocks share.
extern "C" int mcmctof_weighted_hist_blocks(int n_rows, long long n_valid,
                                            int n_bins, int device,
                                            long long* blocks) {
  mcmctof::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = mcmctof::check_sizes(n_rows, n_valid, n_valid, n_bins);
  if (err != cudaSuccess) return static_cast<int>(err);
  mcmctof::WhGrid g{};
  const long long total = static_cast<long long>(n_rows) * ((n_valid + 3) / 4);
  if (total == 0) {
    *blocks = 0;
    return static_cast<int>(cudaSuccess);
  }
  err = mcmctof::plan(total, n_bins, device, &g);
  *blocks = g.blocks;
  return static_cast<int>(err);
}

// parts: the workspace for `blocks` blocks, the number that
// mcmctof_weighted_hist_blocks gives (null when it is one).  Rows with
// n_valid == 0 are left as they are: out must be zeroed by the caller.
extern "C" int mcmctof_weighted_hist(const float* values,
                                     const float* weights, float* out,
                                     double* parts, long long blocks,
                                     int n_rows, long long row_len,
                                     long long n_valid, float lo, float hi,
                                     float scale, int n_bins, int device,
                                     void* stream) {
  mcmctof::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = mcmctof::check_sizes(n_rows, row_len, n_valid, n_bins);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0 || n_valid == 0) return static_cast<int>(cudaGetLastError());
  const mcmctof::WhParams c{row_len, n_valid, (n_valid + 3) / 4,
                            lo, hi, scale, n_bins};
  mcmctof::WhGrid g{};
  err = mcmctof::plan(n_rows * c.n_quads, n_bins, device, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks != g.blocks || (blocks > 1 && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vector = row_len % 4 == 0 &&
                      reinterpret_cast<size_t>(values) % 16 == 0 &&
                      reinterpret_cast<size_t>(weights) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(g.blocks);
  if (vector)
    mcmctof::weighted_hist_kernel<true><<<grid, g.threads, g.smem, s>>>(
        values, weights, out, parts, n_rows, c);
  else
    mcmctof::weighted_hist_kernel<false><<<grid, g.threads, g.smem, s>>>(
        values, weights, out, parts, n_rows, c);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.blocks == 1) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(n_rows) * n_bins;
  mcmctof::combine_kernel<<<static_cast<int>((n_out + 255) / 256), 256, 0,
                            s>>>(parts, out, n_rows, g.blocks, c);
  return static_cast<int>(cudaGetLastError());
}
