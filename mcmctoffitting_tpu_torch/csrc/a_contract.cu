// The A contraction of the e0grid estimators as a gather over each output
// column's nonzeros.
//
// Replaces no TPU kernel: the JAX package leaves the product to XLA's dot
// (mcmctoffitting_tpu/models/forward.py::_e0grid_contract).  Plain
// version: the dense product ops/rowwise.py::rowwise_matmul(x, A), the
// path of ops/e0grid.py::contract off the card.  Wrapper and dispatch:
// ops/cuda_contract.py::a_contract.
//
// What it computes: out (n, N) = x (n, K) @ A (K, N), from A packed as
// ELL by column (ops/cuda_contract.py::ell_pack): entry j of column c is
// a row index idx[j][c] and a value val[j][c], the column's structural
// nonzeros in ascending row, padded to the operator's widest column with
// value 0 at a row the column already reads.  Each output element is the
// fmaf chain of its column's entries in that order from +0, as a dense
// float32 product without split-K adds its terms, an exact zero term
// leaving such a sum unchanged (on the H100 the bits of oneBD's SGEMM;
// simultFit's SGEMM splits the sum over k, and the two differ in the last
// bits, each within a chain's error bound of the exact product).  No
// atomics: every output element is written once, by one thread.  A row's
// result does not depend on the other rows of the batch, so no batch needs
// padding to a fixed row count.
//
// Why a kernel: the operator is sparse by construction (a column m Be + b
// reads the t-moments of the few fine cells whose e0 preimage meets eD bin
// b at depth m): oneBD hardcore's A is 63,612 nonzeros of 4,096 x 8,000
// (0.19%, at most 12 a column), simultFit's 16,772 of 2,048 x 500 (1.6%,
// at most 40).  The dense product of a oneBD half-step, (384 rows padded
// to 512) @ (4,096, 8,000), is 33.5 GFLOP and took 0.66 ms as cuBLAS's
// SGEMM at ~76% of the card's float32 peak; the nonzeros need 49 MFLOP.
//
// What bounds it on an H100: bytes.  It reads the rows once (6.3 MB for
// oneBD), the packed operator once (0.8 MB) and writes the output once
// (12.3 MB): 5.8 us at 3.35 TB/s.
//
// Design: a block of 512 threads takes kRows = 4 rows and a tile of
// columns.
//   * It stages its rows in shared memory interleaved, the four rows' k-th
//     moments side by side, with coalesced loads along each row; so one
//     16-byte shared-memory read gives a nonzero's four moments.
//   * Each thread walks columns of the tile (a warp on 32 neighbouring
//     columns), reads each of a column's entries once, coalesced (entry j
//     of every column lies contiguous), and applies it to the four rows
//     held in four accumulators.
//   * Each output row is written coalesced along the columns.
//   * The grid is the blocks that fit on the card at once: the row tiles
//     times as many column tiles as leave no slot empty.  More column
//     tiles stage the rows more often, more row tiles read the entries more
//     often; at oneBD's half-step both are L2 traffic.
//   * Rows wider than four rows of shared memory allow take one row a
//     block (up to K = 58,112: F = 14,528 fine cells).
// Measured on an H100 80GB HBM3 (device time a call in a replayed graph;
// "cold": with 64 MB written between calls, so nothing is left in L2):
// oneBD's half-step (384 rows) 0.0170 ms, cold 0.0195, against the dense
// product's 0.666 ms; simultFit's (512 rows) 0.0084 ms, cold 0.0127,
// against 0.0337.  Designs timed the same way (oneBD, warm / cold): rows
// staged one after the other and 256 threads 0.0208 / 0.0336; interleaved
// with 256 threads 0.0177 / 0.0288, with 1,024 threads 0.0198 / 0.0220;
// eight rows a block 0.0251 / 0.0295 (512 threads).

#include <cuda_runtime.h>

#include <algorithm>

#include "device_guard.cuh"

namespace mcmctof {
namespace {

constexpr int kContractThreads = 512;
constexpr size_t kContractSmemLimit = 227 * 1024;

// kRows is 4 (the rows' k-th moments one float4) or 1
template <int kRows>
__global__ void __launch_bounds__(kContractThreads)
    a_contract_kernel(const float* __restrict__ x,
                      const int* __restrict__ idx,
                      const float* __restrict__ val, float* __restrict__ out,
                      int n_rows, int k_dim, int n_cols, int width,
                      int tile_cols) {
  // the block's rows interleaved: staged[k * kRows + r] = x[row0 + r][k]
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRows), n_rows - row0));
  for (int k = threadIdx.x; k < k_dim; k += kContractThreads) {
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] = r < rows ? __ldg(x + (row0 + r) * k_dim + k) : 0.0f;
    if constexpr (kRows == 4) {
      staged4[k] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      staged[k] = v[0];
    }
  }
  __syncthreads();
  const int c_begin = blockIdx.y * tile_cols;
  const int c_end = min(n_cols, c_begin + tile_cols);
  for (int c = c_begin + threadIdx.x; c < c_end; c += kContractThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < width; ++j) {
      const long long e = static_cast<long long>(j) * n_cols + c;
      const int k = __ldg(idx + e);
      const float a = __ldg(val + e);
      if constexpr (kRows == 4) {
        const float4 m = staged4[k];
        acc[0] = fmaf(m.x, a, acc[0]);
        acc[1] = fmaf(m.y, a, acc[1]);
        acc[2] = fmaf(m.z, a, acc[2]);
        acc[3] = fmaf(m.w, a, acc[3]);
      } else {
        acc[0] = fmaf(staged[k], a, acc[0]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) out[(row0 + r) * n_cols + c] = acc[r];
  }
}

template <int kRows>
cudaError_t launch(const float* x, const int* idx, const float* val,
                   float* out, int n_rows, int k_dim, int n_cols, int width,
                   int device, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * k_dim;
  auto kernel = a_contract_kernel<kRows>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, n_sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kContractThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  const long long row_tiles = (n_rows + kRows - 1) / kRows;
  // column tiles of whole warps, as many as leave no slot of the card
  // empty once every row tile has one
  const long long slots = static_cast<long long>(std::max(per_sm, 1)) * n_sms;
  const long long most = (n_cols + 31) / 32;
  const long long col_tiles =
      std::min(most, std::max(1LL, slots / row_tiles));
  const int tile_cols =
      static_cast<int>((n_cols + 32 * col_tiles - 1) / (32 * col_tiles) * 32);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((n_cols + tile_cols - 1) / tile_cols));
  kernel<<<grid, kContractThreads, smem, stream>>>(
      x, idx, val, out, n_rows, k_dim, n_cols, width, tile_cols);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mcmctof

// x: (n_rows, k_dim) float32; idx, val: (width, n_cols) int32 and float32,
// entry j of column c at j * n_cols + c; out: (n_rows, n_cols) float32;
// all contiguous.  Returns a cudaError_t.
extern "C" int mcmctof_a_contract(const float* x, const int* idx,
                                  const float* val, float* out, int n_rows,
                                  int k_dim, int n_cols, int width,
                                  int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (n_rows < 0 || k_dim < 1 || n_cols < 0 || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || n_cols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = sizeof(float) * static_cast<size_t>(k_dim);
  cudaError_t err;
  if (4 * row_bytes <= mcmctof::kContractSmemLimit) {
    err = mcmctof::launch<4>(x, idx, val, out, n_rows, k_dim, n_cols, width,
                             device, s);
  } else if (row_bytes <= mcmctof::kContractSmemLimit) {
    err = mcmctof::launch<1>(x, idx, val, out, n_rows, k_dim, n_cols, width,
                             device, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return err == cudaSuccess ? 0 : mcmctof::failed(err);
}
