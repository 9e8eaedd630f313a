// Kernel K2: zero-degree-segment TOF histograms of the forward model.
//
// Replaces the TPU kernel mcmctoffitting_tpu/ops/pallas_tof.py::_tof_kernel
// (pl.pallas_call at :127) and its custom VJP's backward _fn_bwd (:246).
// Plain PyTorch version: the expand-then-histogram path in
// mcmctoffitting_tpu_torch/ops/cuda_tof.py::tof_hist_segments_plain and its
// autograd.  Wrapper and dispatch: ops/cuda_tof.py::tof_hist_segments (the
// forward, and the torch.autograd.Function TofHistSegments whose backward
// launches tof_hist_bwd_kernel below).
//
// What it computes, per (walker, run) row: the M * Be lattice cells, each
// spread over the K zero-degree segments, give M * Be * K samples
//   v = base_tof[m, b] + zt[b, k],   w = draws[m, b] * zw[b, k],
// histogrammed into the run's window with np.histogram's rules:
//   idx = clamp(floor((v - lo) * scale), 0, n_bins - 1), counted only when
//   lo <= v <= hi (so v == hi lands in the last bin; NaN drops out).
// scale is float32(n_bins / (hi - lo)), fixed on the host.  Output rows are
// padded to n_pad bins; bins at or beyond the run's n_bins stay zero.
//
// Weights stay float32.  The TPU kernel rounds them to bf16 because it
// histograms with one-hot products on the matrix unit; that rounding
// belongs to the TPU's schedule, not to the model, and the JAX package's
// own CPU path sums in float32 too.
//
// What bounds it on an H100: neither bytes nor flops.  A launch of the
// forward model (512 rows of 500 cells, 10 segments, 70 bins) reads 2 MB,
// writes 143 KB and does 2.6M adds; the card's floor between two dependent
// kernels is 0.8 us.  What costs is how the adds meet in a bin, and how
// much of the card works at once.  Measured at that shape:
//   * one thread per sample, a float32 atomicAdd on one shared-memory
//     histogram per row: 27.5 us, 16.5 of them in the atomic.  On sm_90a
//     that atomicAdd is a compare-and-swap retry loop (LDS, FADD,
//     ATOMS.CAST.SPIN), and neighbouring threads took the K segments of one
//     cell, which fall into 2.3 bins on average, so the loop serialised
//     most of a warp;
//   * one thread per cell, per-warp histograms, the lanes of one bin joined
//     with __match_any_sync and summed by shuffles in lane order: 19.7 us.
//     By its time MATCH.ANY issues about once per 56 cycles on an SM, and
//     the design needs one per warp and segment;
//   * 64 (128) threads per row, each with a private histogram in shared
//     memory and a run of equal bins summed in a register: 16.0 (11.2) us.
//     No conflicts at all, but a thread walks 80 (40) samples one after the
//     other at ~200 cycles each, with 8 warps on an SM to hide that behind.
// Float32 sums in a fixed order need either a collective per step or few
// threads; an integer sum needs neither, because its order does not matter
// and int32 is the one type sm_90a adds in shared memory natively
// (ATOMS.ADD).
//
// Design (tof_hist_kernel): one block per row, one thread per lattice cell,
// fixed-point sums in two int32 words per bin.
//   * A thread reads its cell's base and draws once and walks the K
//     segments in registers.  It reads zt and zw from device memory through
//     L1, from copies the wrapper makes once per pair of tables,
//     segment-major, so a warp's lanes (neighbouring eD cells) read
//     neighbouring words.  (Staging the tables in shared memory in every
//     block, and summing |zw| over k there, cost more instructions than the
//     samples did: 4.3 of the 9.6 us of that version.)  All 262k threads of
//     the launch fit the card at once (32 registers, four blocks of 512 on
//     an SM).
//   * The block first adds up S = max_b sum_k |zw| * sum |draws| over the
//     row (shuffle trees within and across the warps, in a fixed order), an
//     upper bound of any bin; the first factor is one float the wrapper
//     keeps beside the tables' copies.  With 2^p the largest power of two such that S * 2^p <=
//     2^21, a weight w becomes hi = rint(w * 2^p) and lo = rint((w * 2^p -
//     hi) * 2^q), q = min(22, 30 - ceil(log2(samples per row))): neither
//     word's sum can overflow, the scaling by powers of two is exact, and
//     what is dropped of a weight is at most 2^-(p+q+1), i.e. 2^-39 of S at
//     5,000 samples (a bin of 70 weights is off by at most 70 * 2^-39 S
//     before its one rounding; float32 weights above 2^-15 of S are summed
//     exactly).  Both roundings, and the floor
//     of the bin, are float additions (round_in_place): the conversion
//     instructions issue at a quarter of an addition's rate, and with four
//     of them per sample they, not the atomics, set the kernel's time.
//   * zt rises with k, so a cell's segments fall into runs of equal bins
//     (2.3 per cell): a run is summed in registers and goes to the
//     histogram with one atomicAdd per word.  Integer sums do not depend on
//     the order, so neither the runs nor the atomics' order change the
//     result.
//   * The row is written once: (hi + lo * 2^-q) * 2^-p in float64, rounded
//     once to float32.
// The output is therefore the same on every call, bit for bit, and every
// bin is the float32 nearest to its exact sum (up to the 2^-39 S a weight
// above), which a float32 accumulation in any order is not.  The plain version's
// scatter_add_ sums float32 in the order of its atomics; the two agree to
// float32 rounding of the plain version's sums.  A row with a non-finite
// weight (S is inf or NaN) comes out NaN in every bin, where the plain
// version has NaN or inf in the bins those weights fall into: the forward
// model divides a row by its sum next, which makes both all NaN.
//
// Shared memory: 2 * n_pad ints.  Above 48 KB the kernel opts in, up to the
// 227 KB a block can have (~29k bins).  Beyond that, or from 2^30 samples per row (or 2^22
// bins),
// tof_hist_general_kernel serves: the first design above, float32 sums in
// the order of its atomics.  The C library makes that choice
// (mcmctof_tof_hist_plan reports it); the wrapper never falls back to the
// plain version.

#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>

#include "device_guard.cuh"
#include "fast_div.cuh"

namespace mcmctof {
namespace {

constexpr int kMaxThreads = 512;
constexpr int kBlocksPerSm = 4;
constexpr int kHiBits = 21;       // |hi| of one weight <= 2^21: a bit of
                                  // head room for the rounding of S itself
constexpr int kMaxLoBits = 22;    // |lo| of one weight <= 2^21
constexpr int kMaxSampleBits = 30;   // sum |hi| < 2^21 + 2^29
constexpr int kMaxScaleExp = 96;  // 2^p stays a normal float32

// Float to integer without the conversion unit (F2I, FRND and I2F issue at
// a quarter of the rate of an addition, and a sample would need four): for
// |x| < 2^22 the sum x + 1.5 * 2^23 lies in [2^23, 2^24), where floats are
// the integers, so the addition itself rounds x to an integer (to nearest
// even, or down with the rounding mode of __fadd_rd) and the integer
// stands in the sum's low mantissa bits.
constexpr float kRoundMagic = 12582912.0f;        // 1.5 * 2^23
constexpr int kRoundMagicBits = 0x4B400000;

__device__ __forceinline__ float round_in_place(float x) {
  return __fadd_rn(x, kRoundMagic);               // kRoundMagic + rint(x)
}

__device__ __forceinline__ int rounded_int(float sum) {
  return __float_as_int(sum) - kRoundMagicBits;
}

__device__ __forceinline__ int floor_to_int(float x) {   // 0 <= x < 2^22
  return __float_as_int(__fadd_rd(x, kRoundMagic)) - kRoundMagicBits;
}

// The bin of a sample time v in a run's window, -1 where np.histogram drops
// it: counted only when lo <= v <= hi (NaN fails both tests), then
// min(floor((v - lo) * scale), n_bins - 1), so v == hi lands in the last
// bin.  In the window 0 <= (v - lo) * scale <= n_bins (1 + 2^-23), far
// below 2^22, where floor_to_int is exact.  Both forward kernels bin
// through this one function, and the backward kernel through
// tof_bin_clamped, the same arithmetic, so the backward gathers the
// cotangent of the very bin the forward added each sample to.
__device__ __forceinline__ int tof_bin(float v, float lo, float hi,
                                       float scale, int nb1) {
  if (!(v >= lo && v <= hi)) return -1;
  return min(floor_to_int((v - lo) * scale), nb1);
}

// tof_bin for a sample in the window; for any other (NaN too) some bin in
// [0, nb1], where a gather stays in bounds (its term is then dropped).  In
// the window floor_to_int is >= 0, so the unsigned min is tof_bin's.
__device__ __forceinline__ int tof_bin_clamped(float v, float lo,
                                               float scale, int nb1) {
  return static_cast<int>(
      min(static_cast<unsigned>(floor_to_int((v - lo) * scale)),
          static_cast<unsigned>(nb1)));
}
constexpr int kGeneralThreads = 256;
constexpr size_t kSmemNoOptIn = 48 * 1024;
constexpr size_t kSmemOptIn = 226 * 1024;   // 227 KB less the static part

__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
    tof_hist_kernel(const float* __restrict__ base,
                    const float* __restrict__ draws,
                    const float* __restrict__ zt_t,
                    const float* __restrict__ zw_t,
                    const float* __restrict__ zw_abs_max,
                    const float* __restrict__ win_lo,
                    const float* __restrict__ win_hi,
                    const float* __restrict__ win_scale,
                    const int* __restrict__ win_nb1, float* __restrict__ out,
                    const FastDiv runs, int n_cells, const FastDiv ed,
                    int n_seg, int n_pad, int lo_bits) {
  extern __shared__ int smem[];
  __shared__ float s_part[32];
  int* s_hi = smem;            // [n_pad]
  int* s_lo = smem + n_pad;    // [n_pad]
  const int n_ed = static_cast<int>(ed.d);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_threads = blockDim.x;
  const int row = blockIdx.x;

  // everything the thread needs from device memory is asked for at once:
  // the window and its own cell (cells beyond blockDim are loaded as they
  // come)
  const int run = static_cast<int>(runs.mod(row));
  const float lo = win_lo[run];
  const float hi = win_hi[run];
  const float scale = win_scale[run];
  const int nb1 = win_nb1[run];
  const float z_max = zw_abs_max[0];
  const float* row_base = base + static_cast<long long>(row) * n_cells;
  const float* row_draws = draws + static_cast<long long>(row) * n_cells;
  const bool own = tid < n_cells;
  const float own_t0 = own ? row_base[tid] : 0.0f;
  const float own_draws = own ? row_draws[tid] : 0.0f;
  for (int j = tid; j < 2 * n_pad; j += n_threads) smem[j] = 0;

  // S = max_b sum_k |zw| * sum |draws|, a bound of every bin: the same
  // value in every thread (one tree within the warps, one across them)
  float part = fabsf(own_draws);
  for (int cell = tid + n_threads; cell < n_cells; cell += n_threads) {
    part += fabsf(row_draws[cell]);
  }
  for (int d = 16; d > 0; d >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, d);
  }
  if (lane == 0) s_part[tid >> 5] = part;
  __syncthreads();
  float bound = lane < (n_threads >> 5) ? s_part[lane] : 0.0f;
  for (int d = 16; d > 0; d >>= 1) {
    bound += __shfl_xor_sync(0xffffffffu, bound, d);
  }
  bound *= z_max;
  const bool finite = bound <= FLT_MAX;   // false for inf and NaN
  // bound < 2^e, from its exponent bits (0 and subnormals: e = -126, and
  // the cap on p serves)
  const int e = ((__float_as_int(finite ? bound : 1.0f) >> 23) & 0xff) - 126;
  const int p = min(kHiBits - e, kMaxScaleExp);
  const float to_fixed = __int_as_float((127 + p) << 23);          // 2^p
  const float lo_scale = __int_as_float((127 + lo_bits) << 23);    // 2^q

  if (finite) {
    int cur = -1;            // the bin of the run being summed, -1: none
    int run_hi = 0, run_lo = 0;
    for (int cell = tid; cell < n_cells; cell += n_threads) {
      const float t0 = cell == tid ? own_t0 : row_base[cell];
      const float n_draws = cell == tid ? own_draws : row_draws[cell];
      const float* cell_zt = zt_t + ed.mod(cell);
      const float* cell_zw = zw_t + ed.mod(cell);
      for (int k = 0; k < n_seg; ++k) {
        const float v = t0 + cell_zt[k * n_ed];
        const float w = n_draws * cell_zw[k * n_ed];
        const int bin = tof_bin(v, lo, hi, scale, nb1);
        const float fixed = w * to_fixed;        // exact: a power of two
        const float whole = round_in_place(fixed);
        const int w_hi = rounded_int(whole);
        // fixed - rint(fixed) is exact; scaled by 2^q, |.| <= 2^(q-1)
        const int w_lo = rounded_int(
            round_in_place((fixed - (whole - kRoundMagic)) * lo_scale));
        if (bin == cur) {
          run_hi += w_hi;
          run_lo += w_lo;
        } else {
          if (cur >= 0) {
            atomicAdd(&s_hi[cur], run_hi);
            atomicAdd(&s_lo[cur], run_lo);
          }
          cur = bin;
          run_hi = w_hi;
          run_lo = w_lo;
        }
      }
    }
    if (cur >= 0) {
      atomicAdd(&s_hi[cur], run_hi);
      atomicAdd(&s_lo[cur], run_lo);
    }
  }
  __syncthreads();

  // (hi + lo * 2^-q) * 2^-p in float64, rounded once
  const double from_lo = __hiloint2double((1023 - lo_bits) << 20, 0);
  const double from_fixed = __hiloint2double((1023 - p) << 20, 0);
  float* row_out = out + static_cast<long long>(row) * n_pad;
  for (int j = tid; j < n_pad; j += n_threads) {
    const double sum = (static_cast<double>(s_hi[j]) +
                        static_cast<double>(s_lo[j]) * from_lo) * from_fixed;
    row_out[j] = finite ? static_cast<float>(sum) : nanf("");
  }
}

// The first design, for bin counts or tables the fast kernel has no room
// for: one block per row, one float32 histogram of n_pad bins, one thread
// per sample in turn, atomicAdd.  Sums in the order of the atomics.
__global__ void tof_hist_general_kernel(
    const float* __restrict__ base, const float* __restrict__ draws,
    const float* __restrict__ zt_t, const float* __restrict__ zw_t,
    const float* __restrict__ win_lo, const float* __restrict__ win_hi,
    const float* __restrict__ win_scale, const int* __restrict__ win_nb1,
    float* __restrict__ out, int n_runs, int n_cells, int n_ed, int n_seg,
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
  const long long n_samples = static_cast<long long>(n_cells) * n_seg;
  for (long long s = threadIdx.x; s < n_samples; s += blockDim.x) {
    const int cell = static_cast<int>(s / n_seg);
    const int seg = static_cast<int>(s - static_cast<long long>(cell) * n_seg);
    const int tab = seg * n_ed + cell % n_ed;
    const int idx = tof_bin(row_base[cell] + zt_t[tab], lo, hi, scale, nb1);
    if (idx >= 0) atomicAdd(&hist[idx], row_draws[cell] * zw_t[tab]);
  }
  __syncthreads();
  float* row_out = out + static_cast<long long>(row) * n_pad;
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x) row_out[j] = hist[j];
}

// The backward of the histogram, kernel tof_hist_bwd.
//
// Replaces the custom VJP's backward of the TPU kernel,
// mcmctoffitting_tpu/ops/pallas_tof.py::_fn_bwd (:246, plain JAX).  Plain
// PyTorch version: ops/cuda_tof.py::tof_hist_segments_bwd_plain.  The
// output is linear in the draws, and a sample's bin has zero gradient
// almost everywhere, so
//   grad_draws[m, b] = sum_k zw[b, k] * gbar[bin(base[m, b] + zt[b, k])]
// over the in-window samples, and nothing flows to base, zt or zw.
//
// What bounds it on an H100: bytes (base and the cotangent read once, the
// gradient written once; the tables are a few KB): 0.00131 ms at
// simultFit's (256, 4, 10, 50), K = 10, 0.01470 ms at oneBD's (256, 3,
// 20, 400), K = 1, and 0.00460 ms at the templates' (32, 4, 100, 150),
// K = 1.  At K = 10 instruction issue comes first: 12 SASS instructions
// a sample (588 after the barrier for a thread's 50; the addition, two
// compares, the bin's subtraction, scaling, floor and clamp, the gather's
// address and load, the product and the sum), 5.1M samples, ~2 us on 132
// SMs, above the 0.80 us a launch takes between two dependent kernels.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (device times of a
// replayed CUDA graph, the designs in turns in one call;
// perf/k2_bwd_parent_check.py, perf/k2_bwd_designs.py), at the three
// shapes in that order, in ms:
//   * the first design (one block of up to 512 threads a row, one thread
//     a cell, K a run-time loop bound, the cotangent staged before base
//     was read): 0.00853 / 0.02808 / 0.01096.  1,024 blocks of 512
//     threads ran as two waves, each block a chain of round trips
//     (window, staged cotangent, barrier, base, K dependent loads of the
//     tables, store); 128 rows, one block each, left the card idle.
//   * this design: 0.00462 / 0.01831 / 0.00530, the same bits.  A device
//     copy of base into a tensor of its shape, in turns with it:
//     0.00155 / 0.01625 / 0.00341.
//   * its variants (the faster of two passes): the cotangent staged by
//     plain loads 0.00480 / 0.01799 (0.01835 in the other pass) /
//     0.00536; gathered through L1 without staging 0.00581 / 0.02236 /
//     0.00602; each sample's gather under its own branch (nvcc then
//     rebuilds the shared window's base at every sample) 0.00506 /
//     0.01883 / 0.00552; the term chosen by a select instead of a
//     predicated sum 0.00486 at K = 10; the shared array indexed instead
//     of a volatile ld.shared 0.00483; K = 10 with two or ten cells a
//     thread 0.00546, 0.00535; K = 1 with four or sixteen 0.02007 /
//     0.00558, 0.01873 / 0.00545; K = 1 held to 32 registers (spills)
//     0.02312 / 0.00697; blocks of 64 or 32 threads 0.00472 / 0.01837 /
//     0.00556, 0.00489 / 0.02019 / 0.00642; the general kernel for every
//     K 0.00547 / 0.02039 / 0.00584.
//
// Design (tof_hist_bwd_kernel<K, STAGE>):
//   * Work items are (row, column b, group of m): a thread takes up to
//     bwd_cells(K) cells of one column, m = m0 .. m0 + c - 1, so it reads
//     the column's K values of zt and zw once for all of them.  Items are
//     numbered row-major over the whole launch and a block takes 128 in a
//     row, so no lane idles at the end of a row: the K = 10 lattice is 800
//     blocks, one wave at 64 registers a thread.  Neighbouring lanes take
//     neighbouring columns: every load and store of base and grad is
//     coalesced.
//   * Everything that does not need the cotangent is asked for first: the
//     window constants, the thread's c values of base and, with K fixed at
//     compile time (K = 10, K = 1), its 2K table values.  Only then are the
//     block's cotangent rows (one to three; contiguous in gbar) copied to
//     shared memory with cp.async (4-byte copies: a row of 70 bins is 280
//     bytes, so most rows start off the 16-byte alignment a bulk copy
//     needs), and waited for.  The two round trips to memory overlap.
//   * With K fixed the sample loop is unrolled, c x K independent bins and
//     gathers.  Any other K takes the general kernel (K = 0), a run-time
//     loop over the segments with the tables read in it.  The C library
//     chooses (mcmctof_tof_hist_bwd_plan reports which).
//   * No branch a sample: every sample gathers, by a volatile ld.shared,
//     at tof_bin_clamped (tof_bin's bin in the window, a bin in bounds
//     outside it), and an in-window one adds its term under a predicate.
//   * Each cell still sums its K terms in float32 in the order k = 0 ..
//     K - 1, each at the bin tof_bin gives, and -fmad=false keeps the
//     product and the sum two roundings: the output equals the first
//     design's bit for bit.  A gather: no atomics, the same bits on every
//     call.
//   * A window too wide to stage (the block's rows above the 226 KB a
//     block can have) gathers from device memory through L1 (STAGE false;
//     at K = 10 that kernel spills 28 bytes at 64 registers).
// Launches of up to 2^32 work items (the range of FastDiv).
constexpr int kBwdThreads = 128;
constexpr int kBwdBlocksPerSm = 8;   // 64 registers a thread at most

// Cells of one column a thread takes at most, by the K it is compiled for
// (0: any K)
__host__ __device__ constexpr int bwd_cells(int k) {
  return k == 10 ? 5 : k == 1 ? 8 : 4;
}

// A 4-byte copy from device to shared memory that does not hold the thread
// (cp.async), and the wait for all of a thread's copies
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A float from shared memory at a 32-bit shared-window address.  Volatile:
// nvcc neither moves it above the barrier nor sinks it into a branch.
// Indexed as an array whose element is then used under a condition, the
// load went into a branch of its own with the shared window's base built
// anew in it (BSSY, S2UR SR_CgaCtaId, ULEA, BSYNC) at every sample.
__device__ __forceinline__ float load_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <int K, bool STAGE>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
    tof_hist_bwd_kernel(const float* __restrict__ gbar,
                        const float* __restrict__ base,
                        const float* __restrict__ zt_t,
                        const float* __restrict__ zw_t,
                        const float* __restrict__ win_lo,
                        const float* __restrict__ win_hi,
                        const float* __restrict__ win_scale,
                        const int* __restrict__ win_nb1,
                        float* __restrict__ grad, const FastDiv runs,
                        const FastDiv items, const FastDiv ed, int n_x,
                        int cells, int n_seg, int n_pad, unsigned n_total) {
  constexpr int C = bwd_cells(K);
  extern __shared__ float s_g[];
  const unsigned first = blockIdx.x * kBwdThreads;
  const unsigned end = min(first + kBwdThreads, n_total);
  // threads past the last item repeat it: in bounds, and never stored
  const unsigned at = min(first + threadIdx.x, end - 1);
  const unsigned row = items.div(at);
  const unsigned item = at - row * items.d;
  const unsigned group = ed.div(item);
  const int b = static_cast<int>(item - group * ed.d);
  const int n_ed = static_cast<int>(ed.d);
  const int m0 = static_cast<int>(group) * cells;
  const int n_valid = min(cells, n_x - m0);
  const long long at_cell =
      static_cast<long long>(row) * n_x * n_ed + m0 * n_ed + b;

  const int run = static_cast<int>(runs.mod(row));
  const float lo = win_lo[run];
  const float hi = win_hi[run];
  const float scale = win_scale[run];
  const int nb1 = win_nb1[run];
  float t0[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    t0[j] = j < n_valid ? base[at_cell + j * n_ed] : 0.0f;
  }
  [[maybe_unused]] float zt[K > 0 ? K : 1], zw[K > 0 ? K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      zt[k] = zt_t[k * n_ed + b];
      zw[k] = zw_t[k * n_ed + b];
    }
  }

  // the thread's cotangent row: at shared address g_at staged, else g_row
  unsigned g_at = 0;
  const float* g_row = gbar + static_cast<long long>(row) * n_pad;
  if constexpr (STAGE) {
    const unsigned row0 = items.div(first);
    const int n_stage = static_cast<int>(items.div(end - 1) - row0 + 1) * n_pad;
    const float* src = gbar + static_cast<long long>(row0) * n_pad;
    for (int j = threadIdx.x; j < n_stage; j += kBwdThreads) {
      copy_async(s_g + j, src + j);
    }
    wait_async();
    __syncthreads();
    g_at = static_cast<unsigned>(
        __cvta_generic_to_shared(s_g + (row - row0) * n_pad));
  }
  // one sample: every sample gathers (in bounds, without a branch), and an
  // in-window one adds its term in float32 as the cell's next segment
  const auto add = [&](float& acc, float t, float zt_k, float zw_k) {
    const float v = t + zt_k;
    const int bin = tof_bin_clamped(v, lo, scale, nb1);
    float g;
    if constexpr (STAGE) {
      g = load_shared(g_at + 4u * bin);
    } else {
      g = g_row[bin];
    }
    const float term = zw_k * g;
    if (v >= lo && v <= hi) acc += term;
  };

  float acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.0f;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < C; ++j) add(acc[j], t0[j], zt[k], zw[k]);
    }
  } else {
    for (int k = 0; k < n_seg; ++k) {
      const float zt_k = zt_t[k * n_ed + b];
      const float zw_k = zw_t[k * n_ed + b];
#pragma unroll
      for (int j = 0; j < C; ++j) add(acc[j], t0[j], zt_k, zw_k);
    }
  }
  if (first + threadIdx.x < end) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < n_valid) grad[at_cell + j * n_ed] = acc[j];
    }
  }
}

// Shared memory of the fast kernel, 0 where it cannot serve: too many bins
// for a block, or so many samples in a row that the hi word could overflow.
size_t fast_smem(int n_cells, int n_seg, int n_pad) {
  const size_t bytes =
      sizeof(int) * 2 * static_cast<size_t>(n_pad);
  const long long samples = static_cast<long long>(n_cells) * n_seg;
  return bytes <= kSmemOptIn && samples < (1ll << kMaxSampleBits) ? bytes
                                                                   : 0;
}

}  // namespace
}  // namespace mcmctof

// Bytes of shared memory the fast kernel would use for these sizes, 0 where
// the general kernel serves.
extern "C" int mcmctof_tof_hist_plan(int n_cells, int n_seg, int n_pad) {
  return static_cast<int>(mcmctof::fast_smem(n_cells, n_seg, n_pad));
}

// zt_t, zw_t: the (Be, K) tables segment-major, (K, Be); zw_abs_max: one
// float in device memory, max over b of sum_k |zw[b, k]|.
extern "C" int mcmctof_tof_hist(const float* base, const float* draws,
                                const float* zt_t, const float* zw_t,
                                const float* zw_abs_max,
                                const float* lo, const float* hi,
                                const float* scale, const int* nb1,
                                float* out, int n_rows, int n_runs,
                                int n_cells, int n_ed, int n_seg, int n_pad,
                                int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (n_rows <= 0 || n_pad <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cells <= 0 || n_ed <= 0 || n_seg <= 0) {   // no samples: all zero
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(n_rows) * n_pad, s));
  }
  size_t smem = mcmctof::fast_smem(n_cells, n_seg, n_pad);
  if (smem > 0) {
    if (smem > mcmctof::kSmemNoOptIn) {
      cudaError_t err = cudaFuncSetAttribute(
          mcmctof::tof_hist_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return mcmctof::failed(err);
    }
    // a thread per cell, in whole warps
    int threads = (n_cells + 31) / 32 * 32;
    threads = threads < 32 ? 32 : threads;
    threads = threads > mcmctof::kMaxThreads ? mcmctof::kMaxThreads : threads;
    // q = min(22, 30 - ceil(log2(samples per row))): sum |lo| stays below
    // 2^29
    const long long samples = static_cast<long long>(n_cells) * n_seg;
    int lo_bits = mcmctof::kMaxLoBits;
    while (lo_bits > 0 &&
           (1ll << (mcmctof::kMaxSampleBits - lo_bits)) < samples) {
      --lo_bits;
    }
    using mcmctof::FastDiv;
    mcmctof::tof_hist_kernel<<<n_rows, threads, smem, s>>>(
        base, draws, zt_t, zw_t, zw_abs_max, lo, hi, scale, nb1, out,
        FastDiv(n_runs), n_cells, FastDiv(n_ed), n_seg, n_pad, lo_bits);
  } else {
    smem = static_cast<size_t>(n_pad) * sizeof(float);
    if (smem > mcmctof::kSmemNoOptIn) {
      cudaError_t err = cudaFuncSetAttribute(
          mcmctof::tof_hist_general_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return mcmctof::failed(err);
    }
    mcmctof::tof_hist_general_kernel<<<n_rows, mcmctof::kGeneralThreads,
                                       smem, s>>>(
        base, draws, zt_t, zw_t, lo, hi, scale, nb1, out, n_runs, n_cells,
        n_ed, n_seg, n_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace mcmctof {
namespace {

// The K the backward kernel for n_seg segments is compiled for, 0: the
// general kernel
int bwd_k(int n_seg) { return n_seg == 10 || n_seg == 1 ? n_seg : 0; }

// How the backward cuts a launch into work items
struct BwdLayout {
  int cells;          // cells a thread takes, as even as the groups allow
  long long items;    // work items of a row
  long long span;     // rows of the cotangent one block can touch

  BwdLayout(int k, int n_rows, int n_x, int n_ed) {
    const int groups = (n_x + bwd_cells(k) - 1) / bwd_cells(k);
    cells = (n_x + groups - 1) / groups;
    items = static_cast<long long>(n_ed) * ((n_x + cells - 1) / cells);
    span = std::min<long long>(
        n_rows, (kBwdThreads - 1 + items - 1) / items + 1);
  }
};

template <int K, bool STAGE>
cudaError_t launch_bwd(const BwdLayout& layout, const float* gbar,
                       const float* base, const float* zt_t,
                       const float* zw_t, const float* lo, const float* hi,
                       const float* scale, const int* nb1, float* grad,
                       int n_rows, int n_runs, int n_x, int n_ed, int n_seg,
                       int n_pad, cudaStream_t s) {
  const long long n_total = layout.items * n_rows;
  if (n_total + kBwdThreads > (1ll << 32)) return cudaErrorInvalidValue;
  size_t smem = 0;
  if constexpr (STAGE) {
    smem = sizeof(float) * static_cast<size_t>(layout.span) * n_pad;
    if (smem > kSmemNoOptIn) {
      cudaError_t err = cudaFuncSetAttribute(
          tof_hist_bwd_kernel<K, STAGE>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
  }
  const unsigned blocks =
      static_cast<unsigned>((n_total + kBwdThreads - 1) / kBwdThreads);
  tof_hist_bwd_kernel<K, STAGE><<<blocks, kBwdThreads, smem, s>>>(
      gbar, base, zt_t, zw_t, lo, hi, scale, nb1, grad, FastDiv(n_runs),
      FastDiv(static_cast<uint32_t>(layout.items)), FastDiv(n_ed), n_x,
      layout.cells, n_seg, n_pad, static_cast<unsigned>(n_total));
  return cudaSuccess;
}

}  // namespace
}  // namespace mcmctof

// Which backward kernel serves n_seg segments: the K it is compiled for
// (10 or 1), 0 for the general kernel.
extern "C" int mcmctof_tof_hist_bwd_plan(int n_seg) {
  return mcmctof::bwd_k(n_seg);
}

// The backward: gbar (n_rows, n_pad), base (n_rows, n_cells) -> grad
// (n_rows, n_cells), the tables and windows as for mcmctof_tof_hist.
extern "C" int mcmctof_tof_hist_bwd(const float* gbar, const float* base,
                                    const float* zt_t, const float* zw_t,
                                    const float* lo, const float* hi,
                                    const float* scale, const int* nb1,
                                    float* grad, int n_rows, int n_runs,
                                    int n_cells, int n_ed, int n_seg,
                                    int n_pad, int device, void* stream) {
  mcmctof::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (n_rows <= 0 || n_cells <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ed <= 0 || n_seg <= 0 || n_pad <= 0) {   // no samples: all zero
    return static_cast<int>(cudaMemsetAsync(
        grad, 0, sizeof(float) * static_cast<size_t>(n_rows) * n_cells, s));
  }
  const int n_x = n_cells / n_ed;
  const int k = mcmctof::bwd_k(n_seg);
  const mcmctof::BwdLayout layout(k, n_rows, n_x, n_ed);
  // the cotangent staged where the rows a block touches fit a block
  const bool stage =
      sizeof(float) * layout.span * n_pad <= mcmctof::kSmemOptIn;
  auto launch = stage ? (k == 10  ? mcmctof::launch_bwd<10, true>
                         : k == 1 ? mcmctof::launch_bwd<1, true>
                                  : mcmctof::launch_bwd<0, true>)
                      : (k == 10  ? mcmctof::launch_bwd<10, false>
                         : k == 1 ? mcmctof::launch_bwd<1, false>
                                  : mcmctof::launch_bwd<0, false>);
  const cudaError_t err =
      launch(layout, gbar, base, zt_t, zw_t, lo, hi, scale, nb1, grad,
             n_rows, n_runs, n_x, n_ed, n_seg, n_pad, s);
  if (err != cudaSuccess) return mcmctof::failed(err);
  return static_cast<int>(cudaGetLastError());
}
