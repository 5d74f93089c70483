// subset_combine: the per-node min-plus subset-convolution closure.
//
// Replaces the TPU kernel src/repro/kernels/subset_combine/kernel.py,
// subset_combine_t (body _combine_kernel): for each (t, a, b) of
// split_pairs(m) in popcount order, S[t] becomes the K smallest distinct
// values of S[t] ∪ {min(S[a]_i + S[b]_j, INF)}.  It takes and returns
// S[rows, 2^m, K] in the engine's layout: no transpose, no padding.
//
// What bounds it on the H100: device memory.  Each row's table is read once
// and written once, 2 * rows * 2^m * K * 4 B (for the 8-lane paper-scale
// bucket with m=3, K=3: 2 * 8 * 460,451 * 96 B = 707 MB, ~0.21 ms at
// 3.35 TB/s); the sweep does (3^m - 2^(m+1) + 1)/2 * K^2 adds and inserts
// per row, a few hundred simple operations against 192 bytes moved.
//
// Design: one thread per row.  A block loads its rows' tables into a
// shared-memory slab with coalesced reads, each thread runs the sweep on
// its own table in the slab, and the block writes the slab back with
// coalesced writes.  The split pairs are enumerated in-kernel in the same
// order as spa.split_pairs (the order is uniform across a warp, so it
// costs no divergence).
//
// The wide route (every other (m, K) up to 2^m * K = DKS_ROW_FLOATS; see
// dks_lattice.cuh and kernels/subset_combine/ops.py::wide_plan): a warp
// takes 32 / 2^m rows at m < 5 (one a team of 2^m lanes), else one; the
// warp's rows are loaded and stored coalesced into tables whose sets sit
// an odd number of floats apart, and each team closes its table with
// dks_combine_team.  On the H100 this is bound by the sweep's inserts in
// shared memory (at m = 7, 966 splits a row), not by bytes; at m <= 3
// and K >= 8 a popcount's few targets spread over all the team's lanes
// through private lists, where one lane a target left most of it idle.
//
// Nothing is allocated here; the wrapper allocates the output with
// torch.empty.
#include "dks_lattice.cuh"

template <int K>
__global__ void __launch_bounds__(DKS_MAX_THREADS)
subset_combine_kernel(const float* __restrict__ S, float* __restrict__ out,
                      long long n_rows, int m) {
  extern __shared__ float slab[];
  const int fk = (1 << m) * K;
  const int stride = blockDim.x + 1;
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const long long left = n_rows - row0;
  const int rows = left < (long long)blockDim.x ? (int)left : (int)blockDim.x;
  dks_rows_to_slab<K>(S + row0 * fk, slab, rows, m, stride);
  __syncthreads();
  if ((int)threadIdx.x < rows)
    dks_combine_sweep<K>(slab + threadIdx.x, stride, m);
  __syncthreads();
  dks_slab_to_rows<K>(slab, out + row0 * fk, rows, m, stride);
}

// S, out: f32[n_rows, 2^m, K], contiguous, on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dks_subset_combine(const float* S, float* out,
                                  long long n_rows, int m, int k,
                                  void* stream) {
  if (m < 1 || m > DKS_MAX_M || k < 1 || k > DKS_MAX_K || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int fk = (1 << m) * k;
  const int threads = dks_block_threads(fk);
  const unsigned blocks = (unsigned)((n_rows + threads - 1) / threads);
  const size_t smem = dks_slab_bytes(fk, threads);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
#define DKS_COMBINE_LAUNCH(KK)                                              \
  err = dks_allow_slab(subset_combine_kernel<KK>, smem);                    \
  if (err != cudaSuccess) return (int)err;                                  \
  subset_combine_kernel<KK><<<blocks, threads, smem, s>>>(S, out, n_rows, m)
  DKS_SWITCH_K(k, DKS_COMBINE_LAUNCH)
#undef DKS_COMBINE_LAUNCH
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(DKS_WIDE_PLAN_WARPS * 32, 16)
subset_combine_wide_kernel(const float* __restrict__ S,
                           float* __restrict__ out, long long n_rows, int m,
                           int k, int rows, int spread) {
  extern __shared__ float slab[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = dks_wide_stride(k), fk = k << m, row_f = ks << m;
  const int T = 32 / rows, g = lane / T, tl = lane - g * T;
  const long long row0 = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) *
                         rows;
  if (row0 >= n_rows) return;  // a whole warp leaves
  const int nr = n_rows - row0 < rows ? (int)(n_rows - row0) : rows;
  float* wbase = slab + warp * dks_wide_warp_floats(m, k, rows, spread);
  dks_rows_in(wbase, S + row0 * fk, nr * fk, k, ks, lane, 32);
  __syncwarp();
  dks_combine_team(wbase + g * row_f,
                   spread ? wbase + rows * row_f + g * T * ks : nullptr, m, k,
                   ks, T, tl, g < nr);
  __syncwarp();
  dks_rows_out(out + row0 * fk, wbase, nr * fk, k, ks, m, lane, 32,
               DKS_FULL_MASK, T);
}

// The wide route of dks_subset_combine (same layout), for
// 2^m * k <= DKS_ROW_FLOATS, on the plan of
// kernels/subset_combine/ops.py::wide_plan: `rows` rows a warp, `warps`
// warps a block, private lists for the combine if `spread`.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dks_subset_combine_wide(const float* S, float* out,
                                       long long n_rows, int m, int k,
                                       int rows, int warps, int spread,
                                       void* stream) {
  if (!dks_wide_plan_ok(m, k, rows, warps, spread) || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const long long per_block = (long long)warps * rows;
  const long long blocks = (n_rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)warps * dks_wide_warp_floats(m, k, rows, spread) * sizeof(float);
  cudaError_t err = dks_allow_slab(subset_combine_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  subset_combine_wide_kernel<<<(unsigned)blocks, warps * 32, smem,
                               (cudaStream_t)stream>>>(S, out, n_rows, m, k,
                                                       rows, spread);
  return (int)cudaGetLastError();
}
