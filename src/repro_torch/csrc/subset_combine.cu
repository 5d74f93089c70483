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
// dks_lattice.cuh): one warp per row, its table whole in the warp's share
// of shared memory, loaded and stored coalesced, closed by
// dks_combine_sweep_warp (the targets of one popcount spread over the
// warp's lanes).
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

__global__ void __launch_bounds__(DKS_WIDE_WARPS * 32)
subset_combine_wide_kernel(const float* __restrict__ S,
                           float* __restrict__ out, long long n_rows, int m,
                           int k) {
  extern __shared__ float slab[];
  const int fk = (1 << m) * k;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // a whole warp leaves
  float* tab = slab + (threadIdx.x >> 5) * fk;
  dks_warp_copy(tab, S + row * fk, fk);
  __syncwarp();
  dks_combine_sweep_warp(tab, m, k);
  dks_warp_copy(out + row * fk, tab, fk);
}

// The wide route of dks_subset_combine (same layout), for
// 2^m * k <= DKS_ROW_FLOATS.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dks_subset_combine_wide(const float* S, float* out,
                                       long long n_rows, int m, int k,
                                       void* stream) {
  if (m < 1 || m > 30 || !dks_wide_fits(1LL << m, k) || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int fk = (1 << m) * k;
  const int warps = dks_wide_warps(fk);
  const long long blocks = (n_rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * fk * sizeof(float);
  cudaError_t err = dks_allow_slab(subset_combine_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  subset_combine_wide_kernel<<<(unsigned)blocks, warps * 32, smem,
                               (cudaStream_t)stream>>>(S, out, n_rows, m, k);
  return (int)cudaGetLastError();
}
