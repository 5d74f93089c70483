// Device code shared by the DKS kernels (subset_combine.cu,
// lane_superstep.cu, padded_topk.cu): the top-K distinct insert, the
// per-thread table slab in shared memory, and the popcount-ordered
// subset-combine sweep, each in two routes:
//
// - templated (1 <= m <= DKS_MAX_M, 1 <= K <= DKS_MAX_K): K is a template
//   parameter, K-vectors live in registers and each thread owns one row
//   in a slab column;
// - wide (every other (m, K) with 2^m * K <= DKS_ROW_FLOATS; the wrappers
//   pick the route, kernels/subset_combine/ops.py::route): m and K are
//   run-time values, one warp owns one row, whose table lives whole in the
//   warp's share of shared memory, and warp lane j works the keyword sets
//   f = j (mod 32) or the targets of one popcount.  Past K = 8 the
//   templated route's registers spill, and past m = 6 its slab of 33 rows
//   outgrows the 227 KB a block may have.
//
// A node's table is F = 2^m keyword-sets of K sorted, distinct,
// INF-padded f32 values.  Every value the lattice makes is a min, a compare
// or one round-to-nearest f32 add (__fadd_rn, so nothing is contracted),
// which is what keeps the kernels bit-identical to their plain torch
// versions and to the JAX reference.  Build without --use_fast_math.
#pragma once

#include <cuda_runtime.h>

#define DKS_INF 1e9f
#define DKS_HALF_INF 5e8f   // bump_to_inf threshold: 0.5 * INF
#define DKS_MAX_M 6
#define DKS_MAX_K 8
#define DKS_MAX_THREADS 256
#define DKS_SLAB_AIM (48 * 1024)     // the slab size blocks are sized for
#define DKS_SMEM_MAX (227 * 1024)    // the most a block may have on sm_90
// The wide route: a row of 2^m * K floats in one warp's shared memory, at
// most 64 KB (m <= 10 at K <= 16); a block takes as many rows as keep it
// within DKS_SLAB_AIM, 1 to DKS_WIDE_WARPS.
#define DKS_ROW_FLOATS 16384
#define DKS_WIDE_WARPS 8

// Insert x into the sorted-unique INF-padded K-vector r, keeping the K
// smallest distinct values.  The result is a function of the value set
// alone, so candidates may arrive in any order.
template <int K>
__device__ __forceinline__ void dks_insert(float (&r)[K], float x) {
  if (!(x < r[K - 1])) return;  // not below the K-th value, or equal to it
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (x == r[j]) return;  // a duplicate (or INF meeting INF padding)
    if (x < r[j]) {
      const float t = r[j];
      r[j] = x;
      x = t;
    }
  }
}

// The block's tables live in one shared-memory slab: slot i (= set*K + j)
// of the block's row r sits at slab[i * stride + r], with stride =
// blockDim.x + 1 so that a warp touching one slot of 32 rows, or 32 slots
// of one row, hits distinct banks.
template <int K>
__device__ __forceinline__ void dks_load(const float* tab, int stride, int f,
                                         float (&r)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = tab[(f * K + j) * stride];
}

template <int K>
__device__ __forceinline__ void dks_store(float* tab, int stride, int f,
                                          const float (&r)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) tab[(f * K + j) * stride] = r[j];
}

// Coalesced copies of `rows` consecutive rows of fk = 2^m * K floats
// between device memory and the slab (all threads of the block take part).
// Element idx is slot idx - r * fk of row r = (idx >> m) / K: a shift and
// a division by a constant, where idx / fk would be a division by a
// run-time value for every element.
template <int K>
__device__ __forceinline__ void dks_rows_to_slab(const float* __restrict__ g,
                                                 float* slab, int rows,
                                                 int m, int stride) {
  const int fk = K << m;
  for (int idx = threadIdx.x; idx < rows * fk; idx += blockDim.x) {
    const int r = (idx >> m) / K;
    slab[(idx - r * fk) * stride + r] = g[idx];
  }
}

// The reverse copy; rows r with skip[r] set (when skip is given) are not
// written.
template <int K>
__device__ __forceinline__ void dks_slab_to_rows(
    const float* slab, float* __restrict__ g, int rows, int m, int stride,
    const unsigned char* skip = nullptr) {
  const int fk = K << m;
  for (int idx = threadIdx.x; idx < rows * fk; idx += blockDim.x) {
    const int r = (idx >> m) / K;
    if (skip == nullptr || !skip[r])
      g[idx] = slab[(idx - r * fk) * stride + r];
  }
}

// The subset-combine closure of one node's table, in place.  The splits
// are enumerated in the order of spa.split_pairs(m): target sets t in
// popcount order (then ascending), and for each t every a < b with
// a | b == t, a & b == 0.  A set of popcount p reads only sets of smaller
// popcount, which are final by then, so one sweep reaches the closure:
// S[t] <- K smallest distinct of S[t] ∪ {min(S[a]_i + S[b]_j, INF)}.
template <int K>
__device__ void dks_combine_sweep(float* tab, int stride, int m) {
  const int n_sets = 1 << m;
  for (int p = 2; p <= m; ++p) {
    for (int t = 3; t < n_sets; ++t) {
      if (__popc(t) != p) continue;
      float r[K];
      dks_load<K>(tab, stride, t, r);
      for (int a = (t - 1) & t; a; a = (a - 1) & t) {
        const int b = t ^ a;
        if (a > b) continue;
        float av[K], bv[K];
        dks_load<K>(tab, stride, a, av);
        dks_load<K>(tab, stride, b, bv);
#pragma unroll
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            dks_insert<K>(r, fminf(__fadd_rn(av[i], bv[j]), DKS_INF));
        }
      }
      dks_store<K>(tab, stride, t, r);
    }
  }
}

// Threads per block for rows of fk floats: a multiple of 32 (so that
// lane_superstep's warp-per-hub rows get 32 slab columns), at most
// DKS_MAX_THREADS, as many as keep the slab within DKS_SLAB_AIM, and at
// least 32.  Up to fk = 2^5 * 4 = 128 that is the 48 KB the slab always
// had (fk = 24 gives 256 threads, fk = 128 gives 64); past 368 floats it
// is 32 threads and a slab of 33 rows, 66 KB at m = 6, K = 8 (fk = 512),
// which needs dks_allow_slab.
static inline int dks_block_threads(int fk) {
  int t = DKS_SLAB_AIM / (fk * (int)sizeof(float)) - 1;
  t = t / 32 * 32;
  if (t < 32) t = 32;
  return t > DKS_MAX_THREADS ? DKS_MAX_THREADS : t;
}

static inline size_t dks_slab_bytes(int fk, int threads) {
  return (size_t)fk * (size_t)(threads + 1) * sizeof(float);
}

// Let `kernel` take `bytes` of dynamic shared memory (past 48 KB a kernel
// must opt in); call before each launch.  Returns the CUDA error.
template <typename Kernel>
static inline cudaError_t dks_allow_slab(Kernel kernel, size_t bytes) {
  if (bytes > DKS_SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The switch over the instantiated K = 1..DKS_MAX_K: LAUNCH(K) for the
// run-time k.
#define DKS_SWITCH_K(k, LAUNCH) \
  switch (k) {                  \
    case 1: LAUNCH(1); break;   \
    case 2: LAUNCH(2); break;   \
    case 3: LAUNCH(3); break;   \
    case 4: LAUNCH(4); break;   \
    case 5: LAUNCH(5); break;   \
    case 6: LAUNCH(6); break;   \
    case 7: LAUNCH(7); break;   \
    case 8: LAUNCH(8); break;   \
  }

// ---------------------------------------------------------------------------
// The wide route: run-time m and K, one warp a row.
// ---------------------------------------------------------------------------

// Whether a wide row of f keyword sets of k slots fits one warp's share.
static inline bool dks_wide_fits(long long f, int k) {
  return f >= 1 && k >= 1 && f * k <= DKS_ROW_FLOATS;
}

// Rows (warps) a wide block takes for rows of fk floats.
static inline int dks_wide_warps(int fk) {
  int w = DKS_SLAB_AIM / (fk * (int)sizeof(float));
  if (w < 1) w = 1;
  return w > DKS_WIDE_WARPS ? DKS_WIDE_WARPS : w;
}

// dks_insert on a list of run-time length k in shared memory: insert x
// into the sorted, distinct, INF-padded r[0..k), keeping the k smallest
// distinct values (the same steps, so the same result).
__device__ __forceinline__ void dks_insert_list(float* r, int k, float x) {
  if (!(x < r[k - 1])) return;
  for (int j = 0; j < k; ++j) {
    const float y = r[j];
    if (x == y) return;
    if (x < y) {
      r[j] = x;
      x = y;
    }
  }
}

// One warp copies a row of fk floats (all lanes take part).
__device__ __forceinline__ void dks_warp_copy(float* __restrict__ to,
                                              const float* __restrict__ from,
                                              int fk) {
  for (int i = threadIdx.x & 31; i < fk; i += 32) to[i] = from[i];
}

// The subset-combine closure of one row (2^m sets of k floats, set f at
// row[f * k]) by the whole warp, in place.  A target set of popcount p
// reads only sets of smaller popcount, so the targets of one popcount are
// independent: warp lane j takes every 32nd of them (ascending), with a
// __syncwarp between popcounts.  Each lane runs dks_combine_sweep's steps
// for its targets; a split's (i, j) loops stop at the first candidate not
// below the list's last value (the lists are ascending and __fadd_rn is
// monotone, so every later candidate would be refused too).
__device__ void dks_combine_sweep_warp(float* row, int m, int k) {
  const int lane = threadIdx.x & 31;
  const int n_sets = 1 << m;
  for (int p = 2; p <= m; ++p) {
    int nth = 0;
    for (int t = 3; t < n_sets; ++t) {
      if (__popc(t) != p) continue;
      if ((nth++ & 31) != lane) continue;
      float* r = row + t * k;
      for (int a = (t - 1) & t; a; a = (a - 1) & t) {
        const int b = t ^ a;
        if (a > b) continue;
        const float* av = row + a * k;
        const float* bv = row + b * k;
        for (int i = 0; i < k; ++i) {
          const float x = av[i];
          if (!(fminf(__fadd_rn(x, bv[0]), DKS_INF) < r[k - 1])) break;
          for (int j = 0; j < k; ++j) {
            const float c = fminf(__fadd_rn(x, bv[j]), DKS_INF);
            if (!(c < r[k - 1])) break;
            dks_insert_list(r, k, c);
          }
        }
      }
    }
    __syncwarp();
  }
}
