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
//   run-time values, a row's table lives whole in shared memory and is
//   worked by a team of a warp's lanes (below), on a plan the wrapper
//   computes (ops.py::wide_plan).  padded_topk's wide kernel spreads a
//   row's keyword sets over a warp's lanes (padded_topk.cu).  Past K = 8
//   the templated route's registers spill, and past
//   m = 6 its slab of 33 rows outgrows the 227 KB a block may have.
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
// most 64 KB (m <= 10 at K <= 16).
#define DKS_ROW_FLOATS 16384

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
// The wide route: run-time m and K (dks_wide_fits, dks_insert_list).
// ---------------------------------------------------------------------------

// Whether a wide row of f keyword sets of k slots fits one warp's share.
static inline bool dks_wide_fits(long long f, int k) {
  return f >= 1 && k >= 1 && f * k <= DKS_ROW_FLOATS;
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

// ---------------------------------------------------------------------------
// The wide route's shared-memory tables and team-wide combine sweep
// (subset_combine_wide_kernel, lane_superstep_wide_kernel).
//
// A warp's share of shared memory holds `rows` tables of 2^m sets, set f
// of a table at f * ks, with ks = K rounded up to an odd number of floats
// (dks_wide_stride): lanes on adjacent sets, or on adjacent private lists,
// start on different banks (at K = 16 an even stride put 16 lanes on one
// bank).  Past them, when the plan spreads the combine, lie 32 private
// lists of ks floats, one a lane.  The host-side plan (rows a warp, warps a
// block, spread or not, bytes) is kernels/subset_combine/ops.py::wide_plan.
// A warp is cut into `rows` teams of 32 / rows lanes, one table each.
// ---------------------------------------------------------------------------

#define DKS_FULL_MASK 0xffffffffu

__host__ __device__ __forceinline__ int dks_wide_stride(int k) {
  return k | 1;
}

// Floats of one warp's share: `rows` tables and, if `spread`, 32 lists.
__host__ __device__ __forceinline__ int dks_wide_warp_floats(int m, int k,
                                                             int rows,
                                                             int spread) {
  const int ks = dks_wide_stride(k);
  return rows * (ks << m) + (spread ? 32 * ks : 0);
}

// Warps a block of the redesigned wide kernels has at most.  Their launch
// bounds ask for 12 (lane_superstep: 40 registers a thread) or 16
// (subset_combine: 32) such blocks an SM; on the H100 these ran faster
// than 8 blocks of 8 warps, or than 32 registers for lane_superstep,
// which then spilled (PERF.md §6).
#define DKS_WIDE_PLAN_WARPS 4

// Whether a plan is one the wide kernels take: 1..32 rows a warp (a power
// of two), 1..DKS_WIDE_PLAN_WARPS warps, within DKS_SMEM_MAX.
static inline bool dks_wide_plan_ok(int m, int k, int rows, int warps,
                                    int spread) {
  return m >= 1 && m <= 30 && dks_wide_fits(1LL << m, k) && rows >= 1 &&
         rows <= 32 && (rows & (rows - 1)) == 0 && warps >= 1 &&
         warps <= DKS_WIDE_PLAN_WARPS &&
         (size_t)warps * dks_wide_warp_floats(m, k, rows, spread) *
                 sizeof(float) <=
             DKS_SMEM_MAX;
}

// Copy n floats of consecutive rows (sets of k floats) from device memory
// into tables of stride ks, and back; lanes i0, i0 + step, ... take part.
// Float i is slot i % k of set i / k, both stepped along without dividing.
__device__ __forceinline__ void dks_rows_in(float* tab,
                                            const float* __restrict__ g,
                                            int n, int k, int ks, int i0,
                                            int step) {
  const int ds = step / k, dj = step - ds * k;
  int s = i0 / k, j = i0 - s * k;
  for (int i = i0; i < n; i += step) {
    tab[s * ks + j] = __ldg(g + i);
    s += ds;
    j += dj;
    if (j >= k) {
      j -= k;
      ++s;
    }
  }
}

// The reverse copy, of the rows r (set s >> m) whose bit r * team is set
// in `keep`.
__device__ __forceinline__ void dks_rows_out(float* __restrict__ g,
                                             const float* tab, int n, int k,
                                             int ks, int m, int i0, int step,
                                             unsigned keep, int team) {
  const int ds = step / k, dj = step - ds * k;
  int s = i0 / k, j = i0 - s * k;
  for (int i = i0; i < n; i += step) {
    if ((keep >> ((s >> m) * team)) & 1u) g[i] = tab[s * ks + j];
    s += ds;
    j += dj;
    if (j >= k) {
      j -= k;
      ++s;
    }
  }
}

// dks_insert_list for an ascending run of values: insert x into r (sorted,
// distinct, INF-padded, k long) searching from r[pos], where the run's
// earlier values left pos (every r[i < pos] is below x).  Returns false,
// changing nothing, once x is not below r's last value: then no later
// value of the run enters either.  The same steps as dks_insert_list, so
// the same list.
__device__ __forceinline__ bool dks_insert_run(float* r, int k, float x,
                                               int& pos) {
  if (!(x < r[k - 1])) return false;
  while (r[pos] < x) ++pos;  // stops by k - 1: x < r[k - 1]
  if (r[pos] != x) {         // not a duplicate: shift the tail, place x
    for (int q = k - 1; q > pos; --q) r[q] = r[q - 1];
    r[pos] = x;
  }
  return true;
}

// Merge the sorted, distinct, INF-padded list s into r (both k long): r
// becomes the k smallest distinct of both.
__device__ __forceinline__ void dks_merge_list(float* r, const float* s,
                                               int k) {
  int pos = 0;
  for (int j = 0; j < k && dks_insert_run(r, k, s[j], pos); ++j) {
  }
}

// The next larger int with the same popcount (Gosper): the targets of one
// popcount in ascending order.
__device__ __forceinline__ int dks_next_same_popc(int t) {
  const int c = t & -t;
  const int r = t + c;
  return (((r ^ t) >> 2) >> (__ffs(c) - 1)) | r;
}

// Fold the candidates min(S[a]_i + S[b]_j, INF) of every split a ⊎ b = t
// of the table at `row`, for the slots i with s * k + i ≡ part (mod L) of
// the s-th split, into the list `tr` (the target's own, L = 1) or into a
// private copy r of it (L > 1), made only once a candidate is below tr's
// last value.  Returns whether r holds one.  The splits are the subsets a
// of t without its top bit (b = t ^ a holds it, so a < b): each pair once,
// in another order than split_pairs', which changes no value.  A split's
// loops stop at the first candidate not below the list's last value: the
// lists are ascending and __fadd_rn is monotone, so every later one would
// be refused too, and the list's last value only falls.
__device__ __forceinline__ bool dks_split_into(float* tr, float* r,
                                               const float* row, int ks,
                                               int k, int t, int part,
                                               int L) {
  const int low = t ^ (1 << (31 - __clz(t)));  // t without its top bit
  const int kl = k % L;
  bool have = L == 1;
  float* cur = have ? tr : r;
  const float* lim = tr;  // the list candidates are held against
  int off = 0;            // (s * k) % L
  for (int a = low; a; a = (a - 1) & low) {
    int i = part - off;
    if (i < 0) i += L;
    off += kl;
    if (off >= L) off -= L;
    const float* av = row + a * ks;
    const float* bv = row + (t ^ a) * ks;
    const float b0 = bv[0];
    for (; i < k; i += L) {
      const float x = av[i];
      if (!(fminf(__fadd_rn(x, b0), DKS_INF) < lim[k - 1])) break;
      if (!have) {
        for (int j = 0; j < k; ++j) r[j] = tr[j];
        have = true;
        lim = r;
      }
      int pos = 0;  // the run x + b[j] is ascending in j
      for (int j = 0;
           j < k && dks_insert_run(cur, k, fminf(__fadd_rn(x, bv[j]), DKS_INF),
                                   pos);
           ++j) {
      }
    }
  }
  return have;
}

// The subset-combine closure of the table at `row` (2^m sets, stride ks),
// in place, by a team of T lanes of one warp (team lane tl).  Every lane
// of the warp calls it with the same m, k and T, and all with or all
// without private lists, since it syncs the warp between steps; a lane
// with work false (its team has no row) only keeps step.
//
// The targets of one popcount read only sets of smaller popcount, so they
// are independent.  Where a popcount has n < T targets and `priv` (the
// team's T private lists of ks floats) is given, each target gets
// L = T / n lanes: lane q of a target folds the (split s, slot i) with
// s * k + i ≡ q (mod L) into a private copy of the target's list, made at
// its first candidate below the list's last value, and the copies merge
// pairwise into the target's list.  Each copy holds the K smallest
// distinct of the list and a share of the candidates, so the merge is the
// K smallest distinct of the list and all of them: the same values as one
// lane folding them all in order.  Otherwise each lane takes every T-th
// target and folds into its list in place.
__device__ void dks_combine_team(float* row, float* priv, int m, int k,
                                 int ks, int T, int tl, bool work) {
  int n = m;  // C(m, p - 1), then C(m, p)
  for (int p = 2; p <= m; ++p) {
    n = n * (m - p + 1) / p;
    const int L = (priv != nullptr && n < T) ? T / n : 1;
    if (L == 1) {
      if (work && tl < n) {
        int t = (1 << p) - 1;
        for (int i = 0; i < tl; ++i) t = dks_next_same_popc(t);
        for (int i = tl;;) {
          dks_split_into(row + t * ks, nullptr, row, ks, k, t, 0, 1);
          i += T;
          if (i >= n) break;
          for (int j = 0; j < T; ++j) t = dks_next_same_popc(t);
        }
      }
    } else {
      const int nth = tl / L, q = tl - nth * L;
      const bool mine = work && nth < n;
      float* r = priv + tl * ks;
      int t = (1 << p) - 1;
      bool have = false;
      if (mine) {
        for (int i = 0; i < nth; ++i) t = dks_next_same_popc(t);
        have = dks_split_into(row + t * ks, r, row, ks, k, t, q, L);
      }
      for (int s = 1; s < L; s <<= 1) {
        __syncwarp();
        const bool other = __shfl_down_sync(DKS_FULL_MASK, have, s);
        if (mine && (q & (2 * s - 1)) == 0 && q + s < L && other) {
          if (have) {
            dks_merge_list(r, r + s * ks, k);
          } else {  // the other copy holds the list: take it
            for (int j = 0; j < k; ++j) r[j] = r[s * ks + j];
            have = true;
          }
        }
      }
      __syncwarp();
      if (mine && q == 0 && have)
        for (int j = 0; j < k; ++j) row[t * ks + j] = r[j];
    }
    __syncwarp();
  }
}
