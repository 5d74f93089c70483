// padded_topk: the padded-CSR relax reduce, per virtual row and keyword
// set the K smallest distinct of C candidates.
//
// Replaces the TPU kernel src/repro/kernels/segment_minplus/kernel.py,
// padded_topk (body _reduce_kernel): cand f32[Vv, C, F] -> out
// f32[Vv, F, K], ascending, INF-padded.  The TPU kernel takes K rounds of
// (min over C, mask every candidate <= that min to INF); this one inserts
// each candidate into a sorted, duplicate-free K-vector (dks_insert).  For
// candidates <= INF, which is what bump_to_inf leaves, both give the
// distinct values below INF in ascending order, then INF; every step is a
// compare, so the result is bit-identical to the plain version.  The
// candidate axis keeps the wrapper's layout: C = dmax * K slots with the
// keyword sets innermost (F consecutive floats per slot).
//
// What bounds it on the H100: device memory.  cand is read once and the
// output written once, (C + K) x F x 4 B per virtual row: at the
// paper-scale sec-rdfabout graph (m = 3, K = 3, dmax = 64, ~462k virtual
// rows) 2.8 GB, ~0.85 ms at 3.35 TB/s; a candidate costs a few compares.
//
// Design, simple first: one thread per (virtual row, keyword set), the
// K-vector in registers.  Neighbouring threads take neighbouring keyword
// sets of one row, so each of a warp's loads reads whole 32-byte sectors
// (F = 8: 4 rows x 8 sets), and the K outputs of a warp's threads are one
// contiguous span.  Any F works (it only sets the stride); K is 1..8, the
// instantiations.
//
// The wide route (K > 8, F * K <= DKS_ROW_FLOATS; see dks_lattice.cuh)
// is bound by its inserts more than by bytes: a list of run-time K lives
// in shared memory, and each candidate below the list's K-th value costs
// about K shared-memory steps.  So it spreads them over every lane and
// keeps the loads wide and ahead:
//
// - a warp walks rows (grid-stride), staging each row's candidates in
//   chunks of `chunk` candidates (a contiguous span of chunk * F floats)
//   into shared memory with cp.async, 16 bytes a copy where both ends are
//   aligned, double-buffered: the next chunk is in flight while this one
//   is inserted;
// - where F < 32, each keyword set has a team of `team` lanes (up to
//   32 / F; the host's plan, kernels/segment_minplus/ops.py::
//   topk_wide_plan), each lane keeping a partial K-list of its share of
//   the candidates (j = part, part + team, ...), pruned against the
//   partial's K-th value; at the row's end the partials merge pairwise
//   (a tree over the team) as the K smallest distinct of their union.
//   That is exact: dks_insert's result depends only on the value set.
//   Where F >= 32, a lane takes sets lane, lane + 32, ..., one list each;
// - lists sit at an odd stride (K | 1), so lanes on equal slots hit
//   distinct banks, and the warp writes the row's F * K outputs as one
//   contiguous span.
//
// Nothing is allocated here; the wrapper allocates the output.
#include <stdint.h>

#include "dks_lattice.cuh"

#define DKS_TOPK_WARPS 4  // warps a block of the wide route, at most

template <int K>
__global__ void __launch_bounds__(DKS_MAX_THREADS)
padded_topk_kernel(const float* __restrict__ cand, float* __restrict__ out,
                   long long rows, int c, int f) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * f) return;
  const long long row = t / f;
  const int set = (int)(t - row * f);
  const float* p = cand + row * c * f + set;
  float r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = DKS_INF;
#pragma unroll 8
  for (int j = 0; j < c; ++j) dks_insert<K>(r, __ldg(p + (long long)j * f));
  float* o = out + t * K;
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = r[j];
}

// cp.async: one 16- or 4-byte copy from device memory into shared memory.
__device__ __forceinline__ void pt_copy16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void pt_copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// One warp stages n floats: 16-byte copies where src and dst are both
// aligned, then the tail (or everything) in 4-byte copies; one commit
// group.
__device__ __forceinline__ void pt_stage(float* dst, const float* src,
                                         int n) {
  const int lane = threadIdx.x & 31;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const int n4 = n >> 2;
    for (int i = lane; i < n4; i += 32) pt_copy16(dst + 4 * i, src + 4 * i);
    head = n4 << 2;
  }
  for (int i = head + lane; i < n; i += 32) pt_copy4(dst + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Insert x < r[k - 1] into the sorted, distinct, INF-padded r[0..k): find
// its place, then shift the tail down one slot; a duplicate changes
// nothing.  The same list as dks_insert / dks_insert_list.
__device__ __forceinline__ void pt_insert(float* r, int k, float x) {
  int j = 0;
  while (r[j] < x) ++j;  // stops by k - 1: x < r[k - 1]
  if (r[j] == x) return;
  for (int t = k - 1; t > j; --t) r[t] = r[t - 1];
  r[j] = x;
}

// Merge the partial list o into r: the K smallest distinct of both.  o is
// ascending, so its first value not below r's K-th ends the merge.
__device__ __forceinline__ void pt_merge(float* r, const float* o, int k) {
  for (int q = 0; q < k; ++q) {
    const float y = o[q];
    if (!(y < r[k - 1])) return;
    pt_insert(r, k, y);
  }
}

// A warp's share of shared memory: two staging buffers of `stage` floats
// (>= chunk * f, a multiple of 4), then the lists: f * team partials of
// stride k | 1 where f < 32 (list part * f + set), else one a set.
__global__ void __launch_bounds__(DKS_TOPK_WARPS * 32)
padded_topk_wide_kernel(const float* __restrict__ cand,
                        float* __restrict__ out, long long rows, int c,
                        int f, int k, int team, int chunk, int stage,
                        int warp_floats) {
  extern __shared__ float4 pt_slab4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = reinterpret_cast<float*>(pt_slab4) +
               (size_t)warp * warp_floats;
  float* lists = buf + 2 * stage;
  const int ks = k | 1;
  const int n_lists = f < 32 ? f * team : f;
  const long long gw = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long nw = (long long)gridDim.x * (blockDim.x >> 5);
  if (gw >= rows) return;  // a whole warp leaves
  const int n_ch = (c + chunk - 1) / chunk;
  const long long steps = (rows - gw + nw - 1) / nw * n_ch;
  const int set = f < 32 ? lane % f : 0;
  const int part = f < 32 ? lane / f : 0;
  const bool teamed = f < 32 && part < team;
  for (int i = lane; i < n_lists * ks; i += 32) lists[i] = DKS_INF;
  pt_stage(buf, cand + gw * c * (long long)f, min(chunk, c) * f);
  for (long long st = 0; st < steps; ++st) {
    const int cur = (int)(st & 1);
    const int ch = (int)(st % n_ch);
    if (st + 1 < steps) {
      const long long row1 = gw + (st + 1) / n_ch * nw;
      const int c1 = (int)((st + 1) % n_ch) * chunk;
      pt_stage(buf + (cur ^ 1) * stage, cand + (row1 * c + c1) * f,
               min(chunk, c - c1) * f);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();
    const float* tile = buf + cur * stage;
    const int cnt = min(chunk, c - ch * chunk);
    if (f < 32) {
      if (teamed) {
        float* r = lists + lane * ks;  // lane == part * f + set
        float last = r[k - 1];
        for (int j = part; j < cnt; j += team) {
          const float x = tile[j * f + set];
          if (x < last) {
            pt_insert(r, k, x);
            last = r[k - 1];
          }
        }
      }
    } else {
      for (int s2 = lane; s2 < f; s2 += 32) {
        float* r = lists + s2 * ks;
        float last = r[k - 1];
        for (int j = 0; j < cnt; ++j) {
          const float x = tile[j * f + s2];
          if (x < last) {
            pt_insert(r, k, x);
            last = r[k - 1];
          }
        }
      }
    }
    __syncwarp();
    if (ch == n_ch - 1) {
      // The row is in: merge each team's partials into its part 0 (lists
      // 0 .. f - 1), write the row, and reset the lists.
      for (int step = 1; step < team; step <<= 1) {
        if (teamed && part % (2 * step) == 0 && part + step < team)
          pt_merge(lists + lane * ks, lists + (lane + step * f) * ks, k);
        __syncwarp();
      }
      float* o = out + (gw + st / n_ch * nw) * (long long)f * k;
      for (int i = lane; i < f * k; i += 32) {
        const int s2 = i / k;
        o[i] = lists[s2 * ks + (i - s2 * k)];
      }
      __syncwarp();
      for (int i = lane; i < n_lists * ks; i += 32) lists[i] = DKS_INF;
      __syncwarp();
    }
  }
}

// cand: f32[rows, c, f]; out: f32[rows, f, k]; contiguous, on the device;
// c >= k.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int dks_padded_topk(const float* cand, float* out, long long rows,
                               int c, int f, int k, void* stream) {
  if (k < 1 || k > DKS_MAX_K || c < k || f < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long blocks = (rows * f + DKS_MAX_THREADS - 1) / DKS_MAX_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
#define DKS_TOPK_LAUNCH(KK) \
  padded_topk_kernel<KK><<<g, DKS_MAX_THREADS, 0, s>>>(cand, out, rows, c, f)
  DKS_SWITCH_K(k, DKS_TOPK_LAUNCH)
#undef DKS_TOPK_LAUNCH
  return (int)cudaGetLastError();
}

// The wide route of dks_padded_topk (same layouts), for f * k <=
// DKS_ROW_FLOATS, on the host's plan (ops.py::topk_wide_plan): `team`
// lanes a set where f < 32 (1 <= team, f * team <= 32), `chunk`
// candidates staged a step, `stage` floats a staging buffer, `warp_floats`
// a warp's share, `warps` a block, `blocks` in the grid.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dks_padded_topk_wide(const float* cand, float* out,
                                    long long rows, int c, int f, int k,
                                    int team, int chunk, int stage,
                                    int warp_floats, int warps, int blocks,
                                    void* stream) {
  if (!dks_wide_fits(f, k) || c < k || rows < 0 || team < 1 ||
      (f < 32 ? f * team > 32 : team != 1) || chunk < 1 || chunk > c ||
      stage < chunk * f || stage % 4 != 0 ||
      warp_floats < 2 * stage + (f < 32 ? f * team : f) * (k | 1) ||
      warp_floats % 4 != 0 || warps < 1 || warps > DKS_TOPK_WARPS ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  cudaError_t err = dks_allow_slab(padded_topk_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  padded_topk_wide_kernel<<<(unsigned)blocks, warps * 32, smem,
                            (cudaStream_t)stream>>>(
      cand, out, rows, c, f, k, team, chunk, stage, warp_floats);
  return (int)cudaGetLastError();
}
