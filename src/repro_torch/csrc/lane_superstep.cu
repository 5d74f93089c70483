// lane_superstep: one whole DKS superstep's inner loop for every lane.
//
// Replaces the TPU kernel src/repro/kernels/lane_superstep/kernel.py,
// fused_lane_step (body _lane_step_kernel), and the candidate gather and
// hub split of its wrapper (ops.py, fused_lane_superstep, LaneCSR).  For
// every lane l and node v: read S0[l, src] over v's in-edges, add w, mask
// by the sender's `changed` flag, bump values >= INF/2 to INF, keep the K
// smallest distinct per keyword set, merge with S0[l, v], run the
// subset-combine sweep over split_pairs(m), and, if done[l], write S0[l, v]
// back unchanged.  The output is S1[L, V, 2^m, K] in the engine's layout.
//
// What bounds it on the H100: device memory.  Per superstep it must read
// and write the own table, 2 * L * V * 2^m * K * 4 B, and read the in-edges'
// w (4 B each) and the src of the finite-weight ones (4 B each).  The rows
// that active senders pass on are bytes of that same table, so the least
// traffic reads them once; this design gathers one such row of
// 2^m * K * 4 B per (live lane, finite in-edge, active sender) on top, which
// only the caches can bring back toward the bound.  At paper scale
// (sec-rdfabout, V = 460,451, E_sym ~ 1.0 M, L=8, m=3, K=3) the least
// traffic is about 0.72 GB, or ~0.21 ms at 3.35 TB/s.
//
// Design: two kinds of work in one launch, both reading the dst-sorted
// DeviceGraph edge list straight through per-node offsets (int64[V+1]).
// The TPU kernel's cand_t tensor (7 GB at paper scale) and its
// rows-on-the-128-lane layout are not carried over: candidates are formed
// in registers and folded straight into a table in a shared-memory slab
// (loaded and stored with coalesced accesses).  Merging candidates into
// S0[l, v] in any order, or in parts that are merged afterwards, gives the
// same K smallest distinct values as the reference's relax-then-merge,
// because the result depends only on the value set.  Edges whose weight is
// already >= INF/2 (hub cutoff) and inactive senders are skipped before
// their row is read.
//
// - Light rows: one thread per (lane, node) of at most hub_degree
//   in-edges walks them alone, merging into its own slab column.
// - Hub rows (repro's LaneCSR splits them into virtual rows): a node with
//   more in-edges is in the hub list, and one warp per (lane, hub) takes
//   its edges with a stride of 32.  Warp lane i keeps a partial table in
//   slab column i (lane 0's starts as S0[l, v], the others' as INF); the
//   partials merge pairwise in 5 rounds into lane 0's column, which then
//   runs the combine sweep, and the warp writes the row.  The hub blocks
//   come first in the grid and the list is sorted by in-degree, so the
//   longest walks start first.  Light blocks load hub rows with the rest
//   and write nothing for them.
//
// The wide route (every other (m, K) up to 2^m * K = DKS_ROW_FLOATS; see
// dks_lattice.cuh and the host-side plan, kernels/subset_combine/ops.py::
// wide_plan).  Its least traffic is the same table read and written once;
// on the H100 it is bound by the latency of the dependent loads a row
// walks (edge, then sender flag, then sender row) and by the combine's
// inserts in shared memory, not by bytes.  The design:
//
// - In-edges are taken a batch at a time: each lane reads one edge's w
//   and src (the next batch's while this one is folded), then the
//   sender's `changed` flag; __ballot_sync picks the live edges (finite
//   weight, active sender) and only those are folded, each one's sender
//   and weight passed by __shfl_sync.  A dead edge costs a share of one
//   coalesced load instead of a chain of three.
// - A warp is cut into teams with a lane for each keyword set (up to 32):
//   at m = 3 a warp takes four light rows, one a team, so no lane idles.
// - Three kinds of rows, from the hub list (every node of more than
//   HUB_IN_DEGREE in-edges, most first): a node of more than hub_degree
//   (256) in-edges gets a block, whose warps take strides of its batches
//   into partial tables of their own, one a team, merged pairwise in
//   shared memory, then closed once and written once; the hub blocks come
//   first in the grid, longest first.  Every other listed node gets one
//   warp, whose teams share its batches the same way.  The rest (at most
//   HUB_IN_DEGREE in-edges) are light rows, one a team.  A light team
//   walking a row of hundreds of in-edges kept its whole block waiting.
// - The closure (dks_combine_team) runs over all of a row's lanes.
// - A set's candidates are an ascending run, inserted from where the run's
//   last one went (dks_insert_run); sets sit an odd number of floats apart.
// - Blocks of 4 warps, at most 40 registers a thread (DKS_WIDE_PLAN_WARPS).
//
// Nothing is allocated here; the wrapper allocates with torch.empty.
#include "dks_lattice.cuh"

// Fold the candidates of in-edges [e, e_end) (every `step`-th) of one
// (lane, node) into the table at `tab`.
template <int K>
__device__ __forceinline__ void relax_into(
    float* tab, int stride, int n_sets, const float* __restrict__ s0_lane,
    const unsigned char* __restrict__ changed_lane,
    const int* __restrict__ src, const float* __restrict__ w, long long e,
    long long e_end, int step) {
  const int fk = n_sets * K;
  for (; e < e_end; e += step) {
    const float we = w[e];
    if (!(we < DKS_HALF_INF)) continue;  // every candidate bumps to INF
    const int u = src[e];
    if (!changed_lane[u]) continue;       // the sender sends nothing
    const float* su = s0_lane + (long long)u * fk;
    for (int f = 0; f < n_sets; ++f) {
      float r[K];
      dks_load<K>(tab, stride, f, r);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float c = __fadd_rn(__ldg(su + f * K + j), we);
        dks_insert<K>(r, c >= DKS_HALF_INF ? DKS_INF : c);
      }
      dks_store<K>(tab, stride, f, r);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(DKS_MAX_THREADS)
lane_superstep_kernel(const float* __restrict__ S0,
                      const unsigned char* __restrict__ changed,
                      const unsigned char* __restrict__ done,
                      const long long* __restrict__ offsets,
                      const int* __restrict__ src,
                      const float* __restrict__ w,
                      const int* __restrict__ hubs, float* __restrict__ out,
                      int lanes, long long n_nodes, int n_hubs,
                      int hub_degree, int hub_blocks, int m) {
  extern __shared__ float slab[];
  __shared__ unsigned char skip[DKS_MAX_THREADS];
  const int n_sets = 1 << m;
  const int fk = n_sets * K;
  const int stride = blockDim.x + 1;
  if ((int)blockIdx.x < hub_blocks) {
    // ---- one warp per (lane, hub), hub-major: item = h * lanes + l ----
    const int lane = threadIdx.x & 31;
    const long long item =
        (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (item >= (long long)n_hubs * lanes) return;
    const int l = (int)(item % lanes);
    const long long v = hubs[item / lanes];
    // Only a node of this graph past the threshold: its row is the light
    // path's otherwise.
    if (v < 0 || v >= n_nodes || offsets[v + 1] - offsets[v] <= hub_degree)
      return;
    const float* s0_row = S0 + ((long long)l * n_nodes + v) * fk;
    float* out_row = out + ((long long)l * n_nodes + v) * fk;
    if (done[l]) {  // a finished lane keeps its table
      for (int i = lane; i < fk; i += 32) out_row[i] = s0_row[i];
      return;
    }
    float* tab = slab + threadIdx.x;
    float* tab0 = tab - lane;  // warp lane 0's column
    for (int i = 0; i < fk; ++i) tab[i * stride] = DKS_INF;
    __syncwarp();
    for (int i = lane; i < fk; i += 32) tab0[i * stride] = s0_row[i];
    __syncwarp();
    relax_into<K>(tab, stride, n_sets, S0 + (long long)l * n_nodes * fk,
                  changed + (long long)l * n_nodes, src, w,
                  offsets[v] + lane, offsets[v + 1], 32);
    for (int half = 16; half; half >>= 1) {
      __syncwarp();
      if (lane < half) {
        const float* other = tab + half;
        for (int f = 0; f < n_sets; ++f) {
          float r[K];
          dks_load<K>(tab, stride, f, r);
#pragma unroll
          for (int j = 0; j < K; ++j)
            dks_insert<K>(r, other[(f * K + j) * stride]);
          dks_store<K>(tab, stride, f, r);
        }
      }
    }
    if (lane == 0) dks_combine_sweep<K>(tab, stride, m);
    __syncwarp();
    for (int i = lane; i < fk; i += 32) out_row[i] = tab0[i * stride];
    return;
  }
  // ---- one thread per (lane, node); hub rows are left to the warps ----
  const long long row0 = (long long)(blockIdx.x - hub_blocks) * blockDim.x;
  const long long left = (long long)lanes * n_nodes - row0;
  const int rows = left < (long long)blockDim.x ? (int)left : (int)blockDim.x;
  dks_rows_to_slab<K>(S0 + row0 * fk, slab, rows, m, stride);
  int l = 0;
  long long v = 0, e0 = 0, e_end = 0;
  if ((int)threadIdx.x < rows) {
    const long long row = row0 + threadIdx.x;
    l = (int)(row / n_nodes);
    v = row - (long long)l * n_nodes;
    e0 = offsets[v];
    e_end = offsets[v + 1];
    skip[threadIdx.x] = e_end - e0 > hub_degree;
  }
  __syncthreads();
  // A finished lane keeps its table: the slab holds S0.
  if ((int)threadIdx.x < rows && !done[l] && !skip[threadIdx.x]) {
    float* tab = slab + threadIdx.x;
    relax_into<K>(tab, stride, n_sets, S0 + (long long)l * n_nodes * fk,
                  changed + (long long)l * n_nodes, src, w, e0, e_end, 1);
    dks_combine_sweep<K>(tab, stride, m);
  }
  __syncthreads();
  dks_slab_to_rows<K>(slab, out + row0 * fk, rows, m, stride, skip);
}

// S0, out: f32[lanes, n_nodes, 2^m, K]; changed: bool[lanes, n_nodes];
// done: bool[lanes]; offsets: int64[n_nodes + 1], node v's in-edges are
// src/w[offsets[v]:offsets[v+1]] of the dst-sorted edge list; hubs:
// int32[n_hubs], the nodes with more than hub_degree in-edges (any order;
// most in-edges first runs best; a node left out keeps an unwritten row,
// an entry that is not such a node is skipped).  All contiguous, on the
// device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dks_lane_superstep(const float* S0,
                                  const unsigned char* changed,
                                  const unsigned char* done,
                                  const long long* offsets, const int* src,
                                  const float* w, const int* hubs,
                                  float* out, int lanes, long long n_nodes,
                                  int n_hubs, int hub_degree, int m, int k,
                                  void* stream) {
  if (m < 1 || m > DKS_MAX_M || k < 1 || k > DKS_MAX_K || lanes < 0 ||
      n_nodes < 0 || n_hubs < 0 || n_hubs > n_nodes || hub_degree < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)lanes * n_nodes;
  if (n_rows == 0) return 0;
  const int fk = (1 << m) * k;
  const int threads = dks_block_threads(fk);
  const long long hub_warps = (long long)n_hubs * lanes;
  const long long hub_blocks = (hub_warps + threads / 32 - 1) / (threads / 32);
  const long long blocks = hub_blocks + (n_rows + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = dks_slab_bytes(fk, threads);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
#define DKS_LANE_LAUNCH(KK)                                                  \
  err = dks_allow_slab(lane_superstep_kernel<KK>, smem);                     \
  if (err != cudaSuccess) return (int)err;                                   \
  lane_superstep_kernel<KK><<<(unsigned)blocks, threads, smem, s>>>(         \
      S0, changed, done, offsets, src, w, hubs, out, lanes, n_nodes, n_hubs, \
      hub_degree, (int)hub_blocks, m)
  DKS_SWITCH_K(k, DKS_LANE_LAUNCH)
#undef DKS_LANE_LAUNCH
  return (int)cudaGetLastError();
}

// Fold the candidates of one live in-edge (sender row su, weight we) into
// the table at `tab`: team lane tl takes the sets f ≡ tl (mod T).  The
// sender's lists are ascending, so a set's candidates are an ascending run
// that stops at the first one not below its list's last value
// (dks_insert_run); they are read four at a time, so that four loads are
// in flight (all within the sender's set).
__device__ __forceinline__ void wide_fold_edge(float* tab, int ks, int k,
                                               int n_sets, int T, int tl,
                                               const float* __restrict__ su,
                                               float we) {
  for (int f = tl; f < n_sets; f += T) {
    float* r = tab + f * ks;
    const float* s = su + f * k;
    int pos = 0;
    bool more = true;
    for (int j0 = 0; more && j0 < k; j0 += 4) {
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = j0 + q < k ? __ldg(s + j0 + q) : DKS_INF;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c = __fadd_rn(x[q], we);
        more = more && dks_insert_run(r, k, c >= DKS_HALF_INF ? DKS_INF : c,
                                      pos);
      }
    }
  }
}

// The first of the next batch of in-edges a lane reads: w and src of edge
// e, where e < e_end (else INF and 0).
__device__ __forceinline__ void wide_edge(const int* __restrict__ src,
                                          const float* __restrict__ w,
                                          long long e, long long e_end,
                                          float& we, int& u) {
  we = DKS_INF;
  u = 0;
  if (e < e_end) {
    we = __ldg(w + e);
    u = __ldg(src + e);
  }
}

template <bool kBlock>
__device__ __forceinline__ void wide_sync() {
  if (kBlock)
    __syncthreads();
  else
    __syncwarp();
}

// One row (lane l, in-edges [e0, e1) of its node, S0's row s0_row) by
// n_warps warps: a hub block's (kBlock: every warp of the block, synced by
// __syncthreads) or one medium row's warp (n_warps 1).  `base` is the first
// warp's share of shared memory.  Warp w reads the batches of 32 in-edges
// b ≡ w (mod n_warps), w and src of the next batch while it folds this
// one, and deals the batch's live edges (finite weight, active sender) to
// its `rows` teams in turn; team g folds them into partial table
// p = w * rows + g.  Partial 0 starts as S0's row, the others as INF.  The
// partials merge pairwise into partial 0, which warp 0 closes
// (dks_combine_team over all 32 lanes) and writes to out_row.
template <bool kBlock>
__device__ void wide_row_by_warps(float* base, int warp, int n_warps,
                                  const float* __restrict__ s0_row,
                                  const float* __restrict__ s0_lane,
                                  const unsigned char* __restrict__ ch_lane,
                                  const int* __restrict__ src,
                                  const float* __restrict__ w, long long e0,
                                  long long e1, float* __restrict__ out_row,
                                  int m, int k, int rows, int spread) {
  const int lane = threadIdx.x & 31;
  const int n_sets = 1 << m, fk = n_sets * k, ks = dks_wide_stride(k);
  const int row_f = n_sets * ks;
  const int warp_f = dks_wide_warp_floats(m, k, rows, spread);
  const int T = 32 / rows, g = lane / T, tl = lane - g * T;
  float* wbase = base + warp * warp_f;
  for (int i = lane; i < rows * row_f; i += 32) wbase[i] = DKS_INF;
  __syncwarp();
  if (warp == 0) dks_rows_in(wbase, s0_row, fk, k, ks, lane, 32);
  __syncwarp();
  float* tab = wbase + g * row_f;
  const long long stride = 32LL * n_warps;
  long long e = e0 + 32LL * warp + lane;
  float we;
  int u;
  wide_edge(src, w, e, e1, we, u);
  while (__any_sync(DKS_FULL_MASK, e < e1)) {
    const bool live = e < e1 && we < DKS_HALF_INF && ch_lane[u] != 0;
    float wn;
    int un;
    wide_edge(src, w, e + stride, e1, wn, un);  // the next batch, meanwhile
    unsigned rest = __ballot_sync(DKS_FULL_MASK, live);
    while (rest) {  // the same on every lane of the warp
      unsigned x = rest;
      for (int i = 0; i < g; ++i) x &= x - 1;  // this team's: the g-th left
      const int sl = x ? __ffs(x) - 1 : 0;
      const int uu = __shfl_sync(DKS_FULL_MASK, u, sl);
      const float ww = __shfl_sync(DKS_FULL_MASK, we, sl);
      if (x)
        wide_fold_edge(tab, ks, k, n_sets, T, tl, s0_lane + (long long)uu * fk,
                       ww);
      for (int i = 0; i < rows && rest; ++i) rest &= rest - 1;
    }
    e += stride;
    we = wn;
    u = un;
  }
  wide_sync<kBlock>();
  // Merge the partials pairwise into partial 0, a (pair, set) a thread.
  const int P = n_warps * rows;
  const int tid = kBlock ? (int)threadIdx.x : lane;
  const int n_threads = kBlock ? (int)blockDim.x : 32;
  for (int s = 1; s < P; s <<= 1) {
    const int pairs = (P + 2 * s - 1) / (2 * s);
    for (int it = tid; it < pairs << m; it += n_threads) {
      const int d = 2 * s * (it >> m), f = it & (n_sets - 1);
      const int sp = d + s;
      if (sp < P)
        dks_merge_list(base + (d / rows) * warp_f + (d % rows) * row_f + f * ks,
                       base + (sp / rows) * warp_f + (sp % rows) * row_f +
                           f * ks,
                       k);
    }
    wide_sync<kBlock>();
  }
  if (warp != 0) return;
  dks_combine_team(base, spread ? base + rows * row_f : nullptr, m, k, ks, 32,
                   lane, true);
  __syncwarp();
  dks_rows_out(out_row, base, fk, k, ks, m, lane, 32, 1u, 32);
}

// Light rows: warp `warp` of light block j takes `rows` consecutive rows
// from ((j * n_warps) + warp) * rows, one a team of T = 32 / rows lanes,
// and leaves the rows of more than light_degree in-edges to the medium
// warps and hub blocks.  Each team reads its row's in-edges T at a time
// (w and src, then `changed` of the sender; the next batch meanwhile) and
// folds the live ones, each sender's sets over the team's lanes, into its
// table in shared memory; then it closes the table (dks_combine_team) and
// the warp writes its rows with coalesced stores.
__device__ void wide_light_rows(float* slab, const float* __restrict__ S0,
                                const unsigned char* __restrict__ changed,
                                const unsigned char* __restrict__ done,
                                const long long* __restrict__ offsets,
                                const int* __restrict__ src,
                                const float* __restrict__ w,
                                float* __restrict__ out, int lanes,
                                long long n_nodes, int light_degree, int m,
                                int k, int rows, int spread, long long block) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_sets = 1 << m, fk = n_sets * k, ks = dks_wide_stride(k);
  const int row_f = n_sets * ks;
  const int warp_f = dks_wide_warp_floats(m, k, rows, spread);
  const int T = 32 / rows, g = lane / T, tl = lane - g * T;
  const long long n_rows = (long long)lanes * n_nodes;
  const long long row0 = (block * n_warps + warp) * rows;
  if (row0 >= n_rows) return;  // a whole warp leaves
  const int nr = n_rows - row0 < rows ? (int)(n_rows - row0) : rows;
  const long long row = row0 + g;
  int l = 0;
  long long e = 0, e_end = 0;
  bool keep = false, work = false;
  if (g < nr) {
    l = (int)(row / n_nodes);
    const long long v = row - (long long)l * n_nodes;
    e = offsets[v];
    e_end = offsets[v + 1];
    keep = e_end - e <= light_degree;  // else a medium warp's or hub's row
    work = keep && !done[l];           // a finished lane keeps its table
  }
  float* wbase = slab + warp * warp_f;
  float* tab = wbase + g * row_f;
  dks_rows_in(wbase, S0 + row0 * fk, nr * fk, k, ks, lane, 32);
  __syncwarp();
  if (!work) e_end = e;
  const float* s0_lane = S0 + (long long)l * n_nodes * fk;
  const unsigned char* ch_lane = changed + (long long)l * n_nodes;
  const unsigned team = T == 32 ? DKS_FULL_MASK : ((1u << T) - 1) << (g * T);
  e += tl;
  float we;
  int u;
  wide_edge(src, w, e, e_end, we, u);
  while (__any_sync(DKS_FULL_MASK, e < e_end)) {
    const bool live = e < e_end && we < DKS_HALF_INF && ch_lane[u] != 0;
    float wn;
    int un;
    wide_edge(src, w, e + T, e_end, wn, un);  // the next batch, meanwhile
    unsigned mine = __ballot_sync(DKS_FULL_MASK, live) & team;
    while (__any_sync(DKS_FULL_MASK, mine != 0)) {
      const int sl = mine ? __ffs(mine) - 1 : lane;
      const int uu = __shfl_sync(DKS_FULL_MASK, u, sl);
      const float ww = __shfl_sync(DKS_FULL_MASK, we, sl);
      if (mine)
        wide_fold_edge(tab, ks, k, n_sets, T, tl, s0_lane + (long long)uu * fk,
                       ww);
      mine &= mine - 1;
    }
    e += T;
    we = wn;
    u = un;
  }
  __syncwarp();
  dks_combine_team(tab, spread ? wbase + rows * row_f + g * T * ks : nullptr,
                   m, k, ks, T, tl, work);
  __syncwarp();
  const unsigned keep_bits = __ballot_sync(DKS_FULL_MASK, keep && tl == 0);
  dks_rows_out(out + row0 * fk, wbase, nr * fk, k, ks, m, lane, 32,
               keep_bits, T);
}

// Three kinds of blocks, in this order in the grid: hub blocks, one for
// each (hub entry h < n_hubs, lane l), h-major: a node of more than
// hub_degree in-edges, walked by all the block's warps; medium blocks,
// whose warps take the entries of the whole hub list (n_list), one
// (entry, lane) a warp: a node of more than light_degree and at most
// hub_degree in-edges, walked by that warp's teams; then light blocks.
// Any other entry is skipped by both.  A finished lane's row is S0's.
__global__ void __launch_bounds__(DKS_WIDE_PLAN_WARPS * 32, 12)
lane_superstep_wide_kernel(const float* __restrict__ S0,
                           const unsigned char* __restrict__ changed,
                           const unsigned char* __restrict__ done,
                           const long long* __restrict__ offsets,
                           const int* __restrict__ src,
                           const float* __restrict__ w,
                           const int* __restrict__ hubs,
                           float* __restrict__ out, int lanes,
                           long long n_nodes, long long n_list,
                           int light_degree, int hub_degree,
                           long long hub_blocks, long long medium_blocks,
                           int m, int k, int rows, int spread) {
  extern __shared__ float slab[];
  const long long b = blockIdx.x;
  if (b >= hub_blocks + medium_blocks) {
    wide_light_rows(slab, S0, changed, done, offsets, src, w, out, lanes,
                    n_nodes, light_degree, m, k, rows, spread,
                    b - hub_blocks - medium_blocks);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool hub = b < hub_blocks;
  const long long item = hub ? b : (b - hub_blocks) * n_warps + warp;
  if (item >= n_list * lanes) return;  // past the list: a whole warp leaves
  const int l = (int)(item % lanes);
  const long long v = hubs[item / lanes];
  // Only a node of this graph with this kind's in-degree.
  if (v < 0 || v >= n_nodes) return;
  const long long e0 = offsets[v], e1 = offsets[v + 1];
  if (hub ? e1 - e0 <= hub_degree
          : (e1 - e0 <= light_degree || e1 - e0 > hub_degree))
    return;
  const int fk = k << m;
  const long long row = (long long)l * n_nodes + v;
  const float* s0_row = S0 + row * fk;
  float* out_row = out + row * fk;
  if (done[l]) {  // a finished lane keeps its table
    for (int i = hub ? threadIdx.x : lane; i < fk; i += hub ? blockDim.x : 32)
      out_row[i] = s0_row[i];
    return;
  }
  const float* s0_lane = S0 + (long long)l * n_nodes * fk;
  const unsigned char* ch_lane = changed + (long long)l * n_nodes;
  if (hub)
    wide_row_by_warps<true>(slab, warp, n_warps, s0_row, s0_lane, ch_lane,
                            src, w, e0, e1, out_row, m, k, rows, spread);
  else
    wide_row_by_warps<false>(
        slab + warp * dks_wide_warp_floats(m, k, rows, spread), 0, 1, s0_row,
        s0_lane, ch_lane, src, w, e0, e1, out_row, m, k, rows, spread);
}

// The wide route of dks_lane_superstep (same layouts), for
// 2^m * k <= DKS_ROW_FLOATS, on the plan of
// kernels/subset_combine/ops.py::wide_plan: `rows` light rows a warp (and
// partials a warp in a hub block or medium warp), `warps` warps a block,
// private lists for the combine if `spread`.  hubs: int32[n_list], every
// node of more than light_degree in-edges (any order, entries that are not
// such nodes skipped; a node left out keeps an unwritten row), those of
// more than hub_degree among its first n_hubs entries (most in-edges first
// runs best).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int dks_lane_superstep_wide(const float* S0,
                                       const unsigned char* changed,
                                       const unsigned char* done,
                                       const long long* offsets,
                                       const int* src, const float* w,
                                       const int* hubs, float* out,
                                       int lanes, long long n_nodes,
                                       long long n_list, long long n_hubs,
                                       int light_degree, int hub_degree,
                                       int m, int k, int rows, int warps,
                                       int spread, void* stream) {
  if (!dks_wide_plan_ok(m, k, rows, warps, spread) || lanes < 0 ||
      n_nodes < 0 || n_list < 0 || n_hubs < 0 || n_hubs > n_list ||
      light_degree < 0 || hub_degree < light_degree)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)lanes * n_nodes;
  if (n_rows == 0) return 0;
  const long long hub_blocks = n_hubs * lanes;
  const long long medium_blocks = (n_list * lanes + warps - 1) / warps;
  const long long per_block = (long long)warps * rows;
  const long long blocks =
      hub_blocks + medium_blocks + (n_rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)warps * dks_wide_warp_floats(m, k, rows, spread) * sizeof(float);
  cudaError_t err = dks_allow_slab(lane_superstep_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lane_superstep_wide_kernel<<<(unsigned)blocks, warps * 32, smem,
                               (cudaStream_t)stream>>>(
      S0, changed, done, offsets, src, w, hubs, out, lanes, n_nodes, n_list,
      light_degree, hub_degree, hub_blocks, medium_blocks, m, k, rows,
      spread);
  return (int)cudaGetLastError();
}
