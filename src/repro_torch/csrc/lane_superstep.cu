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
