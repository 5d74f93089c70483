// lane_superstep: one whole DKS superstep's inner loop for every lane.
//
// Replaces the TPU kernel src/repro/kernels/lane_superstep/kernel.py,
// fused_lane_step (body _lane_step_kernel), and the candidate gather of its
// wrapper (ops.py, fused_lane_superstep).  For every lane l and node v:
// read S0[l, src] over v's in-edges, add w, mask by the sender's `changed`
// flag, bump values >= INF/2 to INF, keep the K smallest distinct per
// keyword set, merge with S0[l, v], run the subset-combine sweep over
// split_pairs(m), and, if done[l], write S0[l, v] back unchanged.  The
// output is S1[L, V, 2^m, K] in the engine's layout.
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
// Design: one thread per (lane, node) walks the node's in-edges straight
// from the dst-sorted DeviceGraph edge list through per-node offsets
// (int64[V+1]).  The TPU kernel's cand_t tensor (7 GB at paper scale), its
// rows-on-the-128-lane layout and the block-aligned LaneCSR with its hub
// merge are not carried over: candidates are formed in registers and folded
// straight into the node's own table, which sits in a shared-memory slab
// (loaded and stored with coalesced accesses).  Merging each candidate into
// S0[l, v] gives the same K smallest distinct values as the reference's
// relax-then-merge, because the result depends only on the value set.
// Edges whose weight is already >= INF/2 (hub cutoff) and inactive senders
// are skipped before their row is read.  Known weakness: a node's thread
// walks all of its in-edges alone, so high-degree nodes unbalance their
// warp.  Nothing is allocated here; the wrapper allocates with torch.empty.
#include "dks_lattice.cuh"

template <int K>
__global__ void __launch_bounds__(DKS_MAX_THREADS)
lane_superstep_kernel(const float* __restrict__ S0,
                      const unsigned char* __restrict__ changed,
                      const unsigned char* __restrict__ done,
                      const long long* __restrict__ offsets,
                      const int* __restrict__ src,
                      const float* __restrict__ w, float* __restrict__ out,
                      int lanes, long long n_nodes, int m) {
  extern __shared__ float slab[];
  const int n_sets = 1 << m;
  const int fk = n_sets * K;
  const int stride = blockDim.x + 1;
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const long long left = (long long)lanes * n_nodes - row0;
  const int rows = left < (long long)blockDim.x ? (int)left : (int)blockDim.x;
  dks_rows_to_slab(S0 + row0 * fk, slab, rows, fk, stride);
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    const long long row = row0 + threadIdx.x;
    const int l = (int)(row / n_nodes);
    const long long v = row - (long long)l * n_nodes;
    if (!done[l]) {  // a finished lane keeps its table: the slab holds S0
      float* tab = slab + threadIdx.x;
      const float* s0_lane = S0 + (long long)l * n_nodes * fk;
      const unsigned char* changed_lane = changed + (long long)l * n_nodes;
      const long long e_end = offsets[v + 1];
      for (long long e = offsets[v]; e < e_end; ++e) {
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
      dks_combine_sweep<K>(tab, stride, m);
    }
  }
  __syncthreads();
  dks_slab_to_rows(slab, out + row0 * fk, rows, fk, stride);
}

// S0, out: f32[lanes, n_nodes, 2^m, K]; changed: bool[lanes, n_nodes];
// done: bool[lanes]; offsets: int64[n_nodes + 1], node v's in-edges are
// src/w[offsets[v]:offsets[v+1]] of the dst-sorted edge list.  All
// contiguous, on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dks_lane_superstep(const float* S0,
                                  const unsigned char* changed,
                                  const unsigned char* done,
                                  const long long* offsets, const int* src,
                                  const float* w, float* out, int lanes,
                                  long long n_nodes, int m, int k,
                                  void* stream) {
  if (m < 1 || m > DKS_MAX_M || k < 1 || k > DKS_MAX_K || lanes < 0 ||
      n_nodes < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)lanes * n_nodes;
  if (n_rows == 0) return 0;
  const int fk = (1 << m) * k;
  const int threads = dks_block_threads(fk);
  const unsigned blocks = (unsigned)((n_rows + threads - 1) / threads);
  const size_t smem = dks_slab_bytes(fk, threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: lane_superstep_kernel<1><<<blocks, threads, smem, s>>>(S0, changed, done, offsets, src, w, out, lanes, n_nodes, m); break;
    case 2: lane_superstep_kernel<2><<<blocks, threads, smem, s>>>(S0, changed, done, offsets, src, w, out, lanes, n_nodes, m); break;
    case 3: lane_superstep_kernel<3><<<blocks, threads, smem, s>>>(S0, changed, done, offsets, src, w, out, lanes, n_nodes, m); break;
    case 4: lane_superstep_kernel<4><<<blocks, threads, smem, s>>>(S0, changed, done, offsets, src, w, out, lanes, n_nodes, m); break;
  }
  return (int)cudaGetLastError();
}
