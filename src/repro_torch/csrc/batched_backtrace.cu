// batched_backtrace: the answer-tree obligation walk of a whole lane
// bucket, one launch per bucket.
//
// Replaces no Pallas kernel: in the JAX package this walk is the jitted
// while_loop of src/repro/answers/batched.py (resolve and the cursor queue
// of `one`), vmapped over lanes and candidates.  Each candidate cell
// (root, value) of a lane's full-set column walks a queue of obligations
// (node v, keyword set s, value x) top-down; each obligation takes the
// host backtrace's *first* decomposition in its scan order:
//
// - leaf:  x <= tol at a node covering every keyword of s;
// - split: the first (pair p, slot i, slot j) with
//          |S[v,a_p,i] + S[v,b_p,j] - x| <= tol, slot i counting only while
//          every slot <= i is <= x + tol and < INF, slot j only while every
//          slot <= j is < INF (the host's early breaks);
// - edge:  the first (CSR neighbour d < min(degree_cap, deg v), slot j)
//          with w < INF, w <= x + tol, every slot <= j of S[u,s] < INF and
//          |S[u,s,j] - (x - w)| <= tol;
//
// and appends its children behind the cursor.  A dead end, or a queue
// that would outgrow `buffer` slots, marks the candidate failed (the
// caller re-runs the host search for it).  The records equal the JAX
// program's element for element, the sacrificial slot B included: every
// comparison is the reference's f32 arithmetic, with each add a single
// round-to-nearest (__fadd_rn / __fsub_rn, no contraction; build without
// --use_fast_math).
//
// What bounds it on the H100: latency, not bytes.  A bucket is a few dozen
// to a few hundred walks of a handful of obligations each, and every
// obligation is a chain of dependent loads (queue slot -> table row ->
// CSR range -> neighbour rows); the bytes it must move are the records it
// writes and the cells of the matches it finds, microseconds at
// 3.35 TB/s.
//
// Design: one warp per (lane, candidate), its queue (node, set, value,
// kind, children, edge) in shared memory, one obligation per round.  The
// warp finds the first match in scan order by ballot over consecutive
// chunks of 32 scan items: each lane tests one item (its prefix
// conditions re-read at most K cells, which the L1 holds), and the lowest
// set bit of the first non-empty ballot is the host's first choice.  Lane
// 0 appends the children; the warp re-reads the queue after __syncwarp.
// m is a run-time value: the leaf test gives warp lane i keyword i, so
// any m <= 32 works, and the tables bound it first (2^m * K <=
// BT_ROW_FLOATS, the DKS kernels' wide limit).  K is a template parameter
// for K = 1..8 at m <= 6 (the templated route, as the DKS kernels); every
// other (m, K) runs the same kernel with K a run-time value
// (batched_backtrace_kernel<0>, the wide route): nothing here keeps a
// K-vector in registers, so only the index arithmetic differs.  Nothing is
// allocated here; the wrapper allocates the records with torch.empty.
#include <cuda_runtime.h>

#define BT_INF 1e9f
#define BT_TOL 1e-3f
#define BT_WARPS 4          // candidates per block
#define BT_MAX_M 6          // the templated route: m <= 6, K <= 8
#define BT_MAX_K 8
#define BT_ROW_FLOATS 16384  // the wide route: 2^m * K floats a row
#define BT_MAX_BUFFER 2048  // 4 queues of 7 x 2049 words: <= 227 KB
#define BT_FULL 0xffffffffu

enum { BT_PENDING = 0, BT_LEAF = 1, BT_SPLIT = 2, BT_EDGE = 3, BT_FAIL = 4,
       BT_UNUSED = -1 };

// KT: the slot count K, or 0 for the run-time k_rt (the wide route).
template <int KT>
__global__ void __launch_bounds__(BT_WARPS * 32)
batched_backtrace_kernel(
    const float* __restrict__ S, const unsigned char* __restrict__ kw,
    const int* __restrict__ cand_idx, const float* __restrict__ cand_val,
    const long long* __restrict__ indptr, const int* __restrict__ esrc,
    const float* __restrict__ ew, const int* __restrict__ pa,
    const int* __restrict__ pb, int* __restrict__ out_node,
    int* __restrict__ out_kind, int* __restrict__ out_child0,
    int* __restrict__ out_child1, int* __restrict__ out_edge_u,
    unsigned char* __restrict__ out_fail, int n_cand, long long n_items,
    long long vp, int m, int n_pairs, int B, int degree_cap,
    long long n_nodes, int k_rt) {
  extern __shared__ int bt_smem[];
  const int K = KT > 0 ? KT : k_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * BT_WARPS + warp;
  if (item >= n_items) return;  // a whole warp leaves together
  const int Q = B + 1;          // slot B absorbs masked / overflowing writes
  int* node = bt_smem + warp * 7 * Q;
  int* ks = node + Q;
  float* vals = reinterpret_cast<float*>(node + 2 * Q);
  int* kind = node + 3 * Q;
  int* child0 = node + 4 * Q;
  int* child1 = node + 5 * Q;
  int* edge_u = node + 6 * Q;
  const int n_sets = 1 << m;
  const long long l = item / n_cand;
  const float* Sl = S + l * vp * n_sets * K;
  const unsigned char* kwl = kw + l * m * vp;

  for (int i = lane; i < Q; i += 32) {
    node[i] = 0;
    ks[i] = 0;
    vals[i] = 0.f;
    kind[i] = child0[i] = child1[i] = edge_u[i] = BT_UNUSED;
  }
  const float cv = cand_val[item];
  __syncwarp();
  if (lane == 0) {
    node[0] = cand_idx[item] / K;
    ks[0] = n_sets - 1;
    vals[0] = cv;
    kind[0] = BT_PENDING;
  }
  __syncwarp();
  int n = 1, it = 0;
  bool fail = !(cv < BT_INF);
  while (it < n && !fail) {  // uniform across the warp
    const int v = node[it], s = ks[it];
    const float x = vals[it];
    const float xt = __fadd_rn(x, BT_TOL);
    const float* Sv = Sl + (long long)v * n_sets * K;
    const bool ok = lane >= m || !((s >> lane) & 1) ||
                    kwl[(long long)lane * vp + v];
    const bool leaf = __all_sync(BT_FULL, ok) && x <= BT_TOL;
    int kd = leaf ? BT_LEAF : BT_FAIL;
    int c0n = 0, c0s = 0, c1s = 0, eu = 0;
    float c0v = 0.f, c1v = 0.f;
    if (!leaf) {
      // Split scan: items (p, i, j), p over the packed pairs of s.
      const int* par = pa + (long long)s * n_pairs;
      const int* pbr = pb + (long long)s * n_pairs;
      int n_p = 0;
      while (n_p < n_pairs && par[n_p] > 0) ++n_p;
      const int total = n_p * K * K;
      for (int q0 = 0; q0 < total; q0 += 32) {
        const int q = q0 + lane;
        bool match = false;
        if (q < total) {
          const int p = q / (K * K), i = (q / K) % K, j = q % K;
          const float* Sa = Sv + par[p] * K;
          const float* Sb = Sv + pbr[p] * K;
          bool pre = true;
          for (int t = 0; t <= i; ++t) {
            const float y = Sa[t];
            pre = pre && y <= xt && y < BT_INF;
          }
          for (int t = 0; t <= j; ++t) pre = pre && Sb[t] < BT_INF;
          match = pre &&
                  fabsf(__fsub_rn(__fadd_rn(Sa[i], Sb[j]), x)) <= BT_TOL;
        }
        const unsigned hit = __ballot_sync(BT_FULL, match);
        if (hit) {
          const int q1 = q0 + __ffs(hit) - 1;
          const int p = q1 / (K * K), i = (q1 / K) % K, j = q1 % K;
          kd = BT_SPLIT;
          c0n = v;
          c0s = par[p];
          c0v = Sv[par[p] * K + i];
          c1s = pbr[p];
          c1v = Sv[pbr[p] * K + j];
          break;
        }
      }
    }
    if (kd == BT_FAIL) {
      // Edge scan: items (d, j) over v's first min(degree_cap, deg) CSR
      // neighbours.
      long long start = 0, deg = 0;
      if (v < n_nodes) {
        start = indptr[v];
        deg = indptr[v + 1] - start;
      }
      const long long total = (deg < degree_cap ? deg : degree_cap) * K;
      for (long long q0 = 0; q0 < total; q0 += 32) {
        const long long q = q0 + lane;
        bool match = false;
        if (q < total) {
          const long long e = start + q / K;
          const int j = (int)(q % K);
          const float w = ew[e];
          if (w < BT_INF && w <= xt) {
            const float* Su = Sl + ((long long)esrc[e] * n_sets + s) * K;
            bool pre = true;
            for (int t = 0; t <= j; ++t) pre = pre && Su[t] < BT_INF;
            match = pre &&
                    fabsf(__fsub_rn(Su[j], __fsub_rn(x, w))) <= BT_TOL;
          }
        }
        const unsigned hit = __ballot_sync(BT_FULL, match);
        if (hit) {
          const long long q1 = q0 + __ffs(hit) - 1;
          const long long e = start + q1 / K;
          kd = BT_EDGE;
          eu = esrc[e];
          c0n = eu;
          c0s = s;
          c0v = Sl[((long long)eu * n_sets + s) * K + (int)(q1 % K)];
          break;
        }
      }
    }
    // The reference's queue update, slot for slot.
    const int new_n = n + (kd == BT_SPLIT ? 2 : (kd == BT_EDGE ? 1 : 0));
    fail = kd == BT_FAIL || new_n > B;
    const bool has0 = kd == BT_SPLIT || kd == BT_EDGE;
    const bool has1 = kd == BT_SPLIT;
    const int idx0 = has0 ? min(n, B) : B;
    const int idx1 = has1 ? min(n + 1, B) : B;
    if (lane == 0) {
      node[idx0] = c0n;
      node[idx1] = v;
      ks[idx0] = c0s;
      ks[idx1] = c1s;
      vals[idx0] = c0v;
      vals[idx1] = c1v;
      kind[idx0] = BT_PENDING;
      kind[idx1] = BT_PENDING;
      kind[it] = kd;
      child0[it] = has0 ? idx0 : BT_UNUSED;
      child1[it] = has1 ? idx1 : BT_UNUSED;
      edge_u[it] = kd == BT_EDGE ? eu : BT_UNUSED;
    }
    n = min(new_n, B);
    ++it;
    __syncwarp();
  }
  const long long o = item * B;
  for (int i = lane; i < B; i += 32) {
    out_node[o + i] = node[i];
    out_kind[o + i] = kind[i];
    out_child0[o + i] = child0[i];
    out_child1[o + i] = child1[i];
    out_edge_u[o + i] = edge_u[i];
  }
  if (lane == 0) out_fail[item] = fail;
}

// S: f32[lanes, vp, 2^m, k]; kw: bool[lanes, m, vp]; cand_idx: int32[lanes,
// n_cand] flat root * k + slot cells, cand_val: f32[lanes, n_cand]; indptr:
// int64[n_nodes + 1], esrc: int32[n_edges], ew: f32[n_edges] (n_edges >=
// 1); pa, pb: int32[2^m, n_pairs], each row's pairs packed first, then
// a = 0; outputs node, kind, child0, child1, edge_u: int32[lanes, n_cand,
// buffer], fail: bool[lanes, n_cand].  All contiguous, on the device.
// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int bt_batched_backtrace(
    const float* S, const unsigned char* kw, const int* cand_idx,
    const float* cand_val, const long long* indptr, const int* esrc,
    const float* ew, const int* pa, const int* pb, int* node, int* kind,
    int* child0, int* child1, int* edge_u, unsigned char* fail, int lanes,
    int n_cand, long long vp, int m, int k, int n_pairs, int buffer,
    int degree_cap, long long n_nodes, long long n_edges, void* stream) {
  if (m < 1 || m > 30 || k < 1 || (1LL << m) * k > BT_ROW_FLOATS ||
      lanes < 0 || n_cand < 0 || n_pairs < 1 || buffer < 1 ||
      buffer > BT_MAX_BUFFER || degree_cap < 1 || n_nodes < 0 ||
      n_edges < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)lanes * n_cand;
  if (n_items == 0) return 0;
  const long long blocks = (n_items + BT_WARPS - 1) / BT_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BT_WARPS * 7 * (buffer + 1) * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
#define BT_LAUNCH(KK)                                                       \
  err = cudaFuncSetAttribute(batched_backtrace_kernel<KK>,                  \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             (int)smem);                                    \
  if (err != cudaSuccess) return (int)err;                                  \
  batched_backtrace_kernel<KK><<<(unsigned)blocks, BT_WARPS * 32, smem, st>>>( \
      S, kw, cand_idx, cand_val, indptr, esrc, ew, pa, pb, node, kind,      \
      child0, child1, edge_u, fail, n_cand, n_items, vp, m, n_pairs,        \
      buffer, degree_cap, n_nodes, k)
  switch (m <= BT_MAX_M && k <= BT_MAX_K ? k : 0) {
    case 0: BT_LAUNCH(0); break;  // the wide route
    case 1: BT_LAUNCH(1); break;
    case 2: BT_LAUNCH(2); break;
    case 3: BT_LAUNCH(3); break;
    case 4: BT_LAUNCH(4); break;
    case 5: BT_LAUNCH(5); break;
    case 6: BT_LAUNCH(6); break;
    case 7: BT_LAUNCH(7); break;
    case 8: BT_LAUNCH(8); break;
  }
#undef BT_LAUNCH
  return (int)cudaGetLastError();
}
