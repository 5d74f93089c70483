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
// to a few hundred walks of a handful to a few dozen obligations each, and
// every obligation is a chain of dependent loads (queue slot -> table row
// -> CSR range -> neighbour rows); the bytes it must move (records,
// candidates, and the cells and CSR entries its scans test before each
// first match: analysis/roofline.py::backtrace_work) take microseconds at
// 3.35 TB/s.  The walk's time is its longest walk's obligations times the
// dependent loads and block-wide rounds of each.
//
// Design: a block per (lane, candidate) walk of `warps` warps (1..8, the
// host's plan: kernels/batched_backtrace/ops.py::walk_plan, as many as
// keep every walk of the bucket resident at once), its queue (node, set,
// value, kind, children, edge) in shared memory, one obligation per round,
// every thread taking part in each scan:
//
// - leaf: warp lane i tests keyword i (m <= 14 here), in every warp;
// - split: a thread per keyword set of the pairs of s computes its prefix
//   length once (slots <= x + tol and < INF for a, < INF for b), then a
//   thread per (p, i) with i inside a's prefix loops j inside b's prefix:
//   each test is O(1) and the first j is the thread's;
// - edge: a thread per neighbour, BT_EDGES neighbours a thread a round
//   (T * BT_EDGES consecutive neighbours a round), each row's K cells
//   folded as they load (the widest loads their alignment allows on the
//   templated route, BT_CHUNK cells at a time on the wide one); the first
//   round's CSR entries load before the split scan, beside it.
//
// A round's first match in scan order is the least key (its index in the
// round, then its slot) over the block: a warp reduction
// (__reduce_min_sync), then one word a warp in shared memory and a
// barrier.  Thread 0 appends the children; the block re-reads the queue
// after a barrier.  K is a template parameter for K = 1..8 at m <= 6 (the
// templated route, as the DKS kernels); every other (m, K) runs the same
// kernel with K a run-time value (batched_backtrace_kernel<0>, the wide
// route).  Nothing is allocated here; the wrapper allocates the records
// with torch.empty.
#include <cuda_runtime.h>
#include <stdint.h>

#define BT_INF 1e9f
#define BT_TOL 1e-3f
#define BT_MAX_WARPS 8      // warps a walk at most
#define BT_MAX_M 6          // the templated route: m <= 6, K <= 8
#define BT_MAX_K 8
#define BT_ROW_FLOATS 16384  // the wide route: 2^m * K floats a row
#define BT_MAX_BUFFER 2048
#define BT_SMEM_MAX (227 * 1024)
#define BT_FULL 0xffffffffu
#define BT_EDGES 4          // neighbours a thread tests a round
#define BT_CHUNK 8          // cells the wide route loads at a time
#define BT_J_BITS 14        // a key's slot bits: j < BT_ROW_FLOATS = 2^14
#define BT_J_MASK ((1u << BT_J_BITS) - 1)
#define BT_NONE 0xffffffffu // no match in a round

enum { BT_PENDING = 0, BT_LEAF = 1, BT_SPLIT = 2, BT_EDGE = 3, BT_FAIL = 4,
       BT_UNUSED = -1 };

// A row of KT cells in registers, with the widest loads its alignment
// allows.
template <int KT>
__device__ __forceinline__ void bt_row(const float* __restrict__ p,
                                       float (&y)[KT]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (KT % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int t = 0; t < KT / 4; ++t) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + t);
      y[4 * t] = v.x;
      y[4 * t + 1] = v.y;
      y[4 * t + 2] = v.z;
      y[4 * t + 3] = v.w;
    }
  } else if (KT % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int t = 0; t < KT / 2; ++t) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p) + t);
      y[2 * t] = v.x;
      y[2 * t + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < KT; ++t) y[t] = __ldg(p + t);
  }
}

// Cells t0 .. t0 + BT_CHUNK - 1 of a row of K (INF past its end).
__device__ __forceinline__ void bt_chunk(const float* __restrict__ p, int t0,
                                         int K, float (&y)[BT_CHUNK]) {
#pragma unroll
  for (int q = 0; q < BT_CHUNK; ++q)
    y[q] = t0 + q < K ? __ldg(p + t0 + q) : BT_INF;
}

// How many leading slots of a row pass: y < INF, and y <= xt on a split's
// a side.
template <int KT>
__device__ __forceinline__ int bt_prefix(const float* __restrict__ p, int K,
                                         bool a_side, float xt) {
  if constexpr (KT > 0) {
    float y[KT];
    bt_row<KT>(p, y);
    int n = 0;
    bool live = true;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      live = live && y[t] < BT_INF && (!a_side || y[t] <= xt);
      n += live;
    }
    return n;
  } else {
    for (int t0 = 0; t0 < K; t0 += BT_CHUNK) {
      float y[BT_CHUNK];
      bt_chunk(p, t0, K, y);
#pragma unroll
      for (int q = 0; q < BT_CHUNK; ++q)
        if (!(y[q] < BT_INF && (!a_side || y[q] <= xt))) return t0 + q;
    }
    return K;
  }
}

// The split item (p, i) with a = S[v,a_p,i]: its first slot j < lb of b's
// row with |a + b_j - x| <= tol, or -1.
template <int KT>
__device__ __forceinline__ int bt_split_slot(const float* __restrict__ p,
                                             int K, int lb, float a,
                                             float x) {
  if constexpr (KT > 0) {
    float y[KT];
    bt_row<KT>(p, y);
    int j = -1;
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (j < 0 && t < lb &&
          fabsf(__fsub_rn(__fadd_rn(a, y[t]), x)) <= BT_TOL)
        j = t;
    return j;
  } else {
    for (int j = 0; j < lb; ++j)
      if (fabsf(__fsub_rn(__fadd_rn(a, __ldg(p + j)), x)) <= BT_TOL)
        return j;
    return -1;
  }
}

// A neighbour's first slot j whose prefix is < INF and |S[u,s,j] - xw| <=
// tol (xw = x - w), or -1.
template <int KT>
__device__ __forceinline__ int bt_edge_slot(const float* __restrict__ p,
                                            int K, float xw) {
  if constexpr (KT > 0) {
    float y[KT];
    bt_row<KT>(p, y);
    int j = -1;
    bool live = true;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      live = live && y[t] < BT_INF;
      if (j < 0 && live && fabsf(__fsub_rn(y[t], xw)) <= BT_TOL) j = t;
    }
    return j;
  } else {
    for (int t0 = 0; t0 < K; t0 += BT_CHUNK) {
      float y[BT_CHUNK];
      bt_chunk(p, t0, K, y);
#pragma unroll
      for (int q = 0; q < BT_CHUNK; ++q) {
        if (!(y[q] < BT_INF)) return -1;
        if (fabsf(__fsub_rn(y[q], xw)) <= BT_TOL) return t0 + q;
      }
    }
    return -1;
  }
}

// The CSR entries (w, u) of this thread's neighbours in the edge round at
// d0: d0 + r * T + tid for r < BT_EDGES (INF past the window).
__device__ __forceinline__ void bt_neighbours(
    const int* __restrict__ esrc, const float* __restrict__ ew,
    long long start, long long dn, long long d0, float (&w)[BT_EDGES],
    int (&u)[BT_EDGES]) {
#pragma unroll
  for (int r = 0; r < BT_EDGES; ++r) {
    const long long d = d0 + (long long)r * blockDim.x + threadIdx.x;
    const bool in = d < dn;
    w[r] = in ? __ldg(ew + start + d) : BT_INF;
    u[r] = in ? __ldg(esrc + start + d) : 0;
  }
}

// The least key over the block.  Round parity `par` alternates the words
// written, so one barrier a round suffices.
__device__ __forceinline__ unsigned bt_block_min(
    unsigned key, unsigned (*red)[BT_MAX_WARPS], int& par) {
  key = __reduce_min_sync(BT_FULL, key);
  if ((threadIdx.x & 31) == 0) red[par][threadIdx.x >> 5] = key;
  __syncthreads();
  unsigned best = red[par][0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    best = min(best, red[par][w]);
  par ^= 1;
  return best;
}

// KT: the slot count K, or 0 for the run-time k_rt (the wide route).
template <int KT>
__global__ void __launch_bounds__(BT_MAX_WARPS * 32)
batched_backtrace_kernel(
    const float* __restrict__ S, const unsigned char* __restrict__ kw,
    const int* __restrict__ cand_idx, const float* __restrict__ cand_val,
    const long long* __restrict__ indptr, const int* __restrict__ esrc,
    const float* __restrict__ ew, const int* __restrict__ pa,
    const int* __restrict__ pb, int* __restrict__ out_node,
    int* __restrict__ out_kind, int* __restrict__ out_child0,
    int* __restrict__ out_child1, int* __restrict__ out_edge_u,
    unsigned char* __restrict__ out_fail, int n_cand, long long vp, int m,
    int n_pairs, int B, int degree_cap, long long n_nodes, int k_rt) {
  extern __shared__ int bt_smem[];
  __shared__ unsigned bt_red[2][BT_MAX_WARPS];
  const int K = KT > 0 ? KT : k_rt;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const long long item = blockIdx.x;
  const int Q = B + 1;          // slot B absorbs masked / overflowing writes
  int* node = bt_smem;
  int* ks = node + Q;
  float* vals = reinterpret_cast<float*>(node + 2 * Q);
  int* kind = node + 3 * Q;
  int* child0 = node + 4 * Q;
  int* child1 = node + 5 * Q;
  int* edge_u = node + 6 * Q;
  int* pre = node + 7 * Q;      // the split's prefix lengths: a's, then b's
  const int n_sets = 1 << m;
  const long long l = item / n_cand;
  const float* Sl = S + l * vp * n_sets * K;
  const unsigned char* kwl = kw + l * m * vp;

  for (int i = tid; i < Q; i += T) {
    node[i] = 0;
    ks[i] = 0;
    vals[i] = 0.f;
    kind[i] = child0[i] = child1[i] = edge_u[i] = BT_UNUSED;
  }
  const float cv = cand_val[item];
  __syncthreads();
  if (tid == 0) {
    node[0] = cand_idx[item] / K;
    ks[0] = n_sets - 1;
    vals[0] = cv;
    kind[0] = BT_PENDING;
  }
  __syncthreads();
  int n = 1, it = 0, par = 0;
  bool fail = !(cv < BT_INF);
  while (it < n && !fail) {  // uniform across the block
    const int v = node[it], s = ks[it];
    const float x = vals[it];
    const float xt = __fadd_rn(x, BT_TOL);
    const float* Sv = Sl + (long long)v * n_sets * K;
    long long start = 0, deg = 0;
    if (v < n_nodes) {
      start = indptr[v];
      deg = indptr[v + 1] - start;
    }
    bool leaf = false;
    if (x <= BT_TOL) {
      const bool ok = lane >= m || !((s >> lane) & 1) ||
                      kwl[(long long)lane * vp + v];
      leaf = __all_sync(BT_FULL, ok);
    }
    int kd = leaf ? BT_LEAF : BT_FAIL;
    int c0n = 0, c0s = 0, c1s = 0, eu = 0;
    float c0v = 0.f, c1v = 0.f;
    // The edge scan's first round of CSR entries, loaded beside the split
    // scan.
    const long long dn = leaf ? 0 : (deg < degree_cap ? deg : degree_cap);
    float w[BT_EDGES];
    int u[BT_EDGES];
    bt_neighbours(esrc, ew, start, dn, 0, w, u);
    if (!leaf) {
      // Split scan: the packed pairs of s, counted by ballot in each warp.
      const int* par_ = pa + (long long)s * n_pairs;
      const int* pbr = pb + (long long)s * n_pairs;
      int n_p = 0;
      for (int p0 = 0; p0 < n_pairs; p0 += 32) {
        const int p = p0 + lane;
        const unsigned b =
            __ballot_sync(BT_FULL, p < n_pairs && __ldg(par_ + p) > 0);
        n_p += __popc(b);
        if (b != BT_FULL) break;
      }
      if (n_p > 0) {
        for (int t = tid; t < 2 * n_p; t += T) {
          const bool a_side = t < n_p;
          const int set = a_side ? __ldg(par_ + t) : __ldg(pbr + t - n_p);
          pre[t] = bt_prefix<KT>(Sv + (long long)set * K, K, a_side, xt);
        }
        __syncthreads();
        const int total = n_p * K;  // items (p, i); j loops in the thread
        for (int q0 = 0; q0 < total; q0 += T) {
          const int q = q0 + tid;
          unsigned key = BT_NONE;
          if (q < total) {
            const int p = q / K, i = q - p * K;
            if (i < pre[p]) {
              const float a = __ldg(Sv + (long long)__ldg(par_ + p) * K + i);
              const int j = bt_split_slot<KT>(
                  Sv + (long long)__ldg(pbr + p) * K, K, pre[n_p + p], a, x);
              if (j >= 0) key = ((unsigned)tid << BT_J_BITS) | (unsigned)j;
            }
          }
          const unsigned best = bt_block_min(key, bt_red, par);
          if (best != BT_NONE) {
            const int q1 = q0 + (int)(best >> BT_J_BITS);
            const int p = q1 / K, i = q1 - p * K;
            kd = BT_SPLIT;
            c0n = v;
            c0s = __ldg(par_ + p);
            c0v = __ldg(Sv + (long long)c0s * K + i);
            c1s = __ldg(pbr + p);
            c1v = __ldg(Sv + (long long)c1s * K + (int)(best & BT_J_MASK));
            break;
          }
        }
      }
    }
    if (kd == BT_FAIL) {
      // Edge scan: T * BT_EDGES neighbours a round, in CSR order.
      const long long span = (long long)T * BT_EDGES;
      for (long long d0 = 0; d0 < dn; d0 += span) {
        if (d0 > 0) bt_neighbours(esrc, ew, start, dn, d0, w, u);
        int jr[BT_EDGES];
#pragma unroll
        for (int r = 0; r < BT_EDGES; ++r)
          jr[r] = w[r] < BT_INF && w[r] <= xt
                      ? bt_edge_slot<KT>(
                            Sl + ((long long)u[r] * n_sets + s) * K, K,
                            __fsub_rn(x, w[r]))
                      : -1;
        unsigned key = BT_NONE;
#pragma unroll
        for (int r = BT_EDGES - 1; r >= 0; --r)
          if (jr[r] >= 0)
            key = ((unsigned)(r * T + tid) << BT_J_BITS) | (unsigned)jr[r];
        const unsigned best = bt_block_min(key, bt_red, par);
        if (best != BT_NONE) {
          const long long e = start + d0 + (best >> BT_J_BITS);
          kd = BT_EDGE;
          eu = __ldg(esrc + e);
          c0n = eu;
          c0s = s;
          c0v = __ldg(Sl + ((long long)eu * n_sets + s) * K +
                      (int)(best & BT_J_MASK));
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
    if (tid == 0) {
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
    __syncthreads();
  }
  const long long o = item * B;
  for (int i = tid; i < B; i += T) {
    out_node[o + i] = node[i];
    out_kind[o + i] = kind[i];
    out_child0[o + i] = child0[i];
    out_child1[o + i] = child1[i];
    out_edge_u[o + i] = edge_u[i];
  }
  if (tid == 0) out_fail[item] = fail;
}

// S: f32[lanes, vp, 2^m, k]; kw: bool[lanes, m, vp]; cand_idx: int32[lanes,
// n_cand] flat root * k + slot cells, cand_val: f32[lanes, n_cand]; indptr:
// int64[n_nodes + 1], esrc: int32[n_edges], ew: f32[n_edges] (n_edges >=
// 1); pa, pb: int32[2^m, n_pairs], each row's pairs packed first, then
// a = 0; outputs node, kind, child0, child1, edge_u: int32[lanes, n_cand,
// buffer], fail: bool[lanes, n_cand].  All contiguous, on the device.
// `warps`: warps a walk (1, 2, 4 or 8; ops.py::walk_plan).  Launches on
// `stream` and returns the CUDA error (0 on success).
extern "C" int bt_batched_backtrace(
    const float* S, const unsigned char* kw, const int* cand_idx,
    const float* cand_val, const long long* indptr, const int* esrc,
    const float* ew, const int* pa, const int* pb, int* node, int* kind,
    int* child0, int* child1, int* edge_u, unsigned char* fail, int lanes,
    int n_cand, long long vp, int m, int k, int n_pairs, int buffer,
    int degree_cap, long long n_nodes, long long n_edges, int warps,
    void* stream) {
  if (m < 1 || m > 30 || k < 1 || (1LL << m) * k > BT_ROW_FLOATS ||
      lanes < 0 || n_cand < 0 || n_pairs < 1 || buffer < 1 ||
      buffer > BT_MAX_BUFFER || degree_cap < 1 || n_nodes < 0 ||
      n_edges < 1 || warps < 1 || warps > BT_MAX_WARPS ||
      (warps & (warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)lanes * n_cand;
  if (n_items == 0) return 0;
  if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(7LL * (buffer + 1) + 2LL * n_pairs) * sizeof(int);
  if (smem > BT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
#define BT_LAUNCH(KK)                                                       \
  err = cudaFuncSetAttribute(batched_backtrace_kernel<KK>,                  \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             (int)smem);                                    \
  if (err != cudaSuccess) return (int)err;                                  \
  batched_backtrace_kernel<KK><<<(unsigned)n_items, warps * 32, smem, st>>>( \
      S, kw, cand_idx, cand_val, indptr, esrc, ew, pa, pb, node, kind,      \
      child0, child1, edge_u, fail, n_cand, vp, m, n_pairs, buffer,         \
      degree_cap, n_nodes, k)
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
