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
// The wide route (K > 8, F * K <= DKS_ROW_FLOATS; see dks_lattice.cuh):
// one warp per virtual row, the row's F lists of K floats in the warp's
// share of shared memory (INF at first); warp lane j inserts the
// candidates of keyword sets f = j (mod 32), reading slot by slot, so
// neighbouring lanes read neighbouring floats, and the warp writes the
// row's F * K outputs as one contiguous span.
//
// Nothing is allocated here; the wrapper allocates the output.
#include "dks_lattice.cuh"

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

__global__ void __launch_bounds__(DKS_WIDE_WARPS * 32)
padded_topk_wide_kernel(const float* __restrict__ cand,
                        float* __restrict__ out, long long rows, int c,
                        int f, int k) {
  extern __shared__ float slab[];
  const int lane = threadIdx.x & 31;
  const int fk = f * k;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves
  float* tab = slab + (threadIdx.x >> 5) * fk;
  for (int i = lane; i < fk; i += 32) tab[i] = DKS_INF;
  __syncwarp();
  const float* p = cand + row * c * f;
  for (int set = lane; set < f; set += 32) {
    float* r = tab + set * k;
    for (int j = 0; j < c; ++j)
      dks_insert_list(r, k, __ldg(p + (long long)j * f + set));
  }
  __syncwarp();
  dks_warp_copy(out + row * fk, tab, fk);
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
// DKS_ROW_FLOATS.  Launches on `stream` and returns cudaGetLastError() (0
// on success).
extern "C" int dks_padded_topk_wide(const float* cand, float* out,
                                    long long rows, int c, int f, int k,
                                    void* stream) {
  if (!dks_wide_fits(f, k) || c < k || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int fk = f * k;
  const int warps = dks_wide_warps(fk);
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * fk * sizeof(float);
  cudaError_t err = dks_allow_slab(padded_topk_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  padded_topk_wide_kernel<<<(unsigned)blocks, warps * 32, smem,
                            (cudaStream_t)stream>>>(cand, out, rows, c, f, k);
  return (int)cudaGetLastError();
}
