// flash_attention: causal GQA attention forward with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_bhsd (body _flash_kernel).  Query row i of head h sits at
// position q_offset + i and sees key j of KV head h / (Hq / Hkv) when
// j < Skv and j <= q_offset + i: the decoder's causal mask, the only one
// the port uses.  The arithmetic keeps the reference's order: S = Q K^T in
// the input type with f32 sums, times 1/sqrt(Dh); running max m, sum l and accumulator in f32; p cast to V's
// type before P V; out = acc / max(l, 1e-30) cast to Q's type.
//
// What bounds it on the H100: operations.  At the serving path's prefill
// (q bf16[4, 2048, 32, 128], k/v bf16[4, 2048, 2, 128]) the causal pairs
// need 1.38e11 FLOPs, 0.139 ms at 989 TFLOP/s, against 143 MB of q, k, v
// and o, 0.043 ms at 3.35 TB/s.
//
// Design, simple first: one block of 4 warps per (batch x query head, tile
// of 64 query rows), taking the model's [B, S, H, Dh] layout directly (no
// transpose, no padding: ragged edges are bound-checked and zero-filled).
// Q stays in shared memory; K/V tiles of 64 keys of the matching KV head
// stream through shared memory; each warp owns 16 query rows.  bf16 runs
// S = Q K^T and P V on the tensor cores with WMMA 16x16x16 (f32 sums);
// f32 runs them as scalar FMAs (exact f32, no TF32).  The softmax is
// scalar: two lanes per row, 32 columns each, m and l in registers, the
// running output (Dh/2 f32 per lane) in registers.  The loop stops at the
// last key tile the causal mask reaches (a skipped tile would add
// exp(-1e30 - m) = 0 and leave corr = 1), and the grid runs the heaviest
// query tiles first.  Not yet: wgmma, TMA, a pipelined K/V ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int WARPS = 4;     // warp w owns query rows 16w .. 16w + 15
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory layout.  Row strides carry a 16-byte pad, which spreads
// the rows over the banks and keeps every 16x16 WMMA tile 32-byte aligned.
template <typename T, int DH>
struct Smem {
  static constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int LD_T = DH + CH;       // Q, K, V rows
  static constexpr int LD_P = BK + CH;       // P rows (V's type)
  static constexpr int LD_S = BK + 4;        // S rows (f32)
  static constexpr int LD_O = DH + 4;        // P V rows of one tile (f32)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BQ * LD_T;
  static constexpr size_t v_off = k_off + sizeof(T) * BK * LD_T;
  static constexpr size_t s_off = v_off + sizeof(T) * BK * LD_T;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LD_S;
  static constexpr size_t o_off = p_off + sizeof(T) * BQ * LD_P;
  static constexpr size_t bytes = o_off + sizeof(float) * BQ * LD_O;
};

// rows x DH elements from global rows `stride` elements apart into shared
// rows `ld` apart, 16 bytes per thread per step; rows >= valid are zeros
// (so masked keys meet V = 0, never garbage).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int valid,
                                          int rows) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR = DH / CH;
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S[16 rows of warp, BK] = Q K^T: bf16 on the tensor cores.
template <int DH>
__device__ __forceinline__ void tile_scores(const bf16* sQ, const bf16* sK,
                                            float* sS, int warp, int) {
  using namespace nvcuda;
  using L = Smem<bf16, DH>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(c[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + warp * 16 * L::LD_T + kk * 16, L::LD_T);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      // K^T as a col-major matrix: element (d, key) at sK[key * LD_T + d].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + n * 16 * L::LD_T + kk * 16, L::LD_T);
      wmma::mma_sync(c[n], a, b, c[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n)
    wmma::store_matrix_sync(sS + warp * 16 * L::LD_S + n * 16, c[n], L::LD_S,
                            wmma::mem_row_major);
}

// S = Q K^T in f32 FMAs: lane (2 per row) computes its row's half.
template <int DH>
__device__ __forceinline__ void tile_scores(const float* sQ, const float* sK,
                                            float* sS, int warp, int lane) {
  using L = Smem<float, DH>;
  const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * (BK / 2);
  const float* qrow = sQ + r * L::LD_T;
  for (int j = 0; j < BK / 2; ++j) {
    const float* krow = sK + (c0 + j) * L::LD_T;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) acc = fmaf(qrow[d], krow[d], acc);
    sS[r * L::LD_S + c0 + j] = acc;
  }
}

// O[16 rows of warp, DH] = P V: bf16 on the tensor cores.
template <int DH>
__device__ __forceinline__ void tile_pv(const bf16* sP, const bf16* sV,
                                        float* sO, int warp, int) {
  using namespace nvcuda;
  using L = Smem<bf16, DH>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(c[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sP + warp * 16 * L::LD_P + kk * 16, L::LD_P);
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, sV + kk * 16 * L::LD_T + n * 16, L::LD_T);
      wmma::mma_sync(c[n], a, b, c[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < DH / 16; ++n)
    wmma::store_matrix_sync(sO + warp * 16 * L::LD_O + n * 16, c[n], L::LD_O,
                            wmma::mem_row_major);
}

// O = P V in f32 FMAs: lane computes its row's half of the columns.
template <int DH>
__device__ __forceinline__ void tile_pv(const float* sP, const float* sV,
                                        float* sO, int warp, int lane) {
  using L = Smem<float, DH>;
  const int r = warp * 16 + (lane >> 1), d0 = (lane & 1) * (DH / 2);
  const float* prow = sP + r * L::LD_P;
  for (int d = d0; d < d0 + DH / 2; ++d) {
    float acc = 0.f;
#pragma unroll 16
    for (int c = 0; c < BK; ++c) acc = fmaf(prow[c], sV[c * L::LD_T + d], acc);
    sO[r * L::LD_O + d] = acc;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int hq, int hkv, int q_offset, float scale) {
  using L = Smem<T, DH>;
  constexpr int CH = L::CH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q_off);
  T* sK = reinterpret_cast<T*>(smem + L::k_off);
  T* sV = reinterpret_cast<T*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  T* sP = reinterpret_cast<T*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;                     // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);                // GQA: q head h -> h // g
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const long long q_stride = (long long)hq * DH;     // elements per row
  const long long kv_stride = (long long)hkv * DH;
  const T* k_bh = k + (long long)b * skv * kv_stride + (long long)kvh * DH;
  const T* v_bh = v + (long long)b * skv * kv_stride + (long long)kvh * DH;
  const int q_rows = min(BQ, sq - q0);
  load_rows<T, DH>(sQ, L::LD_T,
                   q + ((long long)b * sq + q0) * q_stride + (long long)h * DH,
                   q_stride, q_rows, BQ);

  // Keys any row of this tile can see: up to the last row's position,
  // q_offset + q0 + q_rows - 1.
  const int kv_end = min(skv, q_offset + q0 + q_rows);
  const int n_tiles = (kv_end + BK - 1) / BK;

  const int half = lane & 1;
  const int r = warp * 16 + (lane >> 1);         // this lane's row
  const int qpos = q_offset + q0 + r;
  float m = NEG_INF, l = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int d = 0; d < DH / 2; ++d) acc[d] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, DH>(sK, L::LD_T, k_bh + k0 * kv_stride, kv_stride,
                     min(BK, skv - k0), BK);
    load_rows<T, DH>(sV, L::LD_T, v_bh + k0 * kv_stride, kv_stride,
                     min(BK, skv - k0), BK);
    __syncthreads();
    tile_scores<DH>(sQ, sK, sS, warp, lane);
    __syncwarp();

    // Online softmax over this lane's 32 columns; the row's other half is
    // the neighbouring lane.
    const int c0 = half * (BK / 2);
    float s[BK / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; j += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(sS + r * L::LD_S + c0 + j);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + c0 + j + i;
        const bool ok = kpos < skv && kpos <= qpos;
        s[j + i] = ok ? xs[i] * scale : NEG_INF;
        mx = fmaxf(mx, s[j + i]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; j += CH) {
      alignas(16) T pk[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float p = expf(s[j + i] - m_new);
        psum += p;
        pk[i] = from_f32<T>(p);
      }
      *reinterpret_cast<uint4*>(sP + r * L::LD_P + c0 + j) =
          *reinterpret_cast<const uint4*>(pk);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();
    tile_pv<DH>(sP, sV, sO, warp, lane);
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DH / 2; d += 4) {
      const float4 o = *reinterpret_cast<const float4*>(
          sO + r * L::LD_O + half * (DH / 2) + d);
      acc[d] = acc[d] * corr + o.x;
      acc[d + 1] = acc[d + 1] * corr + o.y;
      acc[d + 2] = acc[d + 2] * corr + o.z;
      acc[d + 3] = acc[d + 3] * corr + o.w;
    }
  }

  if (r < q_rows) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((long long)b * sq + q0 + r) * q_stride +
              (long long)h * DH + half * (DH / 2);
#pragma unroll
    for (int d = 0; d < DH / 2; d += CH) {
      alignas(16) T pk[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) pk[i] = from_f32<T>(acc[d + i] / denom);
      *reinterpret_cast<uint4*>(orow + d) = *reinterpret_cast<const uint4*>(pk);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int q_offset, float scale,
           cudaStream_t stream) {
  using L = Smem<T, DH>;
  auto kernel = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * hq), (unsigned)((sq + BQ - 1) / BQ));
  kernel<<<grid, THREADS, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int b, int sq, int skv, int hq, int hkv, int q_offset,
              float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, b, sq, skv, hq, hkv, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, b, sq, skv, hq, hkv, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, b, sq, skv, hq, hkv, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: [b, sq, hq, dh]; k, v: [b, skv, hkv, dh]; contiguous, 16-byte
// aligned, on the device; dtype 0 = f32, 1 = bf16; dh in {16, 32, 64, 128}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int skv, int hq, int hkv, int dh,
                                   int dtype, int q_offset, float scale,
                                   void* stream) {
  if (b < 0 || sq < 0 || skv < 1 || hkv < 1 || hq < hkv || hq % hkv ||
      q_offset < 0 || (dtype != 0 && dtype != 1) ||
      (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch_dh<float>(dh, q, k, v, out, b, sq, skv, hq, hkv,
                                q_offset, scale, s)
             : launch_dh<bf16>(dh, q, k, v, out, b, sq, skv, hq, hkv,
                               q_offset, scale, s);
}
