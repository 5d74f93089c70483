// flash_attention: causal GQA attention forward with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_bhsd (body _flash_kernel).  Query row i of head h sits at
// position q_offset + i and sees key j of KV head h / (Hq / Hkv) when
// j < Skv and j <= q_offset + i: the decoder's causal mask, the only one
// the port uses.  The arithmetic keeps the reference's order: S = Q K^T in
// the input type with f32 sums, times 1/sqrt(Dh); running max m, sum l and
// accumulator in f32; p cast to V's type before P V; out = acc /
// max(l, 1e-30) cast to Q's type (the "wgmma" route multiplies by that
// reciprocal, taken once per row).
//
// What bounds it on the H100: operations.  At the serving path's prefill
// (q bf16[4, 2048, 32, 128], k/v bf16[4, 2048, 2, 128]) the causal pairs
// need 1.38e11 FLOPs, 0.139 ms at 989 TFLOP/s, against 143 MB of q, k, v
// and o, 0.043 ms at 3.35 TB/s.
//
// Two routes, chosen statically by dtype and head dim in
// flash_attention_fwd (never a fallback: a route that fails raises):
//
// "wgmma" (bf16, Dh 64 and 128: every full-width LM config) — namespace
// hopper below.  One block of three warpgroups per (batch x query head,
// 128 query rows): two consumer warpgroups of 64 rows each and one
// producer warpgroup (setmaxnreg moves registers to the consumers).  The
// producer's one thread loads Q once and streams K and V of the matching
// KV head through a 2-stage ring with TMA (tensor maps over the model's
// [B, S, H, Dh] layout, 128-byte swizzle, boxes of 128 rows x 64 columns,
// zero fill past the ends), with full and empty mbarriers per stage.  The
// consumers run S = Q K^T as wgmma m64n128k16 from shared memory, the
// online softmax on the accumulator registers (quad shuffles for the row
// max and sum, ex2 with 1/sqrt(Dh) * log2(e) folded into one scale, masks
// only on tiles that cross the diagonal or the end of the keys), and
// O += P V as wgmma with P as bf16 in registers and V read MN-major: S, P
// and O never touch shared memory until the epilogue.  What keeps the
// tensor cores busy: tile t's S product is issued beside tile t - 1's
// P V product, so the softmax of t runs while P V finishes, and the two
// warpgroups take turns to issue (named barriers), so one's softmax runs
// beside the other's products.  Both warpgroups run every tile of the
// block (a tile a row cannot see gives it p = 0), so every branch around
// the products is uniform and ptxas serializes none of them.  The
// epilogue scales O by 1 / l once per row, stages it in the warpgroup's
// own rows of the Q tile and writes it with a TMA store.
//
// "wmma" (f32 at every head dim, bf16 at Dh 16 and 32; the smoke configs)
// — the anonymous namespace below.  One block of 4 warps per (batch x
// query head, 64 query rows); Q in shared memory, K/V tiles of 64 keys
// loaded synchronously; bf16 products on WMMA 16x16x16, f32 products as
// scalar FMAs (exact f32, no TF32); a scalar softmax, two lanes per row.
//
// Both stop at the last key tile the causal mask reaches (a skipped tile
// would add exp(-inf) = 0 and leave the running sums as they are), and
// both run the heaviest query tiles first.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
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

// ===================== "wgmma": the Hopper route =====================
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;         // query rows per block (two warpgroups)
constexpr int BN = 128;         // keys per K/V tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 384;    // warpgroups 0, 1: consumers; 2: producer
constexpr int BOX_BYTES = 128 * 128;   // one TMA box: 128 rows x 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: Q, then the K ring, then the V ring, each tile DH / 64
// boxes of 128 rows x 128 bytes (swizzled), then the mbarriers.  Offsets
// are from a 1024-byte aligned base (the 128-byte swizzle's atom).
template <int DH>
struct Layout {
  static constexpr int BOXES = DH / 64;
  static constexpr int TILE = BOXES * BOX_BYTES;
  static constexpr int q_off = 0;
  static constexpr int k_off = TILE;
  static constexpr int v_off = k_off + STAGES * TILE;
  static constexpr int bar_off = v_off + STAGES * TILE;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int bytes = bar_off + (1 + 4 * STAGES) * 8 + 1024;
};

// 2^x on the special-function unit (relative error ~2^-22; -inf -> 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// One TMA box at coordinates (column, head, position, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(pos), "r"(batch)
      : "memory");
}

// One TMA box from shared memory to coordinates (column, head, position,
// batch); the parts past the tensor's ends are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int head,
                                          int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(pos), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barriers (0 is __syncthreads'): 1 and 2 pass the turn between the
// consumer warpgroups, 3 and 4 close each one's epilogue.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous window (the asm statements stay in order).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A and B from shared memory,
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A (bf16 pairs) from registers,
// B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A (bf16 pairs) from registers,
// B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map, int sq, int skv,
                 int hq, int hkv, int q_offset, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq_tile = base + L::q_off;
  const uint32_t bar = base + L::bar_off;   // 8 bytes per barrier
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bar + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar + 8u * (1 + 3 * STAGES + s); };
  auto k_tile = [&](int s) { return base + L::k_off + s * L::TILE; };
  auto v_tile = [&](int s) { return base + L::v_off + s * L::TILE; };

  const int bh = blockIdx.x;                    // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);               // GQA: q head h -> h // g
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest tiles first
  const int q_rows = min(BM, sq - q0);
  // Keys any row of this block can see: up to the last row's position.
  const int kv_end = min(skv, q_offset + q0 + q_rows);
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 256);   // every consumer thread arrives
      mbar_init(v_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::TILE);
      for (int x = 0; x < L::BOXES; ++x)
        tma_load(sq_tile + x * BOX_BYTES, &q_map, q_full, 64 * x, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), L::TILE);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(k_tile(s) + x * BOX_BYTES, &k_map, k_full(s), 64 * x, kvh,
                   t * BN, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), L::TILE);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(v_tile(s) + x * BOX_BYTES, &v_map, v_full(s), 64 * x, kvh,
                   t * BN, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t_in = threadIdx.x % 128;
    const int warp = t_in / 32, lane = t_in % 32;
    const int g = lane / 4, c = lane % 4;
    // This thread's two rows (of the block) and their positions.
    const int row0 = 64 * wg + 16 * warp + g;
    const int pos0 = q_offset + q0 + row0;
    const int wg_lo = q_offset + q0 + 64 * wg;    // the warpgroup's rows
    const float sl2 = scale * LOG2E;
    const uint32_t q_wg = sq_tile + wg * 64 * 128;   // row 64*wg of a box

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sc[64];
    uint32_t p[32];

    // S = Q K^T of the K tile in stage s, into sc (asynchronous).
    auto issue_s = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc(q_wg + off, 16, 1024),
                      desc(k_tile(s) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the V tile in stage s (asynchronous).  The S
    // accumulator's layout is the A operand's: k-step kk takes keys
    // 16 kk .. 16 kk + 15, i.e. p[4 kk .. 4 kk + 3].
    auto issue_pv = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_pv<DH>(o, a, desc(v_tile(s) + kk * 16 * 128, BOX_BYTES, 1024));
      }
      wgmma_commit();
    };
    // The online softmax of tile t on sc, in place (sc becomes f32 p), and
    // the factors the running output is to be scaled by.  A tile none of
    // whose keys a row sees gives that row p = 0 and a factor of 1.
    auto softmax = [&](int t, float (&corr)[2]) {
      const int k0 = t * BN;
      // Mask only where the tile crosses the diagonal or the keys' end.
      if (k0 + BN - 1 > wg_lo || k0 + BN > skv) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int key = k0 + 8 * n + 2 * c + j;
              if (key > pos0 + 8 * i || key >= skv)
                sc[4 * n + 2 * i + j] = -INFINITY;
            }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // Key 0 lies in tile 0 and every row sees it, so m stays finite.
        const float m_new = fmaxf(m[i], mx * sl2);
        corr[i] = ex2_approx(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e =
                ex2_approx(fmaf(sc[4 * n + 2 * i + j], sl2, -m_new));
            sc[4 * n + 2 * i + j] = e;
            sum += e;
          }
        l[i] = l[i] * corr[i] + sum;   // this thread's share of the row
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[4 * kk + r] =
              pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2): one's softmax runs beside the other's products.
    // Warpgroup 1 lets warpgroup 0 go first and skips its last hand-over,
    // which no one would wait for.
    auto turn = [&]() { named_sync(1 + wg, 256); };
    auto hand_over = [&](bool last) {
      if (wg == 0 || !last) named_arrive(2 - wg, 256);
    };
    if (wg == 1) named_arrive(1, 256);

    // Every warpgroup runs every tile of the block: all branches around
    // the products are uniform, so none of them is serialized.  Tile t's
    // S product runs beside tile t - 1's P V product, and its softmax
    // while that P V product finishes.
    float corr[2];
    mbar_wait(q_full, 0);
    turn();
    mbar_wait(k_full(0), 0);
    issue_s(0);
    hand_over(false);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty(0));
    softmax(0, corr);   // o is 0: nothing to scale
    pack_p();
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      turn();
      mbar_wait(k_full(s), (t / STAGES) & 1);
      issue_s(s);
      mbar_wait(v_full(sp), ((t - 1) / STAGES) & 1);
      issue_pv(sp);
      hand_over(false);
      wgmma_wait<1>();   // S of tile t; P V of tile t - 1 may run on
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      softmax(t, corr);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);     // the product read p until here
      mbar_arrive(v_empty(sp));
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
      pack_p();
    }
    {
      const int sl = (n_tiles - 1) % STAGES;
      turn();
      mbar_wait(v_full(sl), ((n_tiles - 1) / STAGES) & 1);
      issue_pv(sl);
      hand_over(true);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty(sl));
    }

    // Epilogue: out = O / max(l, 1e-30) in bf16.  The warpgroup stages
    // its 64 rows in its own rows of the Q tile (done with them after its
    // last S product), in the 128-byte swizzle, and one thread writes them
    // with TMA, which leaves out the rows past sq.
    if (q_rows > 64 * wg) {
      const uint32_t o_wg = q_wg;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        const int r = 16 * warp + g + 8 * i;   // row of the warpgroup's 64
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          const uint32_t addr = o_wg + (n / 8) * BOX_BYTES + r * 128 +
                                (((n % 8) ^ (r % 8)) << 4) + 4 * c;
          st_shared(addr, pack_bf16(o[4 * n + 2 * i] * inv,
                                    o[4 * n + 2 * i + 1] * inv));
        }
      }
      // The stores become visible to the TMA unit, then to its thread.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, 128);
      if (t_in == 0) {
        for (int x = 0; x < L::BOXES; ++x)
          tma_store(&o_map, o_wg + x * BOX_BYTES, 64 * x, h, q0 + 64 * wg,
                    b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // The shared memory must outlive the copy's reads of it.
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map over [b, s, heads, dh] bf16 (contiguous) in boxes of `rows`
// positions x 64 columns of one (batch, head), 128-byte swizzled; loads
// past the ends fill with zeros, stores there are dropped.
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int dh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)s * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int q_offset, float scale,
           cudaStream_t stream) {
  static_assert(BM == 128 && BN == 128, "the maps' boxes are 128 rows");
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!make_map(&q_map, q, b, sq, hq, DH, BM) ||
      !make_map(&k_map, k, b, skv, hkv, DH, BN) ||
      !make_map(&v_map, v, b, skv, hkv, DH, BN) ||
      !make_map(&o_map, out, b, sq, hq, DH, 64))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_hopper<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<DH>::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * hq), (unsigned)((sq + BM - 1) / BM));
  kernel<<<grid, THREADS, Layout<DH>::bytes, stream>>>(
      q_map, k_map, v_map, o_map, sq, skv, hq, hkv, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// q, out: [b, sq, hq, dh]; k, v: [b, skv, hkv, dh]; contiguous, 16-byte
// aligned, on the device; dtype 0 = f32, 1 = bf16; dh in {16, 32, 64, 128}.
// bf16 at dh 64 and 128 takes the "wgmma" route, the rest the "wmma" one.
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
  if (dtype == 1 && dh == 128)
    return hopper::launch<128>(q, k, v, out, b, sq, skv, hq, hkv, q_offset,
                               scale, s);
  if (dtype == 1 && dh == 64)
    return hopper::launch<64>(q, k, v, out, b, sq, skv, hq, hkv, q_offset,
                              scale, s);
  return dtype == 0
             ? launch_dh<float>(dh, q, k, v, out, b, sq, skv, hq, hkv,
                                q_offset, scale, s)
             : launch_dh<bf16>(dh, q, k, v, out, b, sq, skv, hq, hkv,
                               q_offset, scale, s);
}
