// embedding_bag: EmbeddingBag forward, a weighted sum of table rows per bag.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py,
// embedding_bag_kernel (body _bag_kernel): out[b] = sum over j of
// w[b, j] * table[ids[b, j]], walking j = 0 .. nnz-1 in order with two
// roundings per step, acc = acc + (row * w) (__fmul_rn then __fadd_rn, so
// nvcc contracts nothing into an FMA), then acc / max(count, 1) for "mean"
// (__fdiv_rn).  An id outside [0, V) is padding: it is skipped and not
// counted, so the kernel never reads outside the table.  Skipping is the
// reference's "add 0.0": the sum starts at +0.0 and a round-to-nearest sum
// is never -0.0, so adding +0.0 changes nothing.  A null weight pointer
// means every weight is 1 (row * 1.0f is the row, exactly).
//
// What bounds it on the H100: device memory.  It moves the gathered rows
// (valid ids x D x 4 B), the ids and weights (8 B per slot) and the output
// (B x D x 4 B) once; two flops per gathered element are nothing against
// that.  Rows of a Zipf-skewed id stream repeat, so many gathers hit L2.
//
// Design, simple first: D / 4 threads per bag, each owning a float4 of the
// row (D / 1 threads of one float when D is not a multiple of 4 or the
// table is not 16-byte aligned); a warp covers 32 / (D / 4) bags, and each
// gathered row is one contiguous D x 4 B read.  Row offsets are 64-bit.
// Nothing is allocated here; the wrapper allocates the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const float* __restrict__ table, long long v, int d,
                     const int* __restrict__ ids,
                     const float* __restrict__ w, float* __restrict__ out,
                     long long b, int nnz, int mean) {
  const int chunks = d / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= b * chunks) return;
  const long long bag = t / chunks;
  const int col = (int)(t - bag * chunks) * VEC;
  const int* bag_ids = ids + bag * nnz;
  const float* bag_w = w == nullptr ? nullptr : w + bag * nnz;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  float cnt = 0.0f;
#pragma unroll 4
  for (int j = 0; j < nnz; ++j) {
    const int id = __ldg(bag_ids + j);
    if (id < 0 || (long long)id >= v) continue;
    const float wj = bag_w == nullptr ? 1.0f : __ldg(bag_w + j);
    float row[VEC];
    load_row<VEC>(table + (long long)id * d + col, row);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(row[e], wj));
    cnt += 1.0f;
  }
  if (mean) {
    const float den = fmaxf(cnt, 1.0f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], den);
  }
  store_row<VEC>(out + bag * d + col, acc);
}

}  // namespace

// table: f32[v, d]; ids: i32[b, nnz]; w: f32[b, nnz] or null (all 1);
// out: f32[b, d]; all contiguous on the device.  mean: 0 sums, 1 divides
// by max(valid count, 1).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int embedding_bag_fwd(const float* table, long long v, int d,
                                 const int* ids, const float* w, float* out,
                                 long long b, int nnz, int mean,
                                 void* stream) {
  if (v < 0 || d < 0 || b < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || d == 0) return 0;
  const bool vec4 = d % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const long long threads = b * (vec4 ? d / 4 : d);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    embedding_bag_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(
        table, v, d, ids, w, out, b, nnz, mean);
  else
    embedding_bag_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(
        table, v, d, ids, w, out, b, nnz, mean);
  return (int)cudaGetLastError();
}
