// embedding_bag: EmbeddingBag forward, a weighted sum of table rows per bag,
// and a grouped single-hot lookup of many tables in one launch.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py,
// embedding_bag_kernel (body _bag_kernel): out[b] = sum over j of
// w[b, j] * table[ids[b, j]], walking j = 0 .. nnz-1 in order with two
// roundings per step, acc = acc + (row * w) (__fmul_rn then __fadd_rn, so
// nvcc contracts nothing into an FMA), then acc / max(count, 1) for "mean"
// (__fdiv_rn).  An id outside [0, V) is padding: it is not counted and its
// row is never read; its step adds +0.0 (a zero row times a zero weight),
// which is the reference's "add 0.0" and changes nothing, since the sum
// starts at +0.0 and a round-to-nearest sum is never -0.0.  A null weight
// pointer means every weight is 1 (row * 1.0f is the row, exactly).
//
// What bounds it on the H100: bytes.  It moves the gathered rows (valid ids
// x D x 4 B), the ids and weights (8 B per slot) and the output (B x D x
// 4 B) once; two flops per gathered element are nothing against that.
// Rows of a Zipf-skewed id stream repeat, so most gathers hit L2 or L1, and
// then what limits the gather is how many row loads are in flight and how
// few instructions each slot costs.
//
// Multi-hot design (embedding_bag_fwd): a group of G lanes per bag (G the
// power of two at or above D / 4, at most 32), each lane a float4 of the
// row (one float when D % 4 != 0 or the table is not 16-byte aligned), so a
// warp holds 32 / G bags; at D = 16 one warp load instruction fetches 8
// rows.  The warp's bags are consecutive, so their ids (and weights) are one
// run in memory: the warp copies a chunk of them into shared memory with
// coalesced loads, one id per lane, and the next chunk's loads are issued
// before the current chunk is summed.  Each lane reads four ids and four
// weights with one 16-byte shared load each, issues the four row loads
// (predicated, no branch) before its first add, and adds them in order.
//
// Grouped design (embedding_bag_grouped_fwd): F single-hot fields, each
// with its own table, written into columns col0 + f * D of an output with a
// row stride ld, as DCN-v2's x0 = [dense | emb_0 | ... | emb_25] wants it;
// the first col0 columns can be copied in from a prefix array in the same
// launch (DCN-v2's dense features), so that the launch writes whole rows.
// Table pointers and row counts ride in a kernel parameter (no device-side
// pointer array, no copy per call).  One thread per output column of a
// request: consecutive threads write consecutive columns.  A thread keeps
// its column, field and table for the whole launch and walks the requests
// a sweep apart, GROUPED_BATCH at a time, the next batch's ids in flight
// while this batch's rows load.  Stores are 4-byte scalars (DCN-v2's ld =
// 429 leaves rows without 16-byte alignment), so each warp stores one run
// of 128 bytes.  Writing whole rows matters: with x0's 13 dense columns
// left to a copy_ of their own, the lookup alone takes longer than the
// whole-row launch on an H100 (chip_smoke.py times both).  A bag of one with
// weight 1 is the row, so this is the multi-hot kernel's result for nnz = 1
// (up to the sign of a zero row entry, which the copy keeps).  With `clip`,
// ids are clamped into the field's own [0, rows - 1] (the reference's
// jnp.clip before jnp.take); without it an id outside the table is padding
// and its columns are 0.
//
// Row offsets are 64-bit.  Nothing is allocated here; the wrapper
// allocates the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 256;        // ids a warp stages per chunk
constexpr int BATCH = 4;          // row loads a lane issues before its adds
constexpr int GROUPED_BATCH = 4;  // requests a grouped thread loads at once
constexpr int MAX_FIELDS = 64;

// An id names a row when it lies in [0, rows); anything else is padding.
__device__ __forceinline__ bool names_row(int id, long long rows) {
  return id >= 0 && (long long)id < rows;
}

// log2g: log2 of the lanes per bag G; log2c: log2 of the ids per bag per
// staged chunk (at least BATCH, with (32 / G) << log2c <= STAGE).
template <int VEC>
__global__ void __launch_bounds__(THREADS, 3)
embedding_bag_kernel(const float* __restrict__ table, long long v, int d,
                     const int* __restrict__ ids,
                     const float* __restrict__ w, float* __restrict__ out,
                     long long b, int nnz, int mean, int log2g, int log2c) {
  // A bag's stage row starts BATCH-aligned for the 16-byte reads; the
  // padding of BATCH per row keeps the groups' reads on different banks.
  __shared__ __align__(16) int s_id[WARPS][STAGE + 32 * BATCH];
  __shared__ __align__(16) float s_w[WARPS][STAGE + 32 * BATCH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = 1 << log2c, group = 1 << log2g, bags = 32 >> log2g;
  const int g = lane >> log2g, sub = lane & (group - 1);
  const long long bag0 = ((long long)blockIdx.x * WARPS + warp) * bags;
  const long long bag = bag0 + g;
  const int cols = d / VEC;
  const int passes = (cols + group - 1) >> log2g;
  const int per_lane = (bags << log2c) >> 5;   // staged values per lane
  const int stride = chunk + BATCH;
  // One unsigned compare tests 0 <= id < v for an int32 id.
  const unsigned vlim = v > 0x7fffffffLL ? 0x80000000u : (unsigned)v;
  int* wid = s_id[warp];
  float* ww = s_w[warp];

  // Ids and weights of positions [j0, j0 + chunk) of the warp's bags, one
  // per lane per load: element e = lane + 32 i is bag e / chunk, position
  // e % chunk, and the bags' ids are one run, so each load is coalesced.
  // Positions past nnz and bags past b are staged as padding.
  int rid[8];
  float rw[8];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < per_lane) {
        const int e = lane + 32 * i;
        const int k = e >> log2c, j = j0 + (e & (chunk - 1));
        const bool in = bag0 + k < b && j < nnz;
        const long long at = (bag0 + k) * nnz + j;
        rid[i] = in ? __ldg(ids + at) : -1;
        rw[i] = in && w != nullptr ? __ldg(w + at) : 1.0f;
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < per_lane) {
        const int e = lane + 32 * i;
        const int at = (e >> log2c) * stride + (e & (chunk - 1));
        wid[at] = rid[i];
        ww[at] = rw[i];
      }
    }
  };

  for (int pass = 0; pass < passes; ++pass) {
    const int cc = sub + (pass << log2g);     // this lane's float4 (or float)
    const bool active = bag < b && cc < cols;
    const float* tcol = table + (long long)cc * VEC;
    const int* my_id = wid + g * stride;
    const float* my_w = ww + g * stride;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    int cnt = 0;
    fetch(0);
    for (int j0 = 0; j0 < nnz; j0 += chunk) {
      __syncwarp();                           // the last chunk is read
      stage();
      __syncwarp();
      if (j0 + chunk < nnz) fetch(j0 + chunk);  // in flight while we add
      const int n = min(chunk, nnz - j0);
      for (int jb = 0; jb < n; jb += BATCH) {
        const int4 i4 = *reinterpret_cast<const int4*>(my_id + jb);
        const float4 w4 = *reinterpret_cast<const float4*>(my_w + jb);
        const int idv[BATCH] = {i4.x, i4.y, i4.z, i4.w};
        const float wv[BATCH] = {w4.x, w4.y, w4.z, w4.w};
        float row[BATCH][VEC];
        float wj[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const bool ok = active && (unsigned)idv[u] < vlim;
          wj[u] = ok ? wv[u] : 0.0f;
          cnt += ok;
#pragma unroll
          for (int e = 0; e < VEC; ++e) row[u][e] = 0.0f;
          if (ok) {
            const float* p = tcol + (long long)idv[u] * d;
            if constexpr (VEC == 4) {
              const float4 x = __ldg(reinterpret_cast<const float4*>(p));
              row[u][0] = x.x; row[u][1] = x.y; row[u][2] = x.z; row[u][3] = x.w;
            } else {
              row[u][0] = __ldg(p);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(row[u][e], wj[u]));
      }
    }
    if (active) {
      float* o = out + bag * d + (long long)cc * VEC;
      if (mean) {
        const float den = fmaxf((float)cnt, 1.0f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], den);
      }
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      else
        o[0] = acc[0];
    }
  }
}

struct Fields {
  const float* table[MAX_FIELDS];
  long long rows[MAX_FIELDS];
};

// Threads cover columns [c0, col0 + f * d) of sweep requests (c0 = 0 with a
// prefix, col0 without), rounded up to whole blocks; the extra threads
// return at once.  Column c < col0 copies prefix[r * col0 + c].
__global__ void __launch_bounds__(THREADS)
embedding_bag_grouped_kernel(const __grid_constant__ Fields fields, int f,
                             int d, const int* __restrict__ ids, long long b,
                             const float* __restrict__ prefix,
                             float* __restrict__ out, long long ld, int col0,
                             int clip, long long sweep) {
  const int c0 = prefix != nullptr ? 0 : col0;
  const int width = col0 + f * d - c0;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long r0 = t / width;
  if (r0 >= sweep) return;
  const int col = c0 + (int)(t - r0 * width);
  // A prefix column reads row r of the prefix where a field column reads
  // row ids[r, field] of its table: its "id" is r, its rows col0 floats.
  const bool pre = col < col0;
  const int field = pre ? 0 : (col - col0) / d;
  const float* src = pre ? prefix + col
                         : fields.table[field] + (col - col0 - field * d);
  const long long rows = pre ? b : fields.rows[field];
  const long long step = pre ? col0 : d;
  float* op = out + r0 * ld + col;
  const long long out_step = sweep * ld;
  int next[GROUPED_BATCH];
  auto fetch = [&](long long r) {
#pragma unroll
    for (int u = 0; u < GROUPED_BATCH; ++u) {
      const long long rr = r + u * sweep;
      next[u] = rr >= b ? -1 : pre ? (int)rr : __ldg(ids + rr * f + field);
    }
  };
  fetch(r0);
  for (long long r = r0; r < b; r += GROUPED_BATCH * sweep) {
    int id[GROUPED_BATCH];
#pragma unroll
    for (int u = 0; u < GROUPED_BATCH; ++u) id[u] = next[u];
    fetch(r + GROUPED_BATCH * sweep);        // in flight while rows load
    float x[GROUPED_BATCH];
#pragma unroll
    for (int u = 0; u < GROUPED_BATCH; ++u) {
      int i = id[u];
      if (clip && !pre)
        i = i < 0 ? 0 : ((long long)i >= rows ? (int)(rows - 1) : i);
      x[u] = r + u * sweep < b && names_row(i, rows)
                 ? __ldg(src + (long long)i * step) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < GROUPED_BATCH; ++u)
      if (r + u * sweep < b) op[u * out_step] = x[u];
    op += GROUPED_BATCH * out_step;
  }
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
  const int cols = vec4 ? d / 4 : d;
  int log2g = 0;
  while ((1 << log2g) < cols && log2g < 5) ++log2g;
  const int bags = 32 >> log2g;               // per warp
  int log2c = 5;                              // 32 ids per bag per chunk
  while ((bags << log2c) > STAGE) --log2c;
  const long long per_block = (long long)WARPS * bags;
  const long long blocks = (b + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    embedding_bag_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(
        table, v, d, ids, w, out, b, nnz, mean, log2g, log2c);
  else
    embedding_bag_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(
        table, v, d, ids, w, out, b, nnz, mean, log2g, log2c);
  return (int)cudaGetLastError();
}

// ids: i32[b, f], contiguous; tables: a host array of f device pointers to
// f32[rows[f], d] tables, each contiguous; rows: a host array of f row
// counts; out: f32 on the device, row stride ld: field k of request r goes
// to out[r * ld + col0 + k * d ...].  prefix: f32[b, col0], contiguous,
// copied into columns [0, col0), or null to leave them alone.  clip: 1
// clamps each id into its field's [0, rows - 1] (every rows >= 1), 0
// writes zeros for an id outside it.  1 <= f <= 64.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int embedding_bag_grouped_fwd(const int* ids, long long b, int f,
                                         const float* const* tables,
                                         const long long* rows, int d,
                                         const float* prefix, float* out,
                                         long long ld, int col0, int clip,
                                         void* stream) {
  if (f < 1 || f > MAX_FIELDS || d < 1 || b < 0 || col0 < 0
      || (long long)col0 + (long long)f * d > 0x7fffffffLL
      || ld < col0 + (long long)f * d || b > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Fields fields;
  for (int k = 0; k < f; ++k) {
    if (rows[k] < (clip ? 1 : 0)) return (int)cudaErrorInvalidValue;
    fields.table[k] = tables[k];
    fields.rows[k] = rows[k];
  }
  if (b == 0) return 0;
  // One wave of resident blocks: as many requests at once as that holds.
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, embedding_bag_grouped_kernel, THREADS, 0);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long width = col0 + (long long)f * d - (prefix ? 0 : col0);
  long long sweep = (long long)sms * per_sm * THREADS / width;
  if (sweep < 1) sweep = 1;
  if (sweep > b) sweep = b;
  const long long blocks = (sweep * width + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  embedding_bag_grouped_kernel<<<(unsigned)blocks, THREADS, 0,
                                 (cudaStream_t)stream>>>(
      fields, f, d, ids, b, prefix, out, ld, col0, clip, sweep);
  return (int)cudaGetLastError();
}
