// Edge-softmax attention rows on the forward CSR for Hopper (sm_90a): the
// per-edge half of a single-head graph transformer layer (UniMP /
// PyG TransformerConv), whose rows are the graph's in-neighbourhoods.
//
// Row r of the forward CSR holds the edges into node r; edge e's source is
// indices[e]. With a [N, d] row operand A and a [N, d] source operand B:
//   forward  (mode 0): s_e = A_r . B_src * scale, alpha_e = softmax over the
//            row's edges of s_e (A = q, B = k, scale = 1 / sqrt(d));
//   backward (mode 1): p_e = A_r . B_src, D_r = sum_e alpha_e p_e,
//            ds_e = alpha_e (p_e - D_r) * scale (A = dO, B = v), the
//            gradient of the loss by the logit over 1 / sqrt(d), so that
//            dq = A_ds k and dk = A_ds^T q.
// Only [E] scalars are written. The aggregations out = A_alpha v,
// dv = A_alpha^T dO, dq and dk are B1 (spmm_csr.cu) with per-call edge
// weights (ops/edge_attention.py), so no [E, d] tensor exists on any path.
// A row with no in-edge writes nothing.
//
// What bounds it on an H100: bytes. Each edge reads one 1 KB source row of B
// at d = 256 f32 (the row operand stays in registers), as B1's gather does:
// 60.8M edges read 62 GB where the table does not fit the 50 MB L2, about
// 19 ms at 3.35 TB/s; the [E] scalars add 3 x 4 bytes an edge.
//
// Design (ops/edge_attention.py passes the graph's RowSchedule, the one B1
// uses, graph/core.py:build_schedule):
// - Light rows (in-degree <= T): attn_light_kernel gives each row a warp.
//   Each lane holds NV vectors of VEC columns of A_r, loads the same columns
//   of the source rows of kLoads / NV edges before it sums them, and the
//   warp reduces each edge's dot product by an xor butterfly (every lane ends
//   with the same bits: each stage adds a pair in both orders). The row's
//   scalars go to the output; the warp reads them back lane-strided for the
//   row statistic (max and sum of exponents, or sum of alpha p), then writes
//   the final values.
// - Hub rows (in-degree > T): attn_hub_chunk_kernel gives each chunk of <= T
//   consecutive edges a block of kHubWarps warps, each taking a contiguous
//   sub-range; warp 0 then folds the chunk's scalars into one partial
//   ((max, sum of exp(s - max)) or sum alpha p) in edge order.
//   attn_hub_finish_kernel merges a hub row's partials in chunk order on one
//   thread and writes the row's final values.
// - Determinism: every sum's order follows from the schedule; no atomics, so
//   two launches on the same inputs give identical bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLightWarps = 8;  // warps per block of the light-row kernel
constexpr int kLoads = 8;       // source-row vector loads a lane keeps in flight
constexpr int kHubWarps = 8;    // warps per hub-chunk block
constexpr int kFinishThreads = 256;

template <int VEC> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<1> { using type = float; };

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot(float2 a, float2 b) { return a.x * b.x + a.y * b.y; }
__device__ __forceinline__ float dot(float a, float b) { return a * b; }

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::type load(const float* p) {
  return *reinterpret_cast<const typename Vec<VEC>::type*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// The dot products of A_r with the source rows of edges [k0, k1) (their ids
// in src[], read through `src_of`), written to out[e] (times `scale` in the
// forward mode). One warp; every lane takes part.
template <int MODE, int VEC, int NV, typename SrcOf>
__device__ __forceinline__ void row_dots(const float* __restrict__ a_row,
                                         const float* __restrict__ b, float* __restrict__ out,
                                         int e_first, int k0, int k1, int d, float scale,
                                         SrcOf src_of) {
  constexpr int kBatch = kLoads / NV;  // edges whose source rows load before summing
  constexpr int PASS = 32 * NV * VEC;  // columns a warp covers per pass
  using V = typename Vec<VEC>::type;
  const int lane = threadIdx.x & 31;
  const int n_vec = d / VEC;  // the wrapper guarantees d % VEC == 0
  const int n_pass = (d + PASS - 1) / PASS;
  V av[NV];
  bool act[NV];
  size_t col[NV];
  auto columns = [&](int ps) {  // this lane's columns of pass ps, and A_r's values there
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = ps * 32 * NV + j * 32 + lane;
      act[j] = v < n_vec;
      col[j] = static_cast<size_t>(min(v, n_vec - 1)) * VEC;
      av[j] = load<VEC>(a_row + col[j]);
    }
  };
  columns(0);  // held in registers across the edges where one pass covers d
  for (int k = k0; k < k1; k += kBatch) {
    const int cnt = min(kBatch, k1 - k);
    size_t srow[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      srow[u] = static_cast<size_t>(src_of(k + min(u, cnt - 1))) * d;
    float part[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) part[u] = 0.f;
    for (int ps = 0; ps < n_pass; ++ps) {
      if (n_pass > 1) columns(ps);
      V bv[kBatch][NV];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int j = 0; j < NV; ++j) bv[u][j] = load<VEC>(b + srow[u] + col[j]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          if (act[j]) part[u] += dot(av[j], bv[u][j]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float s = warp_sum(part[u]);  // the same bits on every lane
      if (u < cnt && lane == u % 32) out[e_first + k + u] = MODE == 0 ? s * scale : s;
    }
  }
}

// Light rows: a warp a row of in-degree 1..threshold.
template <int MODE, int VEC, int NV>
__global__ void __launch_bounds__(kLightWarps * 32)
attn_light_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ alpha, float* __restrict__ out, int n_rows, int d,
                  float scale, int threshold) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= n_rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int e0 = indptr[row];
  const int len = indptr[row + 1] - e0;
  if (len == 0 || len > threshold) return;
  row_dots<MODE, VEC, NV>(a + static_cast<size_t>(row) * d, b, out, e0, 0, len, d, scale,
                          [&](int k) { return indices[e0 + k]; });
  __syncwarp();  // the row's scalars, written by their lanes, are visible to all
  if (MODE == 0) {
    float m = -INFINITY;
    for (int k = lane; k < len; k += 32) m = fmaxf(m, out[e0 + k]);
    m = warp_max(m);
    float l = 0.f;
    for (int k = lane; k < len; k += 32) l += expf(out[e0 + k] - m);
    l = warp_sum(l);
    for (int k = lane; k < len; k += 32) out[e0 + k] = expf(out[e0 + k] - m) / l;
  } else {
    float dr = 0.f;
    for (int k = lane; k < len; k += 32) dr += alpha[e0 + k] * out[e0 + k];
    dr = warp_sum(dr);
    for (int k = lane; k < len; k += 32)
      out[e0 + k] = alpha[e0 + k] * (out[e0 + k] - dr) * scale;
  }
}

// Hub chunks: a block a chunk of <= threshold consecutive edges of a hub row;
// the chunk's scalars to out, its partial to partial[2 c] (and [2 c + 1]).
template <int MODE, int VEC, int NV>
__global__ void __launch_bounds__(kHubWarps * 32)
attn_hub_chunk_kernel(const int32_t* __restrict__ indices, const float* __restrict__ a,
                      const float* __restrict__ b, const float* __restrict__ alpha,
                      float* __restrict__ out, float* __restrict__ partial,
                      const int32_t* __restrict__ hub_rows,
                      const int32_t* __restrict__ hub_chunk_ptr, int n_hub,
                      const int32_t* __restrict__ chunk_bounds, int d, float scale) {
  const int c = blockIdx.x;
  const int e0 = chunk_bounds[2 * c];
  const int len = chunk_bounds[2 * c + 1] - e0;
  // the chunk's row: the hub whose chunk range holds c (hub_chunk_ptr ascends)
  int lo = 0, hi = n_hub - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (hub_chunk_ptr[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int row = hub_rows[lo];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (len + kHubWarps - 1) / kHubWarps;
  const int k0 = min(len, warp * per);
  const int k1 = min(len, k0 + per);
  if (k0 < k1)
    row_dots<MODE, VEC, NV>(a + static_cast<size_t>(row) * d, b, out, e0, k0, k1, d, scale,
                            [&](int k) { return indices[e0 + k]; });
  __syncthreads();  // the block's writes to out are visible to warp 0
  if (warp != 0) return;
  if (MODE == 0) {
    float m = -INFINITY;
    for (int k = lane; k < len; k += 32) m = fmaxf(m, out[e0 + k]);
    m = warp_max(m);
    float l = 0.f;
    for (int k = lane; k < len; k += 32) l += expf(out[e0 + k] - m);
    l = warp_sum(l);
    if (lane == 0) {
      partial[2 * c] = m;
      partial[2 * c + 1] = l;
    }
  } else {
    float dr = 0.f;
    for (int k = lane; k < len; k += 32) dr += alpha[e0 + k] * out[e0 + k];
    dr = warp_sum(dr);
    if (lane == 0) partial[2 * c] = dr;
  }
}

// A block a hub row: its chunks' partials merged in chunk order, then the
// row's final values.
template <int MODE>
__global__ void __launch_bounds__(kFinishThreads)
attn_hub_finish_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ alpha,
                       float* __restrict__ out, const float* __restrict__ partial,
                       const int32_t* __restrict__ hub_rows,
                       const int32_t* __restrict__ hub_chunk_ptr, float scale) {
  __shared__ float stat[2];
  const int h = blockIdx.x;
  const int c0 = hub_chunk_ptr[h];
  const int c1 = hub_chunk_ptr[h + 1];
  if (threadIdx.x == 0) {
    if (MODE == 0) {
      float m = -INFINITY;
      for (int c = c0; c < c1; ++c) m = fmaxf(m, partial[2 * c]);
      float l = 0.f;
      for (int c = c0; c < c1; ++c) l += partial[2 * c + 1] * expf(partial[2 * c] - m);
      stat[0] = m;
      stat[1] = l;
    } else {
      float dr = 0.f;
      for (int c = c0; c < c1; ++c) dr += partial[2 * c];
      stat[0] = dr;
    }
  }
  __syncthreads();
  const int row = hub_rows[h];
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    out[e] = MODE == 0 ? expf(out[e] - stat[0]) / stat[1]
                       : alpha[e] * (out[e] - stat[0]) * scale;
  }
}

struct Problem {
  const int32_t* indptr;
  const int32_t* indices;
  const float* a;
  const float* b;
  const float* alpha;
  float* out;
  int n_rows, d;
  float scale;
  const int32_t* hub_rows;
  const int32_t* hub_chunk_ptr;
  int n_hub;
  const int32_t* chunk_bounds;
  int n_chunks, threshold;
  float* partial;
  cudaStream_t stream;
};

// The hub chunks and their finish, then the light rows, each launch checked
// before the next.
template <int MODE, int VEC, int NV>
int run(const Problem& p) {
  if (p.n_chunks > 0) {
    attn_hub_chunk_kernel<MODE, VEC, NV><<<p.n_chunks, kHubWarps * 32, 0, p.stream>>>(
        p.indices, p.a, p.b, p.alpha, p.out, p.partial, p.hub_rows, p.hub_chunk_ptr, p.n_hub,
        p.chunk_bounds, p.d, p.scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    attn_hub_finish_kernel<MODE><<<p.n_hub, kFinishThreads, 0, p.stream>>>(
        p.indptr, p.alpha, p.out, p.partial, p.hub_rows, p.hub_chunk_ptr, p.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.n_rows > 0) {
    const int per_block = kLightWarps * 32;
    const long long threads = static_cast<long long>(p.n_rows) * 32;
    const int blocks = static_cast<int>((threads + per_block - 1) / per_block);
    attn_light_kernel<MODE, VEC, NV><<<blocks, per_block, 0, p.stream>>>(
        p.indptr, p.indices, p.a, p.b, p.alpha, p.out, p.n_rows, p.d, p.scale, p.threshold);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int MODE, int VEC>
int run_nv(const Problem& p, int nv) {
  switch (nv) {
    case 1: return run<MODE, VEC, 1>(p);
    case 2: return run<MODE, VEC, 2>(p);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE>
int run_mode(const Problem& p, int vec, int nv) {
  switch (vec) {
    case 4: return run_nv<MODE, 4>(p, nv);
    case 2: return run_nv<MODE, 2>(p, nv);
    case 1: return run_nv<MODE, 1>(p, nv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). mode 0: out = alpha from (q, k);
// mode 1: out = ds from (dO, v) and alpha. `partial`: [n_chunks, 2] f32
// scratch. Returns cudaGetLastError() after each launch (the first non-zero
// one), or cudaErrorInvalidValue for a layout it does not take.
extern "C" int edge_attn_rows_f32(int mode, const int32_t* indptr, const int32_t* indices,
                                  const float* a, const float* b, const float* alpha,
                                  float* out, int n_rows, int d, int vec, int nv, float scale,
                                  const int32_t* hub_rows, const int32_t* hub_chunk_ptr,
                                  int n_hub, const int32_t* chunk_bounds, int n_chunks,
                                  int threshold, float* partial, void* stream) {
  if (d <= 0 || vec < 1 || d % vec != 0 || threshold < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem p{indptr, indices, a, b, alpha, out, n_rows, d, scale, hub_rows,
                  hub_chunk_ptr, n_hub, chunk_bounds, n_chunks, threshold, partial,
                  static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case 0: return run_mode<0>(p, vec, nv);
    case 1: return run_mode<1>(p, vec, nv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
