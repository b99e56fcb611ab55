// CSR SpMM for Hopper (sm_90a): y[r, :] = sum_{e in indptr[r]..indptr[r+1]} w_e * x[indices_e, :]
//
// Replaces the two Pallas TPU kernels of gnn_tail_generalization_tpu/ops/spmm_pallas.py:
//   - _segment_matmul_kernel (f32)         -> spmm_csr_f32
//   - _segment_matmul_packed_kernel (bf16) -> spmm_csr_bf16: x and w are bf16
//     (rounded RTNE by the Python wrapper), products and sums in f32, y in f32.
// The TPU kernels reduce a pre-gathered [E_pad, d] stream with one-hot MXU
// matmuls over 1024-edge chunks. Here the kernels gather x[src] themselves
// from the CSR, so no [E, d] stream is ever written to device memory.
//
// What bounds it on an H100: bytes. Counting each input once (x, y in f32,
// indices, w, indptr), the arxiv-shape graph at d = 256 (2,501,571 edges)
// moves 367.5 MB in f32 and 275.8 MB in bf16: 0.110 and 0.082 ms at
// 3.35 TB/s; the ogbl-citation2-shape graph (30,355,054 edges) 6.25 and
// 4.69 GB: 1.87 and 1.40 ms. Without reuse in the 50 MB L2 the gather reads
// one source row per edge, 1 KB (f32) or 512 B (bf16) at d = 256: 2.56 /
// 1.28 GB at arxiv and 31.1 / 15.5 GB at citation2, which is the practical
// floor where the table does not fit in L2.
// Why no tensor cores: SpMM does 2 flops per gathered element, about 0.5 a
// byte in f32, where bf16 wgmma needs ~295 before compute binds. The TPU
// kernel used its MXU only because the TPU has no cheap gather or scatter.
//
// Design (ops/spmm_kernels.py passes a RowSchedule built from indptr alone,
// graph/core.py:build_schedule):
// - Light rows (in-degree <= T): spmm_light_kernel gives each row a group
//   of G lanes; G follows from d (the wrapper's lane_layout): at d = 256 a
//   whole warp covers a row in one pass, each lane holding 8 values (two
//   float4 in f32, one 16-byte load of bf16); narrower rows pack 2-32 rows
//   into a warp (d = 40: 16 lanes a row in f32, 8 in bf16). The group loads
//   G edges' (index, weight) pairs at once, reading the next G ahead of use,
//   broadcasts them by shuffles and issues the source-row loads of
//   kLoads / NV edges before it sums them, so each lane keeps kLoads
//   independent loads (16 bytes where d allows) in flight, held packed in
//   registers until they are summed. Columns past d are clamped to the last
//   vector, never masked around the load.
// - Hub rows (in-degree > T, the power-law tail that set the old kernel's
//   time: one warp walked a 2,742-edge row alone): each chunk of <= T
//   consecutive edges gets a block of kHubWarps warps. The block stages the
//   chunk's indices and weights in shared memory; each warp takes a
//   contiguous sub-range and streams its source rows through a kStages-deep
//   ring in shared memory with cp.async copies (each lane copies and later
//   reads only its own columns, so the ring needs no barrier). The warps'
//   partials are summed in warp order in shared memory, and one f32 partial
//   per chunk goes to a [n_chunks, d] scratch.
// - spmm_hub_reduce_kernel sums each hub row's chunk partials in chunk order
//   into y.
// - Determinism: every sum's order follows from the schedule; no atomics, so
//   the same inputs give bit-identical output on every launch.
// Measured on an H100 (PERF.md, profile_spmm.py): a call takes about the
// time HBM needs to read one source row per edge (f32 at 78-95% of that
// rate), the hub chunks add under 1% on the arxiv-shape graph, and T = 64
// was the fastest threshold there and within 0.2% of it at citation2.
// Tried and dropped: launching the light rows once per column slab sized to
// the L2 (faster only for f32 on the arxiv-shape graph). cp.async.bulk with
// an mbarrier was not tried, as the hub chunks are not where the time goes.
// SPMM_LOADS and SPMM_MIN_BLOCKS may be set with -D to sweep them
// (profile_spmm.py --variant).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLightWarps = 8;   // warps per block of the light-row kernel
#ifndef SPMM_LOADS
#define SPMM_LOADS 8
#endif
#ifndef SPMM_MIN_BLOCKS
#define SPMM_MIN_BLOCKS 3
#endif
constexpr int kLoads = SPMM_LOADS;  // source-row loads a light-row lane keeps in flight
constexpr int kLightMinBlocks = SPMM_MIN_BLOCKS;  // caps registers: 3 blocks of 8 warps an SM
constexpr int kHubWarps = 8;     // warps per hub-chunk block
constexpr int kStages = 8;       // source rows in flight per hub warp (the ring's depth)
constexpr int kReduceWarps = 8;  // warps per block of the chunk reduction

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// bf16 bits -> f32 value (exact)
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// A vector of VEC elements as loaded: kept packed in registers until it is
// summed (bf16 stays two to a 32-bit register), then unpacked to f32.
template <typename T, int VEC> struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 2> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, VEC>::type*>(p);
}

__device__ __forceinline__ void unpack(float4 t, float* v) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void unpack(float2 t, float* v) { v[0] = t.x; v[1] = t.y; }
__device__ __forceinline__ void unpack(float t, float* v) { v[0] = t; }
__device__ __forceinline__ void unpack(uint4 t, float* v) {
  v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
  v[4] = bf16_lo(t.z); v[5] = bf16_hi(t.z); v[6] = bf16_lo(t.w); v[7] = bf16_hi(t.w);
}
__device__ __forceinline__ void unpack(uint2 t, float* v) {
  v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
}
__device__ __forceinline__ void unpack(uint32_t t, float* v) { v[0] = bf16_lo(t); v[1] = bf16_hi(t); }
__device__ __forceinline__ void unpack(unsigned short t, float* v) {
  v[0] = __uint_as_float(static_cast<uint32_t>(t) << 16);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  unpack(load_raw<T, VEC>(p), v);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; .cg (L2 only)
// for whole 16-byte copies, .ca below that (the only form that takes them).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Light rows: a group of `group` lanes (a power of two <= 32) per row,
// each lane covering NV vectors of VEC columns per pass; rows of in-degree
// above `threshold` are the hub kernels' and are skipped.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kLightWarps * 32, kLightMinBlocks)
spmm_light_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                  const T* __restrict__ weight, const T* __restrict__ x, float* __restrict__ y,
                  int n_rows, int d, int group, int threshold) {
  constexpr int kBatch = kLoads / NV;  // edges whose source rows are loaded before summing
  const int lane = threadIdx.x & 31;
  const int gl = lane & (group - 1);  // lane within its group
  const unsigned mask = group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (lane - gl);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / group;
  bool valid = row < n_rows;  // uniform across the group
  int e0 = 0, e1 = 0;
  if (valid) {
    e0 = indptr[row];
    e1 = indptr[row + 1];
    if (e1 - e0 > threshold) {
      valid = false;
      e1 = e0;
    }
  }
  const int n_vec = d / VEC;  // the wrapper guarantees d % VEC == 0
  for (int v0 = 0; v0 < n_vec; v0 += group * NV) {
    size_t col[NV];
    bool active[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = v0 + j * group + gl;
      active[j] = v < n_vec;
      col[j] = static_cast<size_t>(min(v, n_vec - 1)) * VEC;
    }
    float acc[NV][VEC];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[j][t] = 0.f;

    int next_src = 0;
    float next_w = 0.f;
    if (e0 + gl < e1) {
      next_src = indices[e0 + gl];
      next_w = to_float(weight[e0 + gl]);
    }
    for (int eb = e0; eb < e1; eb += group) {
      const int src = next_src;
      const float w = next_w;
      const int cnt = min(group, e1 - eb);
      if (eb + group + gl < e1) {  // the next batch's pairs, read ahead of use
        next_src = indices[eb + group + gl];
        next_w = to_float(weight[eb + group + gl]);
      }
      for (int k0 = 0; k0 < cnt; k0 += kBatch) {
        int s[kBatch];
        float wk[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = min(k0 + u, cnt - 1);
          s[u] = __shfl_sync(mask, src, k, group);
          wk[u] = __shfl_sync(mask, w, k, group);
        }
        typename Raw<T, VEC>::type xv[kBatch][NV];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (k0 + u < cnt) {  // group-uniform: the batch's tail past the row's end
            const T* xr = x + static_cast<size_t>(s[u]) * d;
#pragma unroll
            for (int j = 0; j < NV; ++j) xv[u][j] = load_raw<T, VEC>(xr + col[j]);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (k0 + u < cnt) {
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              float v[VEC];
              unpack(xv[u][j], v);
#pragma unroll
              for (int t = 0; t < VEC; ++t) acc[j][t] = fmaf(wk[u], v[t], acc[j][t]);
            }
          }
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (active[j]) store_vec<VEC>(y + static_cast<size_t>(row) * d + col[j], acc[j]);
    }
  }
}

// Hub chunks: one block per chunk of <= chunk_cap consecutive edges of a hub
// row (chunk_cap = the schedule's threshold); partial[c, :] = the chunk's
// weighted sum. Dynamic shared memory: the ring [kHubWarps][kStages][kPassCols]
// of T, then chunk_cap source ids and chunk_cap f32 weights. The ring is
// reused for the warps' partials.
template <typename T, int VEC, int NV>
constexpr int kPassCols = 32 * NV * VEC;  // columns a warp covers per pass

template <typename T, int VEC, int NV>
__host__ __device__ constexpr size_t hub_ring_bytes() {
  return static_cast<size_t>(kHubWarps) * kStages * kPassCols<T, VEC, NV> * sizeof(T);
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kHubWarps * 32)
spmm_hub_chunk_kernel(const int32_t* __restrict__ indices, const T* __restrict__ weight,
                      const T* __restrict__ x, float* __restrict__ partial,
                      const int32_t* __restrict__ chunk_bounds, int d, int chunk_cap) {
  constexpr int PASS = kPassCols<T, VEC, NV>;
  // cp.async moves 4, 8 or 16 bytes; a 2-byte vector (bf16, odd d) loads directly
  constexpr bool kRing = VEC * sizeof(T) >= 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // [kHubWarps][PASS], after the edge loop
  int32_t* c_src = reinterpret_cast<int32_t*>(smem + hub_ring_bytes<T, VEC, NV>());
  float* c_w = reinterpret_cast<float*>(c_src + chunk_cap);

  const int c = blockIdx.x;
  const int e0 = chunk_bounds[2 * c];
  const int len = chunk_bounds[2 * c + 1] - e0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    c_src[i] = indices[e0 + i];
    c_w[i] = to_float(weight[e0 + i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (len + kHubWarps - 1) / kHubWarps;
  const int k0 = min(len, warp * per);
  const int k1 = min(len, k0 + per);
  T* my_ring = ring + static_cast<size_t>(warp) * kStages * PASS;
  const int n_vec = d / VEC;

  for (int v0 = 0; v0 < n_vec; v0 += 32 * NV) {
    int col[NV];  // clamped column of each of the lane's vectors
    int off[NV];  // their place within a pass
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = v0 + j * 32 + lane;
      col[j] = min(v, n_vec - 1) * VEC;
      off[j] = (j * 32 + lane) * VEC;
    }
    float acc[NV][VEC];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[j][t] = 0.f;

    if constexpr (kRing) {
      auto issue = [&](int k, int stage) {
        const T* xr = x + static_cast<size_t>(c_src[k]) * d;
        T* dst = my_ring + stage * PASS;
#pragma unroll
        for (int j = 0; j < NV; ++j) cp_async<VEC * sizeof(T)>(dst + off[j], xr + col[j]);
      };
#pragma unroll
      for (int st = 0; st < kStages - 1; ++st) {
        if (k0 + st < k1) issue(k0 + st, st);
        cp_async_commit();
      }
      for (int k = k0; k < k1; ++k) {
        const int i = k - k0;
        if (k + kStages - 1 < k1) issue(k + kStages - 1, (i + kStages - 1) % kStages);
        cp_async_commit();
        cp_async_wait<kStages - 1>();  // this lane's copies of edge k have landed
        const T* row = my_ring + (i % kStages) * PASS;
        const float wk = c_w[k];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float xv[VEC];
          load_vec<T, VEC>(row + off[j], xv);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[j][t] = fmaf(wk, xv[t], acc[j][t]);
        }
      }
      cp_async_wait<0>();
    } else {
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const T* xr = x + static_cast<size_t>(c_src[k]) * d;
        const float wk = c_w[k];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float xv[VEC];
          load_vec<T, VEC>(xr + col[j], xv);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[j][t] = fmaf(wk, xv[t], acc[j][t]);
        }
      }
    }

    __syncthreads();  // every warp is done with the ring before it holds partials
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int t = 0; t < VEC; ++t) red[warp * PASS + off[j] + t] = acc[j][t];
    __syncthreads();
    for (int t = threadIdx.x; t < PASS; t += blockDim.x) {
      const int cc = v0 * VEC + t;
      if (cc < d) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kHubWarps; ++w) s += red[w * PASS + t];  // warp order
        partial[static_cast<size_t>(c) * d + cc] = s;
      }
    }
    __syncthreads();  // the next pass reuses the ring
  }
}

// y[hub_rows[h], :] = sum of the hub's chunk partials in chunk order: warp w
// sums a contiguous run of chunks, then the warps' sums are added in warp
// order. Block (h, 32-column tile).
__global__ void __launch_bounds__(kReduceWarps * 32)
spmm_hub_reduce_kernel(const float* __restrict__ partial, float* __restrict__ y,
                       const int32_t* __restrict__ hub_rows,
                       const int32_t* __restrict__ hub_chunk_ptr, int d) {
  __shared__ float red[kReduceWarps][32];
  const int h = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.y * 32 + lane;
  const int c0 = hub_chunk_ptr[h];
  const int n = hub_chunk_ptr[h + 1] - c0;
  const int per = (n + kReduceWarps - 1) / kReduceWarps;
  const int a = c0 + min(n, warp * per);
  const int b = c0 + min(n, warp * per + per);
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int c = a; c < b; ++c) s += partial[static_cast<size_t>(c) * d + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) t += red[w][lane];
    y[static_cast<size_t>(hub_rows[h]) * d + col] = t;
  }
}

template <typename T>
struct Problem {
  const int32_t* indptr;
  const int32_t* indices;
  const T* w;
  const T* x;
  float* y;
  int n_rows, d, group;
  const int32_t* hub_rows;
  const int32_t* hub_chunk_ptr;
  int n_hub;
  const int32_t* chunk_bounds;
  int n_chunks, threshold;
  float* partial;
  cudaStream_t stream;
};

// Launch the kernels, checking each launch before the next: the hub chunks
// and their reduction, then the light rows.
template <typename T, int VEC, int NV>
int run(const Problem<T>& p) {
  if (p.n_chunks > 0) {
    auto* hub = spmm_hub_chunk_kernel<T, VEC, NV>;
    const size_t smem = hub_ring_bytes<T, VEC, NV>() + static_cast<size_t>(p.threshold) * 8;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hub, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    hub<<<p.n_chunks, kHubWarps * 32, smem, p.stream>>>(p.indices, p.w, p.x, p.partial,
                                                        p.chunk_bounds, p.d, p.threshold);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(p.n_hub, (p.d + 31) / 32);
    spmm_hub_reduce_kernel<<<grid, kReduceWarps * 32, 0, p.stream>>>(p.partial, p.y, p.hub_rows,
                                                                     p.hub_chunk_ptr, p.d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.n_rows > 0) {
    const long long threads = static_cast<long long>(p.n_rows) * p.group;
    const int per_block = kLightWarps * 32;
    const int blocks = static_cast<int>((threads + per_block - 1) / per_block);
    spmm_light_kernel<T, VEC, NV><<<blocks, per_block, 0, p.stream>>>(
        p.indptr, p.indices, p.w, p.x, p.y, p.n_rows, p.d, p.group, p.threshold);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T, int VEC>
int run_nv(const Problem<T>& p, int nv) {
  switch (nv) {
    case 1: return run<T, VEC, 1>(p);
    case 2: return run<T, VEC, 2>(p);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool layout_ok(int d, int vec, int group, int threshold) {
  return group >= 1 && group <= 32 && (group & (group - 1)) == 0 && threshold >= 1 &&
         d % vec == 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError()
// after each of its launches (the first non-zero one), or
// cudaErrorInvalidValue for a layout it does not take.
#define SPMM_ARGS                                                                         \
  const int32_t *indptr, const int32_t *indices, const void *w, const void *x, float *y,  \
      int n_rows, int d, int vec, int nv, int group, const int32_t *hub_rows,              \
      const int32_t *hub_chunk_ptr, int n_hub, const int32_t *chunk_bounds, int n_chunks,  \
      int threshold, float *partial, void *stream

template <typename T>
static Problem<T> problem(SPMM_ARGS) {
  return Problem<T>{indptr, indices, static_cast<const T*>(w), static_cast<const T*>(x), y,
                    n_rows, d, group, hub_rows, hub_chunk_ptr, n_hub, chunk_bounds,
                    n_chunks, threshold, partial, static_cast<cudaStream_t>(stream)};
}

#define SPMM_PASS                                                                     \
  indptr, indices, w, x, y, n_rows, d, vec, nv, group, hub_rows, hub_chunk_ptr,          \
      n_hub, chunk_bounds, n_chunks, threshold, partial, stream

extern "C" int spmm_csr_f32(SPMM_ARGS) {
  if (d == 0) return 0;
  if (!layout_ok(d, vec, group, threshold)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem<float> p = problem<float>(SPMM_PASS);
  switch (vec) {
    case 4: return run_nv<float, 4>(p, nv);
    case 2: return run_nv<float, 2>(p, nv);
    case 1: return run_nv<float, 1>(p, nv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int spmm_csr_bf16(SPMM_ARGS) {
  if (d == 0) return 0;
  if (!layout_ok(d, vec, group, threshold)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem<__nv_bfloat16> p = problem<__nv_bfloat16>(SPMM_PASS);
  switch (vec) {
    case 8: return run_nv<__nv_bfloat16, 8>(p, nv);
    case 4: return run_nv<__nv_bfloat16, 4>(p, nv);
    case 2: return run_nv<__nv_bfloat16, 2>(p, nv);
    case 1: return run_nv<__nv_bfloat16, 1>(p, nv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
