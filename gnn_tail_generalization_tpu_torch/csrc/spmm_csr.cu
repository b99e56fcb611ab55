// CSR SpMM for Hopper (sm_90a): y[r, :] = sum_{e in indptr[r]..indptr[r+1]} w_e * x[indices_e, :]
//
// Replaces the two Pallas TPU kernels of gnn_tail_generalization_tpu/ops/spmm_pallas.py:
//   - _segment_matmul_kernel (f32)         -> spmm_csr_f32
//   - _segment_matmul_packed_kernel (bf16) -> spmm_csr_bf16: x and w are bf16
//     (rounded RTNE by the Python wrapper), products and sums in f32, y in f32.
// The TPU kernels reduce a pre-gathered [E_pad, d] stream with one-hot MXU
// matmuls over 1024-edge chunks. Here the kernel gathers x[src] itself from the
// CSR, so no [E, d] stream is ever written to device memory.
//
// What bounds it on an H100: bytes gathered. Every edge reads one source row
// (d * 4 bytes in f32, d * 2 in bf16) plus 8 bytes of index and weight; each
// output row is written once. The rows are scattered, so the gather runs
// below the card's streaming bandwidth; the reuse of hot source rows comes only
// from the 50 MB L2.
//
// Design: one warp owns one destination row, so no atomics are needed and the
// sum has a fixed order. Lanes stride the feature dimension with vector loads of
// VEC elements (16 bytes where d and the alignment allow; the wrapper picks VEC).
// Lanes past the row's last vector are masked. The warp loads 32 edges' (index,
// weight) pairs at once, one per lane, and broadcasts them with shuffles.
// Hub rows (thousands of edges) make the grid load-imbalanced; balancing them
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// bf16 bits -> f32 value (exact)
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
    v[4] = bf16_lo(t.z); v[5] = bf16_hi(t.z); v[6] = bf16_lo(t.w); v[7] = bf16_hi(t.w);
  } else if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
  } else if constexpr (VEC == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    v[0] = bf16_lo(t); v[1] = bf16_hi(t);
  } else {
    v[0] = __bfloat162float(*p);
  }
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const T* __restrict__ weight, const T* __restrict__ x, float* __restrict__ y,
                int n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int e0 = indptr[row];
  const int e1 = indptr[row + 1];
  const int n_vec = d / VEC;  // the wrapper guarantees d % VEC == 0

  for (int v0 = 0; v0 < n_vec; v0 += 32) {
    const int v = v0 + lane;
    const bool active = v < n_vec;
    const size_t col = static_cast<size_t>(v) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

    for (int eb = e0; eb < e1; eb += 32) {
      int src = 0;
      float w = 0.f;
      if (eb + lane < e1) {
        src = indices[eb + lane];
        w = to_float(weight[eb + lane]);
      }
      const int cnt = min(32, e1 - eb);
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        const int s = __shfl_sync(0xffffffffu, src, k);
        const float wk = __shfl_sync(0xffffffffu, w, k);
        if (active) {
          float xv[VEC];
          load_vec<VEC>(x + static_cast<size_t>(s) * d + col, xv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wk, xv[j], acc[j]);
        }
      }
    }
    if (active) store_vec<VEC>(y + static_cast<size_t>(row) * d + col, acc);
  }
}

template <typename T, int VEC>
void launch(const int32_t* indptr, const int32_t* indices, const T* w, const T* x, float* y,
            int n_rows, int d, cudaStream_t stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_csr_kernel<T, VEC><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(indptr, indices, w, x, y,
                                                                      n_rows, d);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a vector width it does not take.
extern "C" int spmm_csr_f32(const int32_t* indptr, const int32_t* indices, const float* w,
                            const float* x, float* y, int n_rows, int d, int vec, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: launch<float, 4>(indptr, indices, w, x, y, n_rows, d, s); break;
    case 2: launch<float, 2>(indptr, indices, w, x, y, n_rows, d, s); break;
    case 1: launch<float, 1>(indptr, indices, w, x, y, n_rows, d, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spmm_csr_bf16(const int32_t* indptr, const int32_t* indices, const void* w,
                             const void* x, float* y, int n_rows, int d, int vec, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  switch (vec) {
    case 8: launch<__nv_bfloat16, 8>(indptr, indices, wb, xb, y, n_rows, d, s); break;
    case 4: launch<__nv_bfloat16, 4>(indptr, indices, wb, xb, y, n_rows, d, s); break;
    case 2: launch<__nv_bfloat16, 2>(indptr, indices, wb, xb, y, n_rows, d, s); break;
    case 1: launch<__nv_bfloat16, 1>(indptr, indices, wb, xb, y, n_rows, d, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
