// Top-K of each row of an f32 matrix, for Hopper (sm_90a): for row r of
// scores [n_rows, n_cols] (row stride ld), out_vals[r, :K] and out_idx[r, :K]
// hold the K largest scores and their columns, ordered as jax.lax.top_k
// orders them: score descending, and among exactly equal scores the lower
// column first.
//
// It replaces no TPU kernel. The JAX package selects the latent neighbours
// with jax.lax.top_k in plain XLA (gnn_tail_generalization_tpu/ops/
// topk_attention.py), outside any Pallas kernel. The port's plain version
// (ops/topk_kernels.py:top_k_plain) runs torch.topk's multi-pass radix
// select, then finds the rows tied at the K-th place by a compare and an
// int64 sum over the whole chunk, reads that flag back to the host, and
// sorts three times: ~29 ms on one of the student's [8192, 169,343] score
// chunks, ~17x the time of one read of it.
//
// What bounds it on an H100: bytes. The kernel reads each score once and
// writes 12 bytes an entry: a [8192, 169,343] chunk is 5.55 GB, 1.66 ms at
// 3.35 TB/s. Choosing takes about two instructions a score.
//
// Design:
// - W warps a row (8 for rows of at least kWideRow columns, else 1),
//   kBlockWarps warps a block, so a block holds kBlockWarps / W rows. A
//   row's lanes stride through it in increasing column order with 16-byte
//   streaming loads (__ldcs: the chunk is read once), kUnroll of them in
//   flight a lane. A row of 169,343 floats starts 16-byte aligned only every
//   fourth row, so its first 0-3 columns (up to its first 16-byte boundary)
//   and its last 0-3 are read one float at a time.
// - The whole order is one 64-bit key an entry: the score's bits made
//   monotone as an unsigned integer (every NaN above +inf and equal to each
//   other, -0.0 equal to +0.0) over the complement of its column, so the
//   larger key is the better entry, ties to the lower column included. Key
//   0 is an empty slot, below every real entry, -inf included.
// - The kernel is templated on P, K rounded up to a power of two (1, 2, 4,
//   ..., 32: six instances, which nvcc builds in seconds); K is an argument.
//   Each lane keeps its P best keys sorted in registers. A score strictly
//   below the lane's P-th (one float compare: nearly every score, once the
//   lane has seen a few) is skipped; any other is keyed, and if its key is
//   larger than the P-th, it goes into the list by one pass of
//   compare-swaps.
// - The lanes' lists are merged by an xor butterfly of shuffles, then the
//   W warps' lists of a row, through shared memory, by a butterfly over the
//   row's first warp (lanes past W hold empty lists). A merge of two sorted
//   lists takes the elementwise maximum of one and the other reversed (the
//   best P of both, as a bitonic sequence) and sorts it by a bitonic
//   network.
// - Lane j < K of the row's first warp writes entry j: its column as int64
//   and its value read back from the row, so that the value's bits are the
//   input's, as the plain version gathers them.
// - No atomics: the same input gives the same output on every launch.
// Measured on an H100 (PERF.md, chip_smoke.py phase 4): 89-94% of the
// one-read bound on the arxiv chunk; 1, 2 or 4 warps a row and 2 or 8 loads
// in flight a lane were within 5% of it there and slower on 512 rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long Key;

constexpr int kBlockWarps = 8;  // warps a block
constexpr int kRowWarps = 8;    // warps a wide row: the whole block
constexpr int kUnroll = 4;      // 16-byte loads a lane keeps in flight
constexpr int kWideRow = 4096;  // columns from which a row takes kRowWarps warps
constexpr int kMaxK = 32;

// the score's bits as an unsigned integer in the score's order
__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v != v) return 0xffffffffu;  // every NaN, above +inf
  uint32_t b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;  // -0.0 as +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ Key entry(float v, int col) {
  return (static_cast<Key>(order_bits(v)) << 32) | static_cast<uint32_t>(~col);
}

// the score of an entry, as the lane's threshold: -inf for an empty slot
__device__ __forceinline__ float threshold(Key e) {
  if (e == 0) return -INFINITY;
  const uint32_t o = static_cast<uint32_t>(e >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// offers the score v at column col to a lane's sorted list
template <int P>
__device__ __forceinline__ void offer(Key (&top)[P], float& thr, float v, int col) {
  if (v < thr) return;
  Key e = entry(v, col);
  if (e <= top[P - 1]) return;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const Key t = top[j];
    top[j] = t > e ? t : e;
    e = t > e ? e : t;
  }
  thr = threshold(top[P - 1]);
}

// top becomes the best P of top and other, both sorted best first
template <int P>
__device__ __forceinline__ void merge(Key (&top)[P], const Key (&other)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) top[j] = top[j] > other[P - 1 - j] ? top[j] : other[P - 1 - j];
#pragma unroll
  for (int s = P / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if ((j & s) == 0) {
        const Key x = top[j], y = top[j + s];
        top[j] = x > y ? x : y;
        top[j + s] = x > y ? y : x;
      }
    }
  }
}

// the xor butterfly over lane distances first, first / 2, ..., 1: every lane
// ends with the best P of the 2 * first lanes around it
template <int P>
__device__ __forceinline__ void warp_merge(Key (&top)[P], int first) {
  for (int off = first; off > 0; off >>= 1) {
    Key other[P];
#pragma unroll
    for (int j = 0; j < P; ++j) other[j] = __shfl_xor_sync(0xffffffffu, top[j], off);
    merge<P>(top, other);
  }
}

template <int P>
__global__ void __launch_bounds__(kBlockWarps * 32)
topk_rows_kernel(const float* __restrict__ scores, int n_rows, int n_cols, long long ld, int k,
                 int row_warps, float* __restrict__ out_vals, long long* __restrict__ out_idx) {
  __shared__ Key staged[kBlockWarps][P];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kBlockWarps / row_warps) + warp / row_warps;
  const int part = warp % row_warps;  // the warp's place in its row
  const int lanes = 32 * row_warps;   // lanes a row
  const int t = part * 32 + lane;     // the lane's place in its row
  const bool active = row < n_rows;
  Key top[P];
#pragma unroll
  for (int j = 0; j < P; ++j) top[j] = 0;
  if (active) {
    const float* p = scores + row * ld;
    float thr = -INFINITY;
    const int head =
        min(n_cols, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2));
    if (t < head) offer<P>(top, thr, p[t], t);
    const int n_vec = (n_cols - head) >> 2;
    const float4* v = reinterpret_cast<const float4*>(p + head);
    for (int i = t; i < n_vec; i += lanes * kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * lanes < n_vec) x[u] = __ldcs(v + i + u * lanes);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * lanes;
        if (j < n_vec) {
          const int c = head + 4 * j;
          offer<P>(top, thr, x[u].x, c);
          offer<P>(top, thr, x[u].y, c + 1);
          offer<P>(top, thr, x[u].z, c + 2);
          offer<P>(top, thr, x[u].w, c + 3);
        }
      }
    }
    const int c = head + 4 * n_vec + t;
    if (c < n_cols) offer<P>(top, thr, p[c], c);
  }
  warp_merge<P>(top, 16);
  if (row_warps > 1) {
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < P; ++j) staged[warp][j] = top[j];
    }
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        top[j] = 0;
        if (lane < row_warps) top[j] = staged[warp + lane][j];
      }
      warp_merge<P>(top, 16);  // every lane ends with the row's list: lane j writes entry j
    }
  }
  if (active && part == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (lane == j && j < k) {
        const int col = static_cast<int>(~static_cast<uint32_t>(top[j]));
        out_idx[row * k + j] = col;
        out_vals[row * k + j] = scores[row * ld + col];
      }
    }
  }
}

template <int P>
int launch(const float* scores, int n_rows, int n_cols, long long ld, int k, float* out_vals,
           long long* out_idx, cudaStream_t stream) {
  const int row_warps = n_cols >= kWideRow ? kRowWarps : 1;
  const int rows_per_block = kBlockWarps / row_warps;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  topk_rows_kernel<P><<<blocks, kBlockWarps * 32, 0, stream>>>(scores, n_rows, n_cols, ld, k,
                                                               row_warps, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes): the top k (1 <= k <= 32) of each
// row of the f32 matrix scores [n_rows, n_cols] with row stride ld, into
// out_vals [n_rows, k] f32 and out_idx [n_rows, k] int64. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int topk_rows_f32(const float* scores, int n_rows, int n_cols, long long ld, int k,
                             float* out_vals, long long* out_idx, void* stream) {
  if (n_rows == 0) return 0;
  if (n_rows < 0 || k < 1 || k > kMaxK || n_cols < k || ld < n_cols ||
      (reinterpret_cast<uintptr_t>(scores) & 3u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(scores, n_rows, n_cols, ld, k, out_vals, out_idx, s);
  if (k <= 2) return launch<2>(scores, n_rows, n_cols, ld, k, out_vals, out_idx, s);
  if (k <= 4) return launch<4>(scores, n_rows, n_cols, ld, k, out_vals, out_idx, s);
  if (k <= 8) return launch<8>(scores, n_rows, n_cols, ld, k, out_vals, out_idx, s);
  if (k <= 16) return launch<16>(scores, n_rows, n_cols, ld, k, out_vals, out_idx, s);
  return launch<32>(scores, n_rows, n_cols, ld, k, out_vals, out_idx, s);
}
