// Dot-product scores of node pairs, for Hopper (sm_90a): for the f32 table
// h [n, d] (row-major, contiguous) and the int64 pairs [m, 2] (read in place,
// row stride 2), out[p] = sum_k h[pairs[p][0]][k] * h[pairs[p][1]][k].
//
// It replaces no TPU kernel. The JAX package scores an evaluation's pairs in
// plain XLA (gnn_tail_generalization_tpu/linkpred/model.py:508-522). The
// port's plain version (ops/pair_score.py:pair_dot_plain) gathers the source
// and destination rows of 65,536 pairs at a time, multiplies them into a
// third such tensor and sums it: about 8 KB of traffic a pair at d = 256, and
// ~10,600 launches an OGB evaluation of ogbl-citation2.
//
// What bounds it on an H100: bytes. A pair needs its destination row (1 KB at
// d = 256), its 16 bytes of indices and its 4-byte score; a source row is
// needed once a run of pairs that share it (OGB's layout repeats each
// positive's source on its 1,000 negatives). An evaluation's 173.4M pairs
// are ~181 GB, ~54 ms at 3.35 TB/s; their 2 d operations a pair ~1.3 ms at
// 67 TFLOP/s.
//
// Design:
// - A warp scores a tile of kTile contiguous pairs, 32 at a time, and the
//   grid (as many blocks as fit on the card at once) walks the tiles
//   grid-stride. Lane l loads pair l's two indices with one 16-byte streaming
//   load (512 coalesced bytes a warp). An index outside [0, n) traps, as
//   torch's gather asserts on the card; nothing is read back to the host.
// - At d % 128 == 0 (up to d = 512) lane l owns columns 4l..4l+3 of each
//   128-column block and reads them with 16-byte loads: two float4s a row at
//   d = 256. The warp issues the destination rows of kUnroll pairs before it
//   reduces any of them, as streaming loads (__ldcs: no row is reused).
// - A lane keeps the source row's slice in registers and reloads it only
//   where a pair's source index differs from the one it holds (a
//   warp-uniform branch: the index is broadcast by a shuffle). Grouped
//   negatives then read a source once a run; positives, whose sources all
//   differ, run the same code; no result depends on the grouping.
// - Exact f32: each lane accumulates its products with fmaf in column
//   order, then a fixed xor butterfly over the warp adds the 32 partials
//   (every lane ends with the same bits, since IEEE addition commutes). No
//   TF32, no atomics, no fast-math: two launches give identical bits.
// - Any other d, or a table not 16-byte aligned, takes a scalar path (lane l
//   owns columns l, l + 32, ...): correct, not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;    // warps a block
constexpr int kTile = 256;   // contiguous pairs a warp takes from the grid
constexpr int kMaxVec = 4;   // float4s a lane holds of a row: d <= 512

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// pair p's (source, destination), p clamped to the last pair (a lane past
// the end scores that pair again and stores nothing); traps on an index
// outside [0, n)
__device__ __forceinline__ longlong2 load_pair(const long long* pairs, long long p,
                                               long long m, long long n) {
  const longlong2 e = __ldcs(reinterpret_cast<const longlong2*>(pairs) + (p < m ? p : m - 1));
  if (static_cast<unsigned long long>(e.x) >= static_cast<unsigned long long>(n) ||
      static_cast<unsigned long long>(e.y) >= static_cast<unsigned long long>(n))
    __trap();
  return e;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// NV float4s a lane a row (d = 128 NV)
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    pair_dot_vec_kernel(const float* __restrict__ h, const long long* __restrict__ pairs,
                        float* __restrict__ out, long long n, long long m) {
  constexpr int kUnroll = NV <= 2 ? 8 : 4;  // destination rows in flight a warp
  const int d = 128 * NV;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const long long n_tiles = (m + kTile - 1) / kTile;
  long long held = -1;  // the source whose slice src holds
  float4 src[NV];
  for (long long tile = warp; tile < n_tiles; tile += n_warps) {
    for (int r = 0; r < kTile; r += 32) {
      const long long base = tile * kTile + r;
      if (base >= m) break;
      const longlong2 mine = load_pair(pairs, base + lane, m, n);
      float score = 0.f;
#pragma unroll 1
      for (int g = 0; g < 32; g += kUnroll) {
        float4 dst[kUnroll][NV];
        long long s_of[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long t = __shfl_sync(kFull, mine.y, g + i);
          s_of[i] = __shfl_sync(kFull, mine.x, g + i);
          const float4* row = reinterpret_cast<const float4*>(h + t * d) + lane;
#pragma unroll
          for (int v = 0; v < NV; ++v) dst[i][v] = __ldcs(row + 32 * v);
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          if (s_of[i] != held) {
            held = s_of[i];
            const float4* row = reinterpret_cast<const float4*>(h + held * d) + lane;
#pragma unroll
            for (int v = 0; v < NV; ++v) src[v] = __ldg(row + 32 * v);
          }
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v) acc = dot4(src[v], dst[i][v], acc);
          acc = warp_sum(acc);
          if (lane == g + i) score = acc;
        }
      }
      if (base + lane < m) __stcs(out + base + lane, score);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    pair_dot_scalar_kernel(const float* __restrict__ h, const long long* __restrict__ pairs,
                           float* __restrict__ out, long long n, long long m, int d) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long base = warp * 32; base < m; base += n_warps * 32) {
    const longlong2 mine = load_pair(pairs, base + lane, m, n);
    float score = 0.f;
    for (int j = 0; j < 32; ++j) {
      const float* a = h + __shfl_sync(kFull, mine.x, j) * d;
      const float* b = h + __shfl_sync(kFull, mine.y, j) * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32) acc = fmaf(a[c], b[c], acc);
      acc = warp_sum(acc);
      if (lane == j) score = acc;
    }
    if (base + lane < m) out[base + lane] = score;
  }
}

// as many blocks as the card holds at once, and no more than the work needs
template <typename Kernel>
int grid_size(Kernel kernel, long long warp_units) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, 0);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long needed = (warp_units + kWarps - 1) / kWarps;
  return static_cast<int>(needed < resident ? needed : resident);
}

template <int NV>
void launch_vec(const float* h, const long long* pairs, float* out, long long n, long long m,
                cudaStream_t stream) {
  const int blocks = grid_size(pair_dot_vec_kernel<NV>, (m + kTile - 1) / kTile);
  pair_dot_vec_kernel<NV><<<blocks, kWarps * 32, 0, stream>>>(h, pairs, out, n, m);
}

}  // namespace

// Plain C interface (loaded with ctypes): out [m] f32 gets the dot product of
// rows pairs[p][0] and pairs[p][1] of the f32 table h [n, d], for the int64
// pairs [m, 2] (16-byte aligned). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments it does not take.
extern "C" int pair_dot_f32(const float* h, const long long* pairs, float* out, long long n,
                            long long m, int d, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || n <= 0 || d <= 0 || (reinterpret_cast<uintptr_t>(pairs) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(h) & 3u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 128 == 0 && d / 128 <= kMaxVec &&
                   (reinterpret_cast<uintptr_t>(h) & 15u) == 0;
  switch (vec ? d / 128 : 0) {
    case 1: launch_vec<1>(h, pairs, out, n, m, s); break;
    case 2: launch_vec<2>(h, pairs, out, n, m, s); break;
    case 3: launch_vec<3>(h, pairs, out, n, m, s); break;
    case 4: launch_vec<4>(h, pairs, out, n, m, s); break;
    default: {
      const int blocks = grid_size(pair_dot_scalar_kernel, (m + 31) / 32);
      pair_dot_scalar_kernel<<<blocks, kWarps * 32, 0, s>>>(h, pairs, out, n, m, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
