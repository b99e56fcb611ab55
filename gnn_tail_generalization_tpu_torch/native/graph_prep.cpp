// Host-side graph preparation for the PyTorch/CUDA port.
//
// The port's counterpart of gnn_tail_generalization_tpu/native/graph_prep.cpp:
// the sorts and expansions that build the host CSRs the CUDA kernels read.
// numpy has no counting sort, and its stable argsort and lexsort take
// seconds at 30M edges; a counting pass over int64 ids is one read and one
// scattered write an edge.
//
//   - sort_edges_csr: the stable sort of an edge list by its rows, with the
//     CSR row pointer (graph/core.py:_csr, baselines/egi.py:host_csr);
//   - canonical_order, ring_bucket_counts, ring_bucket_csrs: the row-sharded
//     layout's canonical (dst, src) edge order and one rank's forward and
//     transposed bucket CSRs (parallel/distgraph.py:build_dist_graph);
//   - edge_graph_num_pairs, edge_graph_pairs: the edge-graph expansion of
//     edge label propagation (linkpred/edge_lp.py:build_edge_graph), the
//     JAX package's C++ function, draws included.
//
// The JAX package's TPU chunk plans (segment_matmul_plan, plan_num_chunks)
// and padded [S, S, e_bucket] ring buckets have no counterpart: a CSR needs
// neither. Plain C ABI, bound with ctypes in native/__init__.py, which also
// holds a numpy version of every function and checks ids before a call.

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// One stable counting pass: out[...] = in[...] grouped by keys[in[i]], in
// the order of ``in`` within a key (in == nullptr: the identity order).
// Keys lie in [0, n_keys).
void counting_pass(const int64_t* keys, const int64_t* in, int64_t n,
                   int64_t n_keys, int64_t* out) {
  std::vector<int64_t> cur(n_keys + 1, 0);
  for (int64_t i = 0; i < n; ++i) cur[keys[in ? in[i] : i] + 1]++;
  for (int64_t r = 0; r < n_keys; ++r) cur[r + 1] += cur[r];
  for (int64_t i = 0; i < n; ++i) {
    int64_t e = in ? in[i] : i;
    out[cur[keys[e]]++] = e;
  }
}

inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

int64_t n_nodes_of(const int64_t* src, const int64_t* dst, int64_t m) {
  int64_t n = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (src[i] + 1 > n) n = src[i] + 1;
    if (dst[i] + 1 > n) n = dst[i] + 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Stable sort of the edges by ``rows`` (ids in [0, n_node)): out_perm[E]
// the edge-list position of each sorted edge, out_row_ptr[n_node + 1] the
// CSR row pointer. Equal to np.argsort(rows, kind="stable") and the
// cumulative bincount.
void sort_edges_csr(const int64_t* rows, int64_t n_edge, int64_t n_node,
                    int64_t* out_perm, int64_t* out_row_ptr) {
  std::memset(out_row_ptr, 0, sizeof(int64_t) * (n_node + 1));
  for (int64_t i = 0; i < n_edge; ++i) out_row_ptr[rows[i] + 1]++;
  for (int64_t r = 0; r < n_node; ++r) out_row_ptr[r + 1] += out_row_ptr[r];
  std::vector<int64_t> cur(out_row_ptr, out_row_ptr + n_node);
  for (int64_t i = 0; i < n_edge; ++i) out_perm[cur[rows[i]]++] = i;
}

// The canonical edge order of the row-sharded layout, np.lexsort((src,
// dst)): by dst, ties by src, ties by position. Two stable counting passes,
// by src and then by dst; none where the edges are in that order already
// (graph/core.py:coalesce returns them so), since both passes scatter at
// random. Ids lie in [0, n_node).
void canonical_order(const int64_t* src, const int64_t* dst, int64_t n_edge,
                     int64_t n_node, int64_t* out_perm) {
  int64_t i = 1;
  while (i < n_edge && (dst[i - 1] < dst[i] ||
                        (dst[i - 1] == dst[i] && src[i - 1] <= src[i])))
    ++i;
  if (i >= n_edge) {
    for (int64_t e = 0; e < n_edge; ++e) out_perm[e] = e;
    return;
  }
  std::vector<int64_t> by_src(n_edge);
  counting_pass(src, nullptr, n_edge, n_node, by_src.data());
  counting_pass(dst, by_src.data(), n_edge, n_node, out_perm);
}

// Edges of rank ``shard``'s forward buckets (dst in its shard; bucket j: src
// in shard j) and transposed buckets (src in its shard; bucket j: dst in
// shard j), over edges in the canonical order.
void ring_bucket_counts(const int64_t* src, const int64_t* dst, int64_t n_edge,
                        int64_t rows, int64_t n_shards, int64_t shard,
                        int64_t* out_fwd, int64_t* out_t) {
  std::memset(out_fwd, 0, sizeof(int64_t) * n_shards);
  std::memset(out_t, 0, sizeof(int64_t) * n_shards);
  for (int64_t i = 0; i < n_edge; ++i) {
    int64_t ks = dst[i] / rows, js = src[i] / rows;
    if (ks == shard) out_fwd[js]++;
    if (js == shard) out_t[ks]++;
  }
}

// Rank ``shard``'s 2S bucket CSRs over ``rows`` local rows, from edges in
// the canonical order (the edge id is the position). Bucket j's slots are
// [off[j], off[j + 1]) of the indices, weights and ids (the prefix sums of
// ring_bucket_counts); its row pointer is indptr[j * (rows + 1) ...], in
// bucket-local slots. A forward bucket's rows are local dsts, its indices
// local srcs in shard j, already in row order: the canonical order sorts by
// dst. A transposed bucket's rows are local srcs, its indices local dsts in
// shard j, stably sorted by row. out_*_gid may be null.
void ring_bucket_csrs(const int64_t* src, const int64_t* dst, const float* w,
                      int64_t n_edge, int64_t rows, int64_t n_shards,
                      int64_t shard, const int64_t* fwd_off,
                      const int64_t* t_off, int32_t* fwd_indptr,
                      int32_t* fwd_indices, float* fwd_w, int64_t* fwd_gid,
                      int32_t* t_indptr, int32_t* t_indices, float* t_w,
                      int64_t* t_gid) {
  const int64_t lo = shard * rows, stride = rows + 1;
  std::memset(fwd_indptr, 0, sizeof(int32_t) * n_shards * stride);
  std::memset(t_indptr, 0, sizeof(int32_t) * n_shards * stride);
  std::vector<int64_t> fill(n_shards, 0);
  for (int64_t i = 0; i < n_edge; ++i) {
    int64_t ks = dst[i] / rows, js = src[i] / rows;
    if (ks == shard) {
      int64_t p = fwd_off[js] + fill[js]++;
      fwd_indptr[js * stride + (dst[i] - lo) + 1]++;
      fwd_indices[p] = (int32_t)(src[i] - js * rows);
      fwd_w[p] = w[i];
      if (fwd_gid) fwd_gid[p] = i;
    }
    if (js == shard) t_indptr[ks * stride + (src[i] - lo) + 1]++;
  }
  for (int64_t j = 0; j < n_shards; ++j) {
    for (int64_t r = 0; r < rows; ++r) {
      fwd_indptr[j * stride + r + 1] += fwd_indptr[j * stride + r];
      t_indptr[j * stride + r + 1] += t_indptr[j * stride + r];
    }
  }
  // the transposed buckets' counting pass, in canonical order: stable
  std::vector<int64_t> cur(n_shards * rows);
  for (int64_t j = 0; j < n_shards; ++j)
    for (int64_t r = 0; r < rows; ++r)
      cur[j * rows + r] = t_off[j] + t_indptr[j * stride + r];
  for (int64_t i = 0; i < n_edge; ++i) {
    int64_t ks = dst[i] / rows, js = src[i] / rows;
    if (js != shard) continue;
    int64_t p = cur[ks * rows + (src[i] - lo)]++;
    t_indices[p] = (int32_t)(dst[i] - ks * rows);
    t_w[p] = w[i];
    if (t_gid) t_gid[p] = i;
  }
}

// ---- the edge graph (linkpred/edge_lp.py:build_edge_graph) ---------------
//
// Two scored edges are adjacent iff they share an endpoint. Node v's
// incident edges, in edge order (an edge's src end before its dst end, so a
// scored self-edge sits twice), are uniformly subsampled to max_degree by a
// partial Fisher-Yates shuffle driven by a splitmix generator seeded per
// (seed, node), then expanded to all ordered pairs of distinct edges. The
// JAX package's graph_prep.cpp:173-255, to the bit.

// An upper bound of the pairs edge_graph_pairs writes after the m self
// loops (it counts a scored self-edge's pair with itself). max_degree <= 0:
// uncapped.
int64_t edge_graph_num_pairs(const int64_t* src, const int64_t* dst, int64_t m,
                             int64_t max_degree) {
  int64_t n = n_nodes_of(src, dst, m);
  std::vector<int64_t> counts(n, 0);
  for (int64_t i = 0; i < m; ++i) { counts[src[i]]++; counts[dst[i]]++; }
  int64_t pairs = 0;
  for (int64_t v = 0; v < n; ++v) {
    int64_t k = counts[v];
    if (max_degree > 0 && k > max_degree) k = max_degree;
    pairs += k * (k - 1);
  }
  return pairs;
}

// Writes the m self loops (i, i), then node by node the pairs (a, b),
// a-major; returns the number of entries written.
int64_t edge_graph_pairs(const int64_t* src, const int64_t* dst, int64_t m,
                         int64_t max_degree, uint64_t seed, int64_t* out_a,
                         int64_t* out_b) {
  for (int64_t i = 0; i < m; ++i) { out_a[i] = i; out_b[i] = i; }
  out_a += m;
  out_b += m;
  int64_t n = n_nodes_of(src, dst, m);
  std::vector<int64_t> row_ptr(n + 1, 0);
  for (int64_t i = 0; i < m; ++i) { row_ptr[src[i] + 1]++; row_ptr[dst[i] + 1]++; }
  for (int64_t v = 0; v < n; ++v) row_ptr[v + 1] += row_ptr[v];
  std::vector<int32_t> inc(row_ptr[n]);
  std::vector<int64_t> cur(row_ptr.begin(), row_ptr.end() - 1);
  for (int64_t i = 0; i < m; ++i) {
    inc[cur[src[i]]++] = (int32_t)i;
    inc[cur[dst[i]]++] = (int32_t)i;
  }
  int64_t p = 0;
  for (int64_t v = 0; v < n; ++v) {
    int64_t k = row_ptr[v + 1] - row_ptr[v];
    int32_t* g = inc.data() + row_ptr[v];
    if (max_degree > 0 && k > max_degree) {
      uint64_t s = mix64(seed ^ (uint64_t)v * 0x9e3779b97f4a7c15ULL);
      for (int64_t t = 0; t < max_degree; ++t) {
        s = mix64(s);
        int64_t j = t + (int64_t)(s % (uint64_t)(k - t));
        std::swap(g[t], g[j]);
      }
      k = max_degree;
    }
    for (int64_t i = 0; i < k; ++i) {
      int32_t a = g[i];
      for (int64_t j = 0; j < k; ++j) {
        if (a == g[j]) continue;  // values: a self-edge never pairs with itself
        out_a[p] = a;
        out_b[p] = g[j];
        ++p;
      }
    }
  }
  return m + p;
}

}  // extern "C"
