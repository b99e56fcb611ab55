"""Host-side graph preparation in C++ (``graph_prep.cpp``), bound with ctypes.

The port's counterpart of ``gnn_tail_generalization_tpu/native/``, with a
source of its own. ``g++`` builds the library into
``gnn_tail_generalization_tpu_torch/_build/`` at first use; the file name
carries a hash of the source and the flags, and the build writes a
temporary file that it renames into place, so a concurrent build never
loads half a file. Nothing is built when the module is imported. A build
that fails raises ``RuntimeError`` with the command and the compiler's
output.

Each function takes ``impl``: ``"native"``, the default and the path of
every caller, runs the C++ library; ``"plain"`` runs a numpy version of
the same function, bit-equal to it, which the tests and ``chip_smoke.py``
hold it to. Nothing falls back from one to the other.

- ``sort_edges_csr``: the stable sort of an edge list by its rows and the
  CSR row pointer (``graph/core.py:_csr``, ``baselines/egi.py:host_csr``);
- ``canonical_order`` and ``ring_buckets``: the row-sharded layout's
  canonical (dst, src) order and one rank's bucket CSRs
  (``parallel/distgraph.py:build_dist_graph``);
- ``edge_graph``: the edge-graph expansion of edge label propagation, the
  JAX package's C++ path (``graph_prep.cpp:173-255`` there) with its
  per-node subsample (``linkpred/edge_lp.py:build_edge_graph``).

Every id is checked against its range before a pointer is passed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_prep.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
IMPLS = ("native", "plain")
#: the splitmix increment, the edge graph's per-node seed multiplier
_GOLDEN = 0x9E3779B97F4A7C15

_lib = None

#: one bucket: (indptr [rows + 1] int32, indices int32, weight float32,
#: canonical edge ids int64 or None)
BucketArrays = Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes() + b"\0" + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhost_prep_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found on PATH: {SRC.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _or_null(base):
    """An ndpointer argument type that also takes None (a null pointer)."""
    def from_param(cls, obj):
        return None if obj is None else base.from_param(obj)
    return type(base.__name__ + "_or_null", (base,),
                {"from_param": classmethod(from_param)})


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), its functions typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64n, c64 = _or_null(i64), ctypes.c_int64
        lib.sort_edges_csr.argtypes = [i64, c64, c64, i64, i64]
        lib.canonical_order.argtypes = [i64, i64, c64, c64, i64]
        lib.ring_bucket_counts.argtypes = [i64, i64, c64, c64, c64, c64, i64, i64]
        lib.ring_bucket_csrs.argtypes = [i64, i64, f32, c64, c64, c64, c64, i64, i64,
                                         i32, i32, f32, i64n, i32, i32, f32, i64n]
        lib.edge_graph_num_pairs.argtypes = [i64, i64, c64, c64]
        lib.edge_graph_pairs.argtypes = [i64, i64, c64, c64, ctypes.c_uint64, i64, i64]
        for fn in (lib.sort_edges_csr, lib.canonical_order, lib.ring_bucket_counts,
                   lib.ring_bucket_csrs):
            fn.restype = None
        lib.edge_graph_num_pairs.restype = c64
        lib.edge_graph_pairs.restype = c64
        _lib = lib
    return _lib


def _plain(impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "plain"


def _ids(a, n: Optional[int], name: str) -> np.ndarray:
    """``a`` as a contiguous 1-D int64 array of ids in [0, n) (n None: >= 0)."""
    a = np.ascontiguousarray(a, np.int64)
    if a.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {a.shape}")
    if a.size and (a.min() < 0 or (n is not None and a.max() >= n)):
        raise ValueError(f"{name} ids outside [0, {n})")
    return a


def sort_edges_csr(rows, n_node: int, *, impl: str = "native"):
    """(perm [E] int64, row_ptr [n_node + 1] int64): the stable sort of an
    edge list by ``rows`` (ids in [0, n_node)), ``perm`` the edge-list
    position of each sorted edge, and the CSR row pointer."""
    r = _ids(rows, n_node, "rows")
    if _plain(impl):
        row_ptr = np.zeros(n_node + 1, np.int64)
        np.cumsum(np.bincount(r, minlength=n_node), out=row_ptr[1:])
        return np.argsort(r, kind="stable"), row_ptr
    perm = np.empty(r.shape[0], np.int64)
    row_ptr = np.empty(n_node + 1, np.int64)
    load().sort_edges_csr(r, r.shape[0], n_node, perm, row_ptr)
    return perm, row_ptr


def canonical_order(src, dst, n_node: int, *, impl: str = "native") -> np.ndarray:
    """[E] int64: the row-sharded layout's canonical edge order,
    ``np.lexsort((src, dst))`` (by dst, then src, then position)."""
    s, d = _ids(src, n_node, "src"), _ids(dst, n_node, "dst")
    if s.shape != d.shape:
        raise ValueError(f"src {s.shape} and dst {d.shape} differ")
    if _plain(impl):
        return np.lexsort((s, d))
    out = np.empty(s.shape[0], np.int64)
    load().canonical_order(s, d, s.shape[0], n_node, out)
    return out


def ring_buckets(src, dst, w, rows: int, n_shards: int, shard: int, *,
                 with_gid: bool = False, impl: str = "native"
                 ) -> Tuple[List[BucketArrays], List[BucketArrays]]:
    """Rank ``shard``'s forward and transposed buckets of the row-sharded
    layout, from edges already in the canonical order (their positions are
    the edge ids) over ``n_shards * rows`` nodes. Forward bucket j: the
    edges with dst in shard ``shard`` and src in shard j, a CSR over the
    local dst rows with local sources. Transposed bucket j: the edges with
    src in shard ``shard`` and dst in shard j, a CSR over the local src
    rows. Within a row, edges keep the canonical order. ``with_gid``: each
    slot's canonical edge id too."""
    n = rows * n_shards
    s, d = _ids(src, n, "src"), _ids(dst, n, "dst")
    w = np.ascontiguousarray(w, np.float32)
    if not s.shape == d.shape == w.shape:
        raise ValueError(f"src {s.shape}, dst {d.shape} and w {w.shape} differ")
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    lo = shard * rows
    if _plain(impl):
        src_shard, dst_shard = s // rows, d // rows

        def bucket_set(mine, row_ids, col_ids, col_shard):
            out = []
            for j in range(n_shards):
                ids = mine[col_shard[mine] == j]
                perm, indptr = sort_edges_csr(row_ids[ids] - lo, rows, impl="plain")
                ids = ids[perm]
                out.append((indptr.astype(np.int32),
                            (col_ids[ids] - j * rows).astype(np.int32), w[ids],
                            ids if with_gid else None))
            return out

        return (bucket_set(np.flatnonzero(dst_shard == shard), d, s, src_shard),
                bucket_set(np.flatnonzero(src_shard == shard), s, d, dst_shard))
    lib, e = load(), s.shape[0]
    counts = [np.empty(n_shards, np.int64) for _ in range(2)]
    lib.ring_bucket_counts(s, d, e, rows, n_shards, shard, *counts)
    if max(c.max() for c in counts) >= 2**31:
        raise ValueError("a bucket over 2^31 edges: the CSR kernels index with int32")
    offs = [np.concatenate([[0], np.cumsum(c)]) for c in counts]
    sets = [(np.empty(n_shards * (rows + 1), np.int32), np.empty(o[-1], np.int32),
             np.empty(o[-1], np.float32), np.empty(o[-1], np.int64) if with_gid else None)
            for o in offs]
    lib.ring_bucket_csrs(s, d, w, e, rows, n_shards, shard, offs[0], offs[1],
                         *sets[0], *sets[1])

    def split(arrs, off):
        ip, idx, wt, gid = arrs
        return [(ip[j * (rows + 1):(j + 1) * (rows + 1)], idx[off[j]:off[j + 1]],
                 wt[off[j]:off[j + 1]], None if gid is None else gid[off[j]:off[j + 1]])
                for j in range(n_shards)]

    return split(sets[0], offs[0]), split(sets[1], offs[1])


def _mix64(x: np.ndarray) -> np.ndarray:
    """graph_prep.cpp's mix64 on uint64 arrays (wrapping arithmetic)."""
    u = np.uint64
    x = x + u(_GOLDEN)
    x = (x ^ (x >> u(30))) * u(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> u(27))) * u(0x94D049BB133111EB)
    return x ^ (x >> u(31))


def edge_graph(src, dst, max_degree: Optional[int], seed: int, *,
               impl: str = "native") -> np.ndarray:
    """[2, m + n_pairs] int64: the edge graph over the m scored edges
    (``src[i]``, ``dst[i]``): the m self loops (i, i), then node by node
    every ordered pair (a, b) of distinct scored edges incident to the
    node, a-major. A node's incident edges are taken in edge order, an
    edge's src end before its dst end (a scored self-edge twice, never
    paired with itself); past ``max_degree`` of them (None: uncapped), a
    partial Fisher-Yates shuffle seeded by (``seed``, node) keeps a uniform
    sample of ``max_degree``. The JAX package's native function, values and
    order."""
    s, d = _ids(src, None, "src"), _ids(dst, None, "dst")
    m = s.shape[0]
    if d.shape != s.shape:
        raise ValueError(f"src {s.shape} and dst {d.shape} differ")
    if m >= 2**31:
        raise ValueError("the edge graph numbers its scored edges with int32")
    cap = 0 if max_degree is None else int(max_degree)
    seed = int(seed) % 2**64
    if not _plain(impl):
        lib = load()
        out = np.empty((2, m + lib.edge_graph_num_pairs(s, d, m, cap)), np.int64)
        written = lib.edge_graph_pairs(s, d, m, cap, seed, out[0], out[1])
        return out[:, :written]

    loops = np.arange(m, dtype=np.int64)
    if m == 0:
        return np.stack([loops, loops])
    nodes = np.stack([s, d], axis=1).reshape(-1)  # edge i's src end, then its dst end
    inc = np.repeat(loops, 2)[np.argsort(nodes, kind="stable")]
    counts = np.bincount(nodes)
    row_ptr = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    sizes = counts
    if cap > 0:
        capped = np.flatnonzero(counts > cap)
        k, base = counts[capped].astype(np.uint64), row_ptr[capped]
        with np.errstate(over="ignore"):
            state = _mix64(np.uint64(seed) ^ (capped.astype(np.uint64) * np.uint64(_GOLDEN)))
            for t in range(cap if capped.size else 0):
                state = _mix64(state)
                j = base + t + (state % (k - np.uint64(t))).astype(np.int64)
                inc[base + t], inc[j] = inc[j], inc[base + t]
        sizes = np.minimum(counts, cap)
    # the first sizes[v] of node v's incident edges, expanded a-major
    pos = np.arange(inc.shape[0]) - np.repeat(row_ptr[:-1], counts)
    g = inc[pos < np.repeat(sizes, counts)]
    starts = np.zeros(sizes.shape[0], np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    row_len = np.repeat(sizes, sizes)
    row_start = np.zeros(row_len.shape[0], np.int64)
    np.cumsum(row_len[:-1], out=row_start[1:])
    n_pairs = int(row_len.sum())
    a = np.repeat(g, row_len)
    b = g[np.repeat(np.repeat(starts, sizes) - row_start, row_len)
          + np.arange(n_pairs, dtype=np.int64)]
    keep = a != b
    return np.stack([np.concatenate([loops, a[keep]]),
                     np.concatenate([loops, b[keep]])])
