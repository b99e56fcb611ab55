"""The port's host library (``native/``) against its numpy versions and the
JAX package's native functions, on the CPU.

``g++`` builds the port's library into ``gnn_tail_generalization_tpu_torch/
_build/`` on the first call here, and the JAX package's own library where it
builds it. Every comparison of host arrays is exact: the C++ and numpy
versions sort, draw and expand the same integers. Edge LP against JAX: 1e-5,
the propagations' tolerance in ``test_torch_port_linkpred.py``.

Sizes are small (at most 50,000 edges). A node of the edge-LP cases has more
incident scored edges than the cap, so the subsample of the C++ path is
drawn: the JAX package's numpy fallback would draw another.
"""
import ast
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu import native as jnative
from gnn_tail_generalization_tpu.linkpred import edge_lp as jelp
from gnn_tail_generalization_tpu.linkpred import model as jlpm
from gnn_tail_generalization_tpu_torch import native
from gnn_tail_generalization_tpu_torch.baselines.egi import host_csr
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.linkpred import edge_lp as telp
from gnn_tail_generalization_tpu_torch.linkpred import model as tlpm
from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
from gnn_tail_generalization_tpu_torch.parallel.distgraph import build_dist_graph
from test_torch_port_linkpred import _jax_eval_fns, _split, model_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gnn_tail_generalization_tpu_torch")
HUB = 7  # the edge-LP cases' node over the cap


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library, loaded. Its loader builds it in place when
    missing and caches a failed load, so a worker that read it while
    another wrote it tries again."""
    for _ in range(10):
        if jnative.available():
            return jnative
        jnative._load_failed = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native library did not build")


def three_sorts(rows, n, jn):
    """native, plain and JAX's sort_edges_csr of ``rows``."""
    return (native.sort_edges_csr(rows, n), native.sort_edges_csr(rows, n, impl="plain"),
            jn.sort_edges_csr(np.asarray(rows, np.int64), n))


SORT_CASES = {
    "E=0": (np.zeros(0, np.int64), 5),
    "empty rows": (np.array([4, 4, 1, 9, 1, 4]), 12),
    "one row": (np.full(100, 3), 4),
    "random": (np.random.default_rng(0).integers(0, 3000, 20000), 3000),
}


@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_edges_csr_native_plain_and_jax_agree(case, jax_native):
    rows, n = SORT_CASES[case]
    (p, r), (pp, rp), (pj, rj) = three_sorts(rows, n, jax_native)
    for a in (pp, pj):
        np.testing.assert_array_equal(p, a)
    for a in (rp, rj):
        np.testing.assert_array_equal(r, a)
    assert p.dtype == r.dtype == np.int64 and r.shape == (n + 1,)
    np.testing.assert_array_equal(p, np.argsort(rows, kind="stable"))


def scored_edges(m=2000, n=300, seed=11):
    """m scored edges over n nodes: node HUB on 450 of them, 20 scored
    self-edges, 5 duplicates."""
    rng = np.random.default_rng(seed)
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    s[:450] = HUB
    d[500:520] = s[500:520]
    s[600:605], d[600:605] = s[700], d[700]
    return np.stack([s, d], axis=1)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cap", [None, 64])
def test_edge_graph_native_plain_and_jax_agree(cap, seed, jax_native):
    e = scored_edges()
    got = native.edge_graph(e[:, 0], e[:, 1], cap, seed)
    plain = native.edge_graph(e[:, 0], e[:, 1], cap, seed, impl="plain")
    want = jax_native.edge_graph_pair_arrays(e[:, 0], e[:, 1], cap, seed)
    assert got.dtype == plain.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(telp.build_edge_graph(e, cap, seed), want)
    # by the definition: distinct scored edges that share an endpoint
    m, (s, d) = len(e), e.T
    share = ((s[:, None] == s) | (s[:, None] == d) | (d[:, None] == s)
             | (d[:, None] == d)) & ~np.eye(m, dtype=bool)
    np.testing.assert_array_equal(got[:, :m], np.stack([np.arange(m)] * 2))
    pairs = np.unique(got[0, m:] * m + got[1, m:])
    if cap is None:
        np.testing.assert_array_equal(pairs, np.flatnonzero(share))
    else:
        assert share.reshape(-1)[pairs].all() and len(pairs) < share.sum()


def test_edge_graph_draws_per_seed(jax_native):
    """Two seeds keep two samples of the hub's edges; uncapped ignores it."""
    e = scored_edges()
    a, b = (native.edge_graph(e[:, 0], e[:, 1], 64, s) for s in (0, 5))
    assert a.shape != b.shape or not np.array_equal(a, b)
    np.testing.assert_array_equal(native.edge_graph(e[:, 0], e[:, 1], None, 0),
                                  native.edge_graph(e[:, 0], e[:, 1], None, 5))


@pytest.mark.parametrize("impl", native.IMPLS)
def test_edge_graph_of_no_edges(impl):
    out = native.edge_graph(np.zeros(0), np.zeros(0), 64, 0, impl=impl)
    assert out.shape == (2, 0) and out.dtype == np.int64


def small_graph(n=400, m=6000, seed=3):
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)])
    e[1, :300] = 5  # a hub row
    e[:, 300:320] = e[:, 320:340]  # duplicates
    return e, rng.random(m).astype(np.float32)


def test_csr_native_equals_plain():
    e, w = small_graph()
    for rows, cols in ((e[1], e[0]), (e[0], e[1])):
        got, want = (tcore._csr(rows, cols, w, 400, impl) for impl in native.IMPLS)
        for a, b in zip(got, want):
            a, b = (np.asarray(x) for x in (a, b))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def assert_same_tensors(a, b, what):
    """Every tensor field of two dataclass instances equal, dtype and all."""
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}.{f}"
        elif f == "schedule" or f == "schedule_t":
            assert_same_tensors(x, y, f"{what}.{f}")
        else:
            assert x == y or (x is None and y is None), f"{what}.{f}"


@pytest.mark.parametrize("weighted", [False, True])
def test_build_graph_native_equals_plain(weighted):
    e, w = small_graph()
    got, want = (tcore.build_graph(e, 400, w if weighted else None, impl=impl)
                 for impl in native.IMPLS)
    assert_same_tensors(got, want, "graph")


@pytest.mark.parametrize("edge_view", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_build_dist_graph_native_equals_plain(S, edge_view):
    """Bucket by bucket, rank by rank: indptr, indices, weights, canonical
    ids and schedules; degrees and the edge view."""
    e, w = small_graph()
    for k in range(S):
        comm = Comm(k, S, "cpu", "gloo")
        got, want = (build_dist_graph(e, 400, comm, w, rb=8, with_edge_view=edge_view,
                                      impl=impl) for impl in native.IMPLS)
        for name in ("buckets", "buckets_t"):
            for j, (a, b) in enumerate(zip(getattr(got, name), getattr(want, name))):
                assert (a.gid is None) == (not edge_view)
                assert_same_tensors(a, b, f"rank {k} {name}[{j}]")
        for f in ("deg_out", "deg_in"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert (got.edge_view is None) == (not edge_view)
        if edge_view:
            assert_same_tensors(got.edge_view, want.edge_view, "edge_view")
        assert sum(b.n_edge for b in got.buckets) == int(
            ((e[1] >= got.row0) & (e[1] < got.row0 + got.rows_per_shard)).sum())


def canonical_case(case):
    e, _ = small_graph()
    if case == "random":
        return e
    c = tcore.coalesce(e, 400)  # the canonical order already, no duplicates
    if case == "sorted with duplicates":
        return np.repeat(c, 2, axis=1)
    c[:, [-1, 0]] = c[:, [0, -1]]  # "sorted but the ends swapped"
    return c


@pytest.mark.parametrize("case", ["random", "sorted with duplicates",
                                  "sorted but the ends swapped"])
@pytest.mark.parametrize("impl", native.IMPLS)
def test_canonical_order_is_the_lexsort(case, impl):
    e = canonical_case(case)
    np.testing.assert_array_equal(native.canonical_order(e[0], e[1], 400, impl=impl),
                                  np.lexsort((e[0], e[1])))


def test_host_csr_equals_the_searchsorted_form():
    """egi.host_csr on the native sort against its numpy form before it."""
    e, _ = small_graph()
    order = np.argsort(e[1], kind="stable")
    want = (np.searchsorted(e[1][order], np.arange(401)), e[0][order])
    for a, b in zip(host_csr(e, 400), want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def failing_compiler(monkeypatch, tmp_path):
    """A compiler that fails, an empty build directory, nothing loaded."""
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)


CALLS = {
    "sort_edges_csr": lambda: native.sort_edges_csr(np.array([1, 0]), 2),
    "canonical_order": lambda: native.canonical_order(np.array([1, 0]), np.array([0, 1]), 2),
    "ring_buckets": lambda: native.ring_buckets(np.array([1, 0]), np.array([0, 1]),
                                                np.ones(2), 1, 2, 0),
    "edge_graph": lambda: native.edge_graph(np.array([1, 0]), np.array([0, 1]), 64, 0),
    "build_edge_graph": lambda: telp.build_edge_graph(np.array([[1, 0], [0, 1]]), 64),
}


@pytest.mark.parametrize("call", CALLS)
def test_a_failing_compiler_raises(call, failing_compiler):
    with pytest.raises(RuntimeError, match="false failed"):
        CALLS[call]()
    assert not list((native.BUILD_DIR).glob("*.so"))


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="not found"):
        native.sort_edges_csr(np.array([0]), 1)


def test_the_library_is_built_once_under_a_hashed_name():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libhost_prep_")
    assert native.library_path() == path and native.build() == path


@pytest.mark.parametrize("bad", ["impl", "range", "negative", "shape"])
def test_bad_arguments_raise_before_any_pointer_is_passed(bad):
    with pytest.raises(ValueError):
        if bad == "impl":
            native.sort_edges_csr(np.array([0]), 1, impl="numpy")
        elif bad == "range":
            native.sort_edges_csr(np.array([0, 3]), 3)
        elif bad == "negative":
            native.edge_graph(np.array([-1]), np.array([0]), None, 0)
        else:
            native.canonical_order(np.array([0, 1]), np.array([0]), 2)


def test_no_port_module_names_the_jax_native_library():
    """The port keeps its own source: no module of it (nor chip_smoke.py)
    imports the JAX package's native module or loads its library."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
        if f.endswith((".py", ".cpp"))]
    for p in paths:
        text = open(p).read()
        assert "libgraph_prep" not in text, p
        assert "gnn_tail_generalization_tpu.native" not in text, p
        if p.endswith(".py"):
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, ast.ImportFrom) and node.module:
                    assert not node.module.startswith("gnn_tail_generalization_tpu."), p
                    assert node.module != "gnn_tail_generalization_tpu", p


# ---------------------------------------------------------------------------
# the fault's witness: edge LP with a node over the cap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [64, 256])
@pytest.mark.parametrize("mode", ["logit", "emb"])
def test_capped_edge_lp_matches_jax(mode, cap, jax_native):
    """Node HUB has 450 incident scored edges, over both caps: the port
    propagates over the JAX package's subsample."""
    rng = np.random.default_rng(11)
    e = scored_edges()
    assert np.bincount(e.reshape(-1))[HUB] > cap
    if mode == "logit":
        logits = rng.normal(size=len(e)).astype(np.float32)
        got = telp.run_logit_lp(e, torch.from_numpy(logits), 100, 250, max_degree=cap)
        want = jelp.run_logit_lp(e, jnp.asarray(logits), 100, 250, max_degree=cap)
    else:
        h = rng.normal(size=(300, 8)).astype(np.float32)
        got = telp.run_emb_lp(e, torch.from_numpy(h), max_degree=cap)
        want = jelp.run_emb_lp(e, jnp.asarray(h), max_degree=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["logit", "emb"])
def test_evaluate_with_capped_edge_lp_matches_jax(mode, jax_native):
    """``evaluate`` (its default cap 256) on a split whose train positives
    put node HUB on more than 256 scored edges, and whose valid and test
    edges, positive and negative, all leave HUB: each is kept or dropped by
    the subsample."""
    n = 300
    cj, ct, msg, jm, params, tm, const_j, const_t = model_pair(
        n, eval_metric="mrr", edge_lp_mode=mode)
    split_edge = _split(n, msg)
    hub = np.stack([np.full(n - 1, HUB), np.delete(np.arange(n), HUB)], axis=1)
    split_edge["train"]["edge"] = np.concatenate([split_edge["train"]["edge"], hub])
    for s in ("valid", "test"):
        for k in ("edge", "edge_neg"):
            split_edge[s][k][:, 0] = HUB
    edges = np.concatenate([split_edge[s][k] for s in ("train", "valid", "test")
                            for k in ("edge", "edge_neg") if k in split_edge[s]])
    assert np.bincount(edges.reshape(-1))[HUB] > 256
    want = jlpm.evaluate(cj, jm, params, const_j, split_edge,
                         *_jax_eval_fns(jm, params))
    got = tlpm.evaluate(ct, tm, const_t, split_edge)
    np.testing.assert_allclose(got["MRR"], want["MRR"], rtol=1e-5)
