"""The port's SpMM (ops/spmm.py, ops/spmm_kernels.py) against the JAX
package's: the plain f32 and bf16 versions against the Pallas kernels run in
interpret mode, and the transposed-CSR backward against ``jax.vjp`` of
``spmm`` under ``pallas`` and ``pallas_bf16``. Tolerance rtol = atol = 1e-4,
as tests/test_spmm_pallas.py: the operands are the same, the summation order
differs. On the CPU the kernel wrappers run their plain versions; the CUDA
kernels themselves are checked on the card by chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu.graph import core as jcore
from gnn_tail_generalization_tpu.ops import spmm as jspmm
from gnn_tail_generalization_tpu.ops import spmm_pallas as sp

from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.ops import _build
from gnn_tail_generalization_tpu_torch.ops import spmm as tspmm
from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

TOL = dict(rtol=1e-4, atol=1e-4)


def random_edges(rng, n, e, hub=False):
    """Weighted random edges; ``hub`` adds the hub-row stress case of
    tests/test_spmm_pallas.py (node 7 takes 500 in-edges)."""
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:
        src = np.concatenate([src, rng.integers(0, n, 500)])
        dst = np.concatenate([dst, np.full(500, 7)])
    w = rng.normal(size=len(src)).astype(np.float32)
    return np.stack([src, dst]), w


CASES = [  # (n, e, d, hub): d=48 and 256 take both JAX bf16 layouts
    (90, 600, 256, False), (40, 100, 48, True)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,e,d,hub", CASES)
def test_plain_matches_pallas_interpret(rng, n, e, d, hub, bf16):
    ei, w = random_edges(rng, n, e, hub)
    jg = jcore.build_graph(ei, n, edge_weight=w, with_dense=False)
    plan = sp.build_plan(np.asarray(jg.senders), np.asarray(jg.receivers),
                         np.asarray(jg.edge_weight), n, rb=8, eb=128)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_j = sp.spmm_via_plan(plan, jnp.asarray(x), interpret=True,
                           compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tg = tcore.build_graph(ei, n, w, with_dense=False)
    wrapper = K.spmm_csr_bf16 if bf16 else K.spmm_csr_f32
    _build.reset_launch_counts()
    y_t = wrapper(tg.indptr, tg.indices, tg.weight, torch.from_numpy(x))
    # on the CPU the wrapper ran the plain version, never a kernel
    assert _build.launch_counts("spmm_csr") == {"spmm_csr_f32": 0, "spmm_csr_bf16": 0,
                                                "spmm_csr_plain": 1}
    assert y_t.dtype == torch.float32 and y_t.shape == (n, d)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("method", ["pallas", "pallas_bf16"])
@pytest.mark.parametrize("n,e,d,hub", CASES)
def test_spmm_grad_matches_jax_vjp(rng, n, e, d, hub, method):
    ei, w = random_edges(rng, n, e, hub)
    jg = jcore.build_graph(ei, n, edge_weight=w, with_dense=False,
                           with_plans=True, plan_rb=8, plan_eb=128)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ct = rng.normal(size=(n, d)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: jspmm.spmm(jg, v, method), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(ct))

    tg = tcore.build_graph(ei, n, w, with_dense=False, with_plans=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tspmm.spmm(tg, xt, method)
    y_t.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)


@pytest.mark.parametrize("method", ["auto", "dense", "gather", "pallas",
                                    "pallas_bf16"])
def test_methods_on_a_dense_graph_match_jax(rng, method):
    """With dense_adj, auto/dense/pallas run the dense product and
    pallas_bf16 the bf16-operand f32-accumulate one, as the JAX package
    does on a graph without plans; gather runs the plain version."""
    n = 50
    ei, w = random_edges(rng, n, 300)
    jg = jcore.build_graph(ei, n, edge_weight=w)
    tg = tcore.build_graph(ei, n, w)
    assert tg.dense_adj is not None
    x = rng.normal(size=(n, 24)).astype(np.float32)
    ct = rng.normal(size=(n, 24)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: jspmm.spmm(jg, v, method), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tspmm.spmm(tg, xt, method)
    y_t.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)


def test_bf16_rounds_operands_and_weights(rng):
    """The bf16 plain version equals the f32 one on bf16-rounded x and w."""
    n = 30
    ei, w = random_edges(rng, n, 200)
    tg = tcore.build_graph(ei, n, w, with_dense=False)
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    rw = tg.weight.to(torch.bfloat16).float()
    y_b = K.spmm_csr_bf16(tg.indptr, tg.indices, tg.weight, x)
    y_r = K.spmm_csr_f32(tg.indptr, tg.indices, rw, x.to(torch.bfloat16).float())
    torch.testing.assert_close(y_b, y_r, rtol=0, atol=0)
    assert not torch.allclose(y_b, K.spmm_csr_f32(tg.indptr, tg.indices,
                                                  tg.weight, x), rtol=0, atol=0)


def test_wrapper_checks():
    ip = torch.tensor([0, 1, 2], dtype=torch.int32)
    ix = torch.tensor([1, 0], dtype=torch.int32)
    w = torch.ones(2)
    x = torch.ones(2, 4)
    K._check(ip, ix, w, x)
    with pytest.raises(TypeError, match="int32"):
        K._check(ip.long(), ix, w, x)
    with pytest.raises(ValueError, match="CSR shapes"):
        K._check(ip, ix, torch.ones(3), x)
    with pytest.raises(ValueError, match="2-D"):
        K._check(ip, ix, w, torch.ones(8))
    with pytest.raises(ValueError, match="contiguous"):
        K._check(ip, ix, w, torch.ones(4, 2).T)
    with pytest.raises(ValueError, match="no SpMM kernel"):
        K.spmm_csr_f32(ip.to("meta"), ix.to("meta"), w.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="unknown spmm method"):
        tspmm.spmm_impl(tcore.build_graph(np.array([[0], [1]]), 2), x, "nope")


@pytest.mark.parametrize("method", ["auto", "gather", "pallas", "pallas_bf16"])
@pytest.mark.parametrize("shape", [(3, 4), (5, 4), (4,)])
def test_spmm_rejects_x_of_the_wrong_rows(rng, method, shape):
    """x must hold one row per node: the CUDA kernels gather x[src] unchecked."""
    ei, w = random_edges(rng, 4, 10)
    g = tcore.build_graph(ei, 4, w, with_dense=False)
    with pytest.raises(ValueError, match=r"must be \[4, d\]"):
        tspmm.spmm(g, torch.ones(shape), method)
    assert tspmm.spmm(g, torch.ones(4, 3), method).shape == (4, 3)


F32, BF16 = (4, 2, 1), (8, 4, 2, 1)


@pytest.mark.parametrize("d,elem,widths,expect", [
    # (vec, nv, group) of the light-row kernel: a warp covers d = 256 in one
    # pass (8 values a lane); narrower rows share a warp
    (1, 4, F32, (1, 1, 1)), (3, 4, F32, (1, 1, 4)), (16, 4, F32, (4, 1, 4)),
    (40, 4, F32, (4, 1, 16)), (128, 4, F32, (4, 1, 32)), (256, 4, F32, (4, 2, 32)),
    (6, 4, F32, (2, 1, 4)), (5, 4, F32, (1, 1, 8)), (512, 4, F32, (4, 2, 32)),
    (1, 2, BF16, (1, 1, 1)), (3, 2, BF16, (1, 1, 4)), (16, 2, BF16, (8, 1, 2)),
    (40, 2, BF16, (8, 1, 8)), (128, 2, BF16, (8, 1, 16)), (256, 2, BF16, (8, 1, 32)),
    (12, 2, BF16, (4, 1, 4))])
def test_vector_width(d, elem, widths, expect):
    x = torch.empty(3, d, dtype=torch.float32 if elem == 4 else torch.bfloat16)
    assert K.vec_width(d, x, widths) == expect[0]
    assert K.lane_layout(d, x, widths) == expect
    # a view that starts off the 16-byte grid takes narrower loads
    assert K.vec_width(d, x.view(-1)[1:].view(-1)[: d], widths) == 1


def test_build_needs_nvcc_and_hashes_source(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert [p.name for p in _build.sources()] == ["edge_attention.cu", "pair_score.cu",
                                                  "spmm_csr.cu", "topk_select.cu"]
    p0 = _build.library_path()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    (csrc / "a.cu").write_text("// one source\n")
    (csrc / "notes.txt").write_text("not a source\n")
    p1 = _build.library_path()
    assert p1 != p0 and p1.parent == tmp_path / "_build"
    assert [p.name for p in _build.sources()] == ["a.cu"]
    (csrc / "b.cuh").write_text("// a header\n")  # every source and header counts
    p2 = _build.library_path()
    assert p2 != p1 and [p.name for p in _build.sources()] == ["a.cu", "b.cuh"]
    (csrc / "b.cuh").write_text("// the header, edited\n")
    assert _build.library_path() not in (p1, p2)
    (csrc / "notes.txt").write_text("edited, still not a source\n")
    (csrc / "b.cuh").write_text("// a header\n")
    assert _build.library_path() == p2


def _wrapper_calls():
    """(entry point, the recorder counter its launch counts in, a call of its
    wrapper on small CPU operands)."""
    from gnn_tail_generalization_tpu_torch.ops import edge_attention as ea
    from gnn_tail_generalization_tpu_torch.ops import pair_score as ps
    from gnn_tail_generalization_tpu_torch.ops import topk_kernels as tk

    rng = np.random.default_rng(0)
    ei, w = random_edges(rng, 40, 100, hub=True)
    g = tcore.build_graph(ei, 40, w, with_dense=False)
    x = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    csr = (g.indptr, g.indices, g.weight, x)
    alpha = torch.ones(g.n_edge)
    pairs = torch.from_numpy(rng.integers(0, 40, (30, 2)))
    return {
        "spmm_csr_f32": (None, lambda: K.spmm_csr_f32(*csr, schedule=g.schedule)),
        "spmm_csr_bf16": (None, lambda: K.spmm_csr_bf16(*csr)),
        "topk_rows_f32": ("replace.select_calls", lambda: tk.topk_rows_f32(x, 3)),
        "edge_attn_rows_f32": (None, lambda: ea.edge_attn_rows(
            "grad", g.indptr, g.indices, x, x, 0.25, alpha=alpha, schedule=g.schedule)),
        "pair_dot_f32": ("score.kernel_calls", lambda: ps.pair_dot(x, pairs)),
    }


@pytest.mark.parametrize("name", ["spmm_csr_f32", "spmm_csr_bf16", "topk_rows_f32",
                                  "edge_attn_rows_f32", "pair_dot_f32"])
def test_each_wrapper_launches_an_entry_point_of_the_one_table(monkeypatch, name):
    """Each wrapper's CUDA route, taken here by a device rule that says
    CUDA, goes through ``_build.launch`` with its own entry point, one of
    ``_build``'s table, and as many arguments as the table types (the
    stream, which ``launch`` adds, aside)."""
    launched = []
    monkeypatch.setattr(_build, "on_cuda", lambda t, kernel: True)
    monkeypatch.setattr(_build, "launch", lambda n, device, *args, counter=None:
                        launched.append((n, device, len(args), counter)))
    counter, call = _wrapper_calls()[name]
    call()
    assert set(_build.ENTRY_POINTS) == {"spmm_csr_f32", "spmm_csr_bf16", "topk_rows_f32",
                                        "edge_attn_rows_f32", "pair_dot_f32"}
    assert launched == [(name, torch.device("cpu"), len(_build.ENTRY_POINTS[name]) - 1,
                         counter)]


def test_the_one_count_holds_every_kernel_and_plain_version():
    """One count keyed by every entry point and the counted plain versions;
    a plain call counts under its own name, and one ``reset_launch_counts``
    zeroes every count."""
    from gnn_tail_generalization_tpu_torch.ops import edge_attention as ea

    assert list(_build.LAUNCHES) == [*_build.ENTRY_POINTS, "spmm_csr_plain",
                                     "edge_attn_rows_plain"]
    _build.reset_launch_counts()
    ei, w = random_edges(np.random.default_rng(1), 30, 90)
    g = tcore.build_graph(ei, 30, w, with_dense=False)
    x = torch.randn(30, 8)
    K.spmm_csr_plain(g.indptr, g.indices, g.weight, x)
    ea.edge_attn_rows_plain("softmax", g.indptr, g.indices, x, x, 0.5)
    assert _build.launch_counts() == {**dict.fromkeys(_build.LAUNCHES, 0),
                                      "spmm_csr_plain": 1, "edge_attn_rows_plain": 1}
    assert _build.launch_counts("spmm_csr") == {"spmm_csr_f32": 0, "spmm_csr_bf16": 0,
                                                "spmm_csr_plain": 1}
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 3
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}


def test_graph_to_moves_every_tensor(rng):
    ei, w = random_edges(rng, 20, 60)
    g = tcore.build_graph(ei, 20, w).to("meta")
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == "meta", f.name
