"""The bench twins ``bench_torch.py`` and ``bench_linkpred_torch.py`` against
the JAX package's ``bench.py`` and ``bench_linkpred.py`` on the CPU, at
``tests/test_entry_points.py``'s size (1,500 nodes, 32 features, hidden 32,
5 classes, 6,000 edges) unless a test says otherwise.

At that size (under 8,192 nodes) neither package builds plans, so both
sides aggregate in f32 (a dense adjacency): the bf16 kernel path of the
twins is held on the card, by ``chip_smoke.py`` phase 15's launch counts
and by phases 2-3's kernel-against-plain checks. The workload test also
runs at 9,000 nodes, where both packages build plans.

Tolerances (max |twin - JAX| over max |JAX| of each tensor): the loss 1e-5,
every gradient and every Adam-updated parameter 1e-4. No norm applies in
the bench config (``InitialBatchNorm`` is not a bare norm name,
``nn/norms.py:norm_applies``), so no conv bias stands in front of a batch
norm. The framework step runs under ``auto`` (f32 throughout) and under the
bench's ``pallas_bf16``, where each conv rounds its input and kernel to
bf16 even on a dense adjacency (``nn/gcn.py``) and the cast's backward
rounds the kernel's gradient: two sum orders may leave it one bf16 ulp
apart (2^-7 of the tensor's largest entry at most), so the conv kernels'
gradients are held to that there. Adam's first step moves an entry by
lr g / (|g| + 1e-8), so under ``pallas_bf16`` the entries whose gradient lies
within its tolerance of zero are held by the gradient check only (they are
~2e-8 against a largest 1e-2 in the input Dense's kernel; under ``auto``
every entry is compared after Adam).
"""
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bench
import bench_linkpred_torch as lpt
import bench_torch as bt
from gnn_tail_generalization_tpu.data.synthetic import fast_powerlaw_graph as jax_powerlaw
from gnn_tail_generalization_tpu.graph.core import symmetrize as jax_symmetrize
from gnn_tail_generalization_tpu.linkpred import metrics as jax_metrics
from gnn_tail_generalization_tpu.linkpred import sampling as jax_sampling
from gnn_tail_generalization_tpu.train import loops as jax_loops
from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization_tpu_torch.linkpred import metrics as port_metrics
from gnn_tail_generalization_tpu_torch.ops.spmm_kernels import spmm_bound
from gnn_tail_generalization_tpu_torch.train import loops as port_loops
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax
from test_torch_port_host import BLOCK_JAX, REPO, assert_csr_matches

SMALL = dict(n_node=1500, n_feat=32, n_hidden=32, n_class=5, n_edge=6000)
PLANNED = dict(n_node=9000, n_feat=16, n_hidden=32, n_class=5, n_edge=40000)
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to a tensor's largest entry


def flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    rel = np.abs(got - want).max() / scale
    assert rel <= tol, f"{what}: rel {rel:.3e} > {tol}"


def adam_mu(state):
    """The first-moment tree of the (only) optax Adam state in ``state``."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return adam.mu


@pytest.mark.parametrize("size", [SMALL, PLANNED], ids=["dense", "planned"])
def test_workload_matches_bench(size):
    """``build_raw_workload`` / ``build_workload`` against ``bench.py``'s:
    the config, the raw arrays and the prepared CSR pair (and the loss-masked
    view), bit for bit."""
    cj, dj = bench.build_raw_workload(**size)
    ct, dt = bt.build_raw_workload(**size)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.type_trick, ct.num_layers, ct.dropout, ct.lr, ct.spmm_method) == (
        "InitialBatchNorm", 2, 0.1, 0.005, "pallas_bf16")
    for f in ("x", "y", "edge_index", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f), err_msg=f)
    cj, pj = bench.build_workload(**size)
    ct, pt = bt.build_workload(**size)
    assert pt.graph.has_plans == (pj.graph.plans is not None)
    assert pt.graph.has_plans == (size["n_node"] > 8192)
    assert_csr_matches(pt.graph, pj.graph)
    assert_csr_matches(port_loops.final_agg_view(ct, pt),
                       jax_loops.final_agg_view(cj, pj, is_dist=False))


def grad_tol(method: str, name: str) -> float:
    bf16_kernel = name.startswith("backbone.convs.") and name.endswith(".weight")
    return BF16_ULP if method == "pallas_bf16" and bf16_kernel else PARAM_TOL


@pytest.mark.parametrize("method", ["auto", "pallas_bf16"])
def test_framework_step_matches_bench(method):
    """One step of ``make_framework_step`` at dropout 0, from the weights of
    ``bench.make_framework_step`` (carried over by ``utils/convert.py``),
    against that step: the loss, every gradient (JAX's from its Adam first
    moment, mu = (1 - b1) g at the first step with no weight decay) and the
    parameters after Adam (the module docstring's rule)."""
    cj, pj = bench.build_workload(**SMALL)
    cj = dataclasses.replace(cj, dropout=0.0, spmm_method=method)
    assert cj.weight_decay == 0.0
    step_j, params_j, opt_j, const_j = bench.make_framework_step(cj, pj)
    params_j1, opt_j1, loss_j = jax.jit(step_j)(params_j, opt_j,
                                                jax.random.PRNGKey(0), const_j)
    ct, pt = bt.build_workload(**SMALL)
    ct = dataclasses.replace(ct, dropout=0.0, spmm_method=method)
    step_t, model = bt.make_framework_step(
        ct, pt, "cpu", init_state=params_from_jax(flat(params_j), ct))
    loss_t = step_t()
    assert_close(loss_t.item(), float(loss_j), LOSS_TOL, "loss")
    grads_j = params_from_jax({k: v / 0.1 for k, v in flat(adam_mu(opt_j1)).items()}, ct)
    after_j = params_from_jax(flat(params_j1), ct)
    params_t = dict(model.named_parameters())
    assert params_t.keys() == grads_j.keys() == after_j.keys()
    for k, p in params_t.items():
        tol = grad_tol(method, k)
        gj = grads_j[k].numpy()
        assert_close(p.grad.numpy(), gj, tol, f"grad {k}")
        held = np.ones(gj.shape, bool)
        if method == "pallas_bf16":
            held = np.abs(gj) > tol * np.abs(gj).max()
        got, want = p.detach().numpy(), after_j[k].numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want)[held].max() <= PARAM_TOL * scale, f"param {k}"


def test_naive_step_matches_bench():
    """One step of ``make_naive_step`` from ``bench.make_naive_step``'s
    parameters, fed the keep mask that JAX's step draws
    (``jax.random.bernoulli`` at its key): the loss and every parameter after
    Adam."""
    cj, pj = bench.build_workload(**SMALL)
    step_j, params_j, opt_j, const_j = bench.make_naive_step(cj, pj)
    key = jax.random.PRNGKey(0)
    params_j1, _, loss_j = jax.jit(step_j)(params_j, opt_j, key, const_j)
    keep = np.array(jax.random.bernoulli(key, 0.9, const_j["x"].shape))
    ct, pt = bt.build_workload(**SMALL)
    step_t, params_t = bt.make_naive_step(
        ct, pt, "cpu", params={k: np.asarray(v) for k, v in params_j.items()})
    loss_t = step_t(torch.from_numpy(keep))
    assert_close(loss_t.item(), float(loss_j), LOSS_TOL, "loss")
    assert params_t.keys() == params_j1.keys()
    for k, p in params_t.items():
        assert_close(p.detach().numpy(), params_j1[k], PARAM_TOL, k)


@pytest.mark.parametrize("size", [SMALL, PLANNED], ids=["dense", "planned"])
def test_dist_numerics_one_rank(size):
    """``bench.py:run_dist``'s check on the twin's pieces: 3 coupled steps of
    the one-rank sharded teacher (rb = 128) against the one-device teacher,
    loss rel diff < 5e-3. Observed: 0.0 at 1,500 nodes (dense adjacency),
    7.4e-08 at 9,000 (plans; the ring's bucket against the plain CSR)."""
    cfg, data = bt.build_raw_workload(**size)
    rel = bt.dist_numerics(cfg, data, "cpu")
    assert len(rel) == bt.DIST_STEPS and max(rel) < 1e-6, rel
    assert max(rel) < bt.DIST_REL_TOL


@pytest.mark.parametrize("bf16", [False, True])
def test_spmm_bound_counts_each_byte_once(bf16):
    """``ops/spmm_kernels.py:spmm_bound``, which ``chip_smoke.py``,
    ``profile_spmm.py`` and both twins read, against its rule written out:
    the x rows some edge reads (3 of 5), y in f32, indices, weights (in the
    working type) and indptr once, over 3.35 TB/s; and 2 E d flops over
    67 TFLOP/s where those take longer (10,000 edges into 2 rows)."""
    elem = 2 if bf16 else 4
    g = SimpleNamespace(indices=torch.tensor([0, 2, 2, 3, 0], dtype=torch.int32),
                        n_node=5, n_edge=5)
    nbytes = 3 * 8 * elem + 5 * 8 * 4 + 5 * (4 + elem) + 6 * 4
    assert spmm_bound(g, 8, bf16) == pytest.approx((nbytes / 3.35e12 * 1e3, "bytes"))
    dup = SimpleNamespace(indices=torch.zeros(10_000, dtype=torch.int32), n_node=2,
                          n_edge=10_000)
    assert spmm_bound(dup, 128, bf16) == pytest.approx(
        (2 * 10_000 * 128 / 67e12 * 1e3, "operations"))


def jax_split_lines(n_node, n_edge, eval_pos, num_neg_eval, seed):
    """``bench_linkpred.py:58-98`` and ``:199-204`` as written there, on the
    JAX package's host functions."""
    rng = np.random.default_rng(seed)
    e = jax_powerlaw(n_node, n_edge, seed)
    m = e.shape[1]
    perm = rng.permutation(m)
    val = e[:, perm[:eval_pos]]
    test = e[:, perm[eval_pos: 2 * eval_pos]]
    train = e[:, perm[2 * eval_pos:]]
    keys = jax_sampling.edge_keys(e, n_node)
    negs = np.asarray(jax_sampling.rejection_sample_non_edges(
        np.random.default_rng(seed + 1), keys, n_node,
        2 * eval_pos * num_neg_eval))
    split_edge = {
        "train": {"edge": train.T},
        "valid": {"edge": val.T, "edge_neg": negs[: eval_pos * num_neg_eval]},
        "test": {"edge": test.T, "edge_neg": negs[eval_pos * num_neg_eval:]},
    }
    msg_edges = jax_symmetrize(train, n_node)
    pos_eval = val.T[:eval_pos].astype(np.int64)
    neg_dst = rng.integers(0, n_node, (eval_pos, lpt.OGB_NEG))
    neg_edges = np.stack([np.repeat(pos_eval[:, 0], lpt.OGB_NEG), neg_dst.reshape(-1)],
                         axis=1)
    return split_edge, msg_edges, train, pos_eval, neg_edges


@pytest.mark.parametrize("seed", [0, 1])
def test_linkpred_split_and_ogb_pairs_match_bench_linkpred(seed):
    """``build_split`` and ``ogb_eval_pairs`` at 3,000 nodes, 12,000 edges
    and 64 eval positives against ``bench_linkpred.py``'s lines, bit for
    bit."""
    n, m, n_pos, n_neg = 3000, 12000, 64, lpt.NUM_NEG_EVAL
    split_j, msg_j, train_j, pos_j, neg_j = jax_split_lines(n, m, n_pos, n_neg, seed)
    rng = np.random.default_rng(seed)
    e = fast_powerlaw_graph(n, m, seed)
    split_t, msg_t, train_t, val_t = lpt.build_split(e, n, rng, seed, n_pos, n_neg)
    pos_t, neg_t = lpt.ogb_eval_pairs(val_t, rng, n, n_pos)
    for part, arrays in split_j.items():
        for k, v in arrays.items():
            np.testing.assert_array_equal(split_t[part][k], v, err_msg=f"{part}/{k}")
    np.testing.assert_array_equal(msg_t, msg_j)
    np.testing.assert_array_equal(train_t, train_j)
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(neg_t, neg_j)
    assert neg_t.shape == (n_pos * lpt.OGB_NEG, 2)


def test_grouped_mrr_matches_bench_linkpred():
    """The OGB eval's grouped MRR (``linkpred/metrics.py:mrr``) of fixed
    scores, ties included, against the JAX package's."""
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 50, 64).astype(np.float32)
    neg = rng.integers(0, 50, (64, lpt.OGB_NEG)).astype(np.float32)
    got = port_metrics.mrr(torch.from_numpy(pos), torch.from_numpy(neg))
    want = jax_metrics.mrr(jnp.asarray(pos), jnp.asarray(neg))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("entry", ["bench_torch.main", "bench_torch.run_dist",
                                   "bench_linkpred_torch.main"])
def test_twins_raise_without_a_card(entry):
    """Torch finds no CUDA device here: each entry point raises at once and
    measures nothing on the CPU."""
    assert not torch.cuda.is_available()
    module, fn = entry.split(".")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr({"bench_torch": bt, "bench_linkpred_torch": lpt}[module], fn)()


_TWINS_NO_JAX = BLOCK_JAX + r"""
import dataclasses
import bench_torch as bt
import bench_linkpred_torch as lpt
import chip_smoke, profile_step, profile_spmm
kw = dict(n_node=9000, n_feat=16, n_hidden=32, n_class=5, n_edge=40000)
cfg, pd = bt.build_workload(**kw)
step, _ = bt.make_framework_step(cfg, pd, "cpu")
step()
naive, _ = bt.make_naive_step(cfg, pd, "cpu")
naive()
cfg, data = bt.build_raw_workload(**kw)
bt.dist_numerics(cfg, data, "cpu", steps=1)
import numpy as np
from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
split, msg, train, val = lpt.build_split(fast_powerlaw_graph(3000, 12000, 0), 3000,
                                         np.random.default_rng(0), 0, 64, 5)
lpt.bench_config()
print("TWINS_NO_JAX_OK")
"""


def test_twins_import_no_jax():
    """Both twins, ``chip_smoke.py`` and the profilers import, build their
    workloads and step on the CPU with every JAX and JAX-package import
    blocked."""
    proc = subprocess.run([sys.executable, "-c", _TWINS_NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and "TWINS_NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]
