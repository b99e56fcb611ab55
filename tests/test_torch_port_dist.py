"""The port's row-sharded teacher (``parallel/``) against the JAX package's
sharded run.

JAX runs on 4 of the 8 fake CPU devices (``tests/conftest.py``), its Pallas
kernels in interpret mode, as ``tests/test_distgraph.py`` runs it; the port
runs 4 gloo ranks on the CPU, spawned once for all the checks that need them
(``ranks``; their programs in ``test_torch_port_dist_ranks.py``), with the
same numpy inputs: n = 90 (padded to 96) and 96, 24
features, 5 classes, hidden 16, ``rb = 8``. Tolerances, with max |a - b| over
max |b| as "relative":
- ring SpMM, forward and dx: 1e-5 relative to JAX and to the dense product,
  f32; under ``pallas_bf16`` both sides round x and w to bf16 (RTNE) and sum
  the exact products in f32, so the same 1e-5 holds against JAX and against
  the dense product of the rounded operands;
- one sharded step (NLL + SE regulariser + edgewise loss on fixed pairs):
  loss and every gradient rtol 1e-4, atol 1e-5 (a conv bias in front of a
  batch norm has a gradient that is zero up to rounding);
- three epochs of ``train_teacher`` from the same initial parameters: the
  records at rtol 1e-4, atol 1e-3;
- ``masked_dist_graph``, ``dist_take_rows``, the edgewise loss: 1e-5 / 1e-6.
Dropout is 0: the random streams differ between the packages.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.data.synthetic import synthetic_features_labels
from gnn_tail_generalization_tpu.models.teacher import TeacherGNN as JTeacher
from gnn_tail_generalization_tpu.ops import sddmm as jsddmm
from gnn_tail_generalization_tpu.ops.spmm import spmm as jspmm
from gnn_tail_generalization_tpu.parallel import distgraph as jdg
from gnn_tail_generalization_tpu.train import edgewise as jew
from gnn_tail_generalization_tpu.train import loops as jloops

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.graph.core import edge_rows
from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
from gnn_tail_generalization_tpu_torch.parallel import distgraph as tdg
from gnn_tail_generalization_tpu_torch.parallel import launch
from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
from gnn_tail_generalization_tpu_torch.parallel.multihost import host_major_order
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax

from test_torch_port_dist_ranks import (GRAPHS, RB, S, SEED, SPMM_CASES, fixed_pairs,
                                       padded, port_cfg, random_graph, rank_program)

EB = 32
F_IN, C, H = 24, 5, 16
REL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-5)
RECORDS = dict(rtol=1e-4, atol=1e-3)


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def mesh():
    return jax.make_mesh((S,), ("graph",), devices=jax.devices()[:S])


def fake_comm(shard):
    """A rank's communicator without a process group: enough to build and
    inspect its buckets in this process."""
    return Comm(shard, S, "cpu", "gloo")


# ---------------------------------------------------------------------------
# the cases, and what the port's ranks compute for them
# ---------------------------------------------------------------------------

def teacher_setup(n, trick, se="100", **extra):
    """``tests/test_distgraph.py:_teacher_setup``'s config and data, for both
    packages."""
    rng = np.random.default_rng(0)
    kw = dict(dataset="Cora", train_which="SEMLP", whetherHasSE=se, se_reg=0.5)
    over = dict(N_nodes=n, num_feats=F_IN, num_classes=C, dim_hidden=H, dropout=0.0,
                type_trick=trick, use_special_split=True, epochs=4, **extra)
    cj = jcfg.apply_arch_configs(dataclasses.replace(jcfg.build_config(**kw), **over))
    ct = tcfg.apply_arch_configs(dataclasses.replace(tcfg.build_config(**kw), **over))
    x, y = synthetic_features_labels(n, F_IN, C, 0)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    train = np.zeros(n, bool)
    train[: n // 2] = True
    arrays = dict(x=x, y=y, edge_index=np.stack([src, dst]), train_mask=train,
                  val_mask=None, test_mask=~train, name="dist-test")
    return cj, ct, arrays


# name -> (n, trick, SE flags, config changes): the records held to JAX
TRAIN_CASES = {
    "Residual-n90": (90, "Residual", "100", {}),
    "Residual-n90-no-view": (90, "Residual", "100", dict(optimize_final_layer_agg=False)),
    "NodeNorm-n90": (90, "NodeNorm", "100", {}),
    "BatchNorm-n96": (96, "BatchNorm", "111", {}),
    "BatchNorm-n90": (90, "BatchNorm", "111", {}),
}
# one sharded step: NLL, SE regulariser on every conv, cross-shard batch
# norm over padded rows, and the edgewise loss on fixed pairs
STEP_CASE = (90, "BatchNorm", "111", dict(has_loss_component_edgewise=True,
                                           samp_size_p=12, samp_size_n_train=16))


def jax_init(cj, arrays):
    """The JAX sharded run's prepared data and initial variables (SE
    padding rows zeroed)."""
    pd = jds.prepare_sharded(jds.NodeData(**arrays), cj, mesh(), rb=RB, eb=EB)
    v = jloops.train_teacher(cj, pd, seed=SEED, epochs=0).variables
    return pd, v


@pytest.fixture(scope="module")
def jax_inits():
    """Per training case (and the step case): the JAX configs, the sharded
    prepared data and the initial variables."""
    out = {}
    for name, (n, trick, se, extra) in {**TRAIN_CASES, "step": STEP_CASE}.items():
        cj, ct, arrays = teacher_setup(n, trick, se, **extra)
        pd, v = jax_init(cj, arrays)
        init = {"params": flat(v["params"]),
                "stats": flat(v["batch_stats"]) if "batch_stats" in v else None}
        out[name] = (cj, ct, arrays, pd, v, init)
    return out


@pytest.fixture(scope="module")
def ranks(jax_inits):
    """The port's 4 gloo ranks, spawned once: rank r's ``rank_program``."""
    spec = {"step": jax_inits["step"][1:3] + (jax_inits["step"][5],),
            "train": {name: jax_inits[name][1:3] + (jax_inits[name][5],)
                      for name in TRAIN_CASES}}
    return launch.spawn(rank_program, S, "gloo", "cpu", spec, timeout=600)


def gather(ranks, pick):
    """The ranks' row shards of one result, concatenated in shard order."""
    return np.concatenate([pick(r) for r in ranks])


# ---------------------------------------------------------------------------
# the layout (no process group needed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_buckets_match_jax_bucket_by_bucket(name):
    """n_node_pad, rows_per_shard, degrees and every bucket's edges, local
    ids, weights and canonical ids equal JAX ``build_dist_graph``'s; the
    transposed set is JAX's bucket (j, k) of A with the roles swapped, in
    CSR order."""
    seed, n, e, bd = GRAPHS[name]
    ei, w, _ = random_graph(seed, n, e, bd)
    jg = jdg.build_dist_graph(ei, n, mesh(), edge_weight=w, rb=RB, eb=EB,
                              with_plans=False, with_edge_view=True)
    arrays = {k: np.asarray(getattr(jg, k)) for k in (
        "bkt_senders", "bkt_receivers", "bkt_weight", "bkt_gid",
        "bkt_senders_t", "bkt_receivers_t", "bkt_weight_t", "bkt_gid_t",
        "deg_in", "deg_out")}
    empty = 0
    for k in range(S):
        tg = tdg.build_dist_graph(ei, n, fake_comm(k), w, rb=RB, with_edge_view=True)
        assert (tg.n_node_pad, tg.rows_per_shard) == (jg.n_node_pad, jg.rows_per_shard)
        rows = slice(k * tg.rows_per_shard, (k + 1) * tg.rows_per_shard)
        np.testing.assert_array_equal(tg.deg_in.numpy(), arrays["deg_in"][rows])
        np.testing.assert_array_equal(tg.deg_out.numpy(), arrays["deg_out"][rows])
        for j in range(S):
            for sfx, bucket in (("", tg.buckets[j]), ("_t", tg.buckets_t[j])):
                gid = arrays["bkt_gid" + sfx][k, j]
                real = gid >= 0
                recv = arrays["bkt_receivers" + sfx][k, j][real]
                order = np.argsort(recv, kind="stable")  # the CSR's row order
                got_rows = edge_rows(bucket.indptr, bucket.n_edge).numpy()
                np.testing.assert_array_equal(got_rows, recv[order])
                np.testing.assert_array_equal(
                    bucket.indices.numpy(), arrays["bkt_senders" + sfx][k, j][real][order])
                np.testing.assert_array_equal(
                    bucket.weight.numpy(), arrays["bkt_weight" + sfx][k, j][real][order])
                np.testing.assert_array_equal(bucket.gid.numpy(), gid[real][order])
                assert bucket.schedule.n_edge == bucket.n_edge
                empty += bucket.n_edge == 0
    assert (empty > 0) == bd  # the block-diagonal graph has empty buckets


def test_a_bucket_refuses_its_neighbours_schedule():
    """Every bucket has its own schedule: passing a neighbour's raises
    (it would leave this bucket's hub rows unwritten on the card)."""
    ei, w, _ = random_graph(0, 96, 500)
    g = tdg.build_dist_graph(ei, 96, fake_comm(1), w, rb=RB)
    a, b = g.buckets[0], g.buckets[1]
    assert a.n_edge != b.n_edge
    x = torch.zeros(g.rows_per_shard, 4)
    with pytest.raises(ValueError, match="schedule built for a CSR"):
        K.spmm_csr_f32(a.indptr, a.indices, a.weight, x, schedule=b.schedule)
    K.spmm_csr_f32(a.indptr, a.indices, a.weight, x, schedule=a.schedule)


def test_transpose_swaps_buckets_and_degrees():
    ei, w, _ = random_graph(1, 90, 400)
    g = tdg.build_dist_graph(ei, 90, fake_comm(2), w, rb=RB, with_edge_view=True)
    t = g.transpose()
    assert t.buckets is g.buckets_t and t.buckets_t is g.buckets
    assert t.deg_in is g.deg_out and t.edge_view is None
    assert t.transpose().buckets is g.buckets
    with pytest.raises(ValueError, match="edge view"):
        tdg.global_edge_view(t)


def test_comm_volume_stats_equal_jax():
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import symmetrize

    e = symmetrize(fast_powerlaw_graph(2048, 10_000, 3), 2048)
    for s in (2, 4, 8):
        assert tdg.comm_volume_stats(e, 2048, s, rb=8) == jdg.comm_volume_stats(
            e, 2048, s, rb=8)
    st = tdg.comm_volume_stats(e, 2048, 4, d_feat=256, rb=8)
    for links in (0, 1):  # JAX's v5e defaults, passed as the port requires
        got = tdg.project_scaling_efficiency(41.0, 4, st, 45.0, 3.125, links, d_feat=256)
        want = jdg.project_scaling_efficiency(41.0, 4, st, d_feat=256, dcn_links=links)
        for k in ("t_step_projected_ms", "t_ring_per_spmm_ms", "hop_ms", "efficiency"):
            assert got[k] == want[k], k


def test_host_major_order_keeps_ring_neighbours_on_one_host():
    assert host_major_order(["a", "a", "b", "b"]) == [0, 1, 2, 3]
    assert host_major_order(["a", "b", "a", "b"]) == [0, 2, 1, 3]
    c = Comm(2, 4, "cpu", "gloo", order=host_major_order(["a", "b", "a", "b"]))
    assert c.shard == 1
    with pytest.raises(ValueError, match="permutation"):
        Comm(0, 2, "cpu", "gloo", order=[0, 0])


def test_sharded_entry_points_default_to_the_card(monkeypatch):
    """prepare_sharded's data trains on the card unless told otherwise,
    and the launcher, the CLI and train_teacher raise here, where torch
    finds none; NCCL takes a card a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    _, ct, arrays = teacher_setup(90, "Residual")
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct, fake_comm(0), rb=RB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloops.train_teacher(ct, pd, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(rank_program, 2, "nccl", "cuda", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--dataset=TEXAS", "--epochs=1", "--n_devices=2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        launch.rank_device(1, "nccl", "cuda")
    assert launch.rank_device(1, "gloo", "cuda") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo"):
        launch.rank_device(0, "nccl", "cpu")


def test_prepare_sharded_pads_and_keeps_each_ranks_rows():
    cj, ct, arrays = teacher_setup(90, "Residual")
    jp = jds.prepare_sharded(jds.NodeData(**arrays), cj, mesh(), rb=RB, eb=EB)
    parts = [tds.prepare_sharded(tds.NodeData(**arrays), ct, fake_comm(k), rb=RB)
             for k in range(S)]
    for f in ("x", "y", "train_mask", "test_mask"):
        np.testing.assert_array_equal(np.concatenate([getattr(p, f) for p in parts]),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in ("large_deg_mask", "small_deg_mask", "zero_deg_mask"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p.splits, f) for p in parts]),
            np.asarray(getattr(jp.splits, f)), err_msg=f)
    for f in ("edge_index", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(parts[3], f), getattr(jp, f))
    assert parts[0].graph.edge_view is None
    over = dataclasses.replace(ct, apply_graph_dropout=True)
    assert tds.prepare_sharded(tds.NodeData(**arrays), over, fake_comm(0),
                               rb=RB).graph.has_edge_view


# ---------------------------------------------------------------------------
# the ranks against JAX's sharded functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SPMM_CASES, ids=["-".join(map(str, c)) for c in SPMM_CASES])
def test_dist_spmm_matches_jax_and_dense(ranks, case):
    name, d, method = case
    seed, n, e, bd = GRAPHS[name]
    ei, w, dense = random_graph(seed, n, e, bd)
    x, ct = padded(10 + d, n, d), padded(20 + d, n, d)
    y = gather(ranks, lambda r: r["spmm"][case][0])
    dx = gather(ranks, lambda r: r["spmm"][case][1])
    jg = jdg.build_dist_graph(ei, n, mesh(), edge_weight=w, rb=RB, eb=EB)
    y_j, dx_j = jax.jit(lambda g, x, ct: (lambda y, f: (y, f(ct)[0]))(
        *jax.vjp(lambda x: jspmm(g, x, method), x)))(jg, jnp.asarray(x), jnp.asarray(ct))
    assert rel_err(y, np.asarray(y_j)) <= REL and rel_err(dx, np.asarray(dx_j)) <= REL
    a, xr, ctr = dense, x[:n], ct[:n]
    if method == "pallas_bf16":
        bf = lambda t: np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        a, xr, ctr = np.zeros_like(dense), bf(xr), bf(ctr)
        np.add.at(a, (ei[1], ei[0]), bf(w))
    assert rel_err(y[:n], a @ xr) <= REL and rel_err(dx[:n], a.T @ ctr) <= REL
    assert not y[n:].any()  # padded rows aggregate nothing
    skipped = [r["spmm"][case][2] for r in ranks]
    # the block-diagonal graph's ring meets S - 1 empty buckets a rank each way
    assert skipped == [2 * (S - 1) if bd else 0] * S


def test_masked_dist_graph_matches_jax(ranks):
    ei, w, _ = random_graph(0, 96, 500)
    mask = (np.random.default_rng(7).random(ei.shape[1]) < 0.6).astype(np.float32)
    # the segment-sum ring (no plans): the kernel route is held above
    jg = jdg.build_dist_graph(ei, 96, mesh(), edge_weight=w, rb=RB, eb=EB,
                              with_plans=False, with_edge_view=True)
    jm = jax.jit(jdg.masked_dist_graph)(jg, jnp.asarray(mask))
    x = jnp.asarray(padded(8, 96, 32))
    ring = jax.jit(jdg.dist_spmm)
    for i, want in enumerate((ring(jm, x), ring(jm.transpose(), x))):
        assert rel_err(gather(ranks, lambda r: r["masked"][i]), np.asarray(want)) <= REL
    np.testing.assert_array_equal(gather(ranks, lambda r: r["masked"][2]),
                                  np.asarray(jm.deg_in))
    np.testing.assert_array_equal(gather(ranks, lambda r: r["masked"][3]),
                                  np.asarray(jm.deg_out))


def test_dist_take_rows_and_its_gradient(ranks):
    h = padded(3, 90, 8)
    idx = np.array([0, 5, 17, 89, 33, 33, 60, 24])
    ct = np.random.default_rng(4).normal(size=(8, 8)).astype(np.float32)
    want_grad = np.zeros_like(h)
    np.add.at(want_grad, idx, ct)
    jg = jdg.build_dist_graph(np.stack([np.arange(90)] * 2), 90, mesh(),
                              with_plans=False, rb=RB)
    hj = jax.device_put(h, jax.sharding.NamedSharding(
        jg.mesh, jax.sharding.PartitionSpec("graph", None)))
    want = np.asarray(jax.jit(lambda h, i: jdg.dist_take_rows(jg, h, i))(
        hj, jnp.asarray(idx, jnp.int32)))
    for r in ranks:  # every rank holds the whole [K, d]
        np.testing.assert_allclose(r["take_rows"][0], want, rtol=1e-6)
        np.testing.assert_array_equal(r["take_rows"][0], h[idx])
    np.testing.assert_allclose(gather(ranks, lambda r: r["take_rows"][1]),
                               want_grad, rtol=1e-6, atol=1e-6)


def test_sharded_edgewise_loss_matches_jax_with_fixed_pairs(ranks):
    h = padded(6, 90, 16)
    pj = [jnp.asarray(p) for p in fixed_pairs(90)]
    jg = jdg.build_dist_graph(np.stack([np.arange(90)] * 2), 90, mesh(),
                              with_plans=False, rb=RB)

    def loss_fn(h):
        rows = jdg.dist_take_rows(jg, h, jnp.concatenate(pj))
        p, m = pj[0].shape[0], pj[2].shape[0]
        return jew.linkp_loss_eva(jsddmm.edge_dot(rows[:p], rows[p: 2 * p]),
                                  jsddmm.edge_dot(rows[2 * p: 2 * p + m], rows[2 * p + m:]))

    (loss_j, mrr_j), grad_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jnp.asarray(h))
    for r in ranks:
        np.testing.assert_allclose(r["edgewise"][0], float(loss_j), rtol=1e-6)
        np.testing.assert_allclose(r["edgewise"][1], float(mrr_j), rtol=1e-6)
    np.testing.assert_allclose(gather(ranks, lambda r: r["edgewise"][2]),
                               np.asarray(grad_j), rtol=1e-5, atol=1e-6)


def test_one_sharded_step_matches_jax(jax_inits, ranks):
    """Rules (a)-(c): the NLL over the global train count, the replicated
    gradients summed over the ranks, the whole terms (SE regulariser,
    edgewise loss) divided by S. Every replicated gradient against JAX's,
    on each rank, and the SE gradients concatenated over the ranks."""
    cj, ct, arrays, pd, v, _ = jax_inits["step"]
    model = JTeacher(dataclasses.replace(cj, N_nodes=pd.graph.n_node_pad))
    pj = [jnp.asarray(p) for p in fixed_pairs(90)]
    x, y, mask = pd.x, pd.y, pd.train_mask

    def loss_fn(p):
        (common, classi, se_reg, _), _ = model.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, pd.graph, x, train=True,
            mutable=["batch_stats"])
        rows = jdg.dist_take_rows(pd.graph, common, jnp.concatenate(pj))
        k, m = pj[0].shape[0], pj[2].shape[0]
        l_struct, _ = jew.linkp_loss_eva(
            jsddmm.edge_dot(rows[:k], rows[k: 2 * k]),
            jsddmm.edge_dot(rows[2 * k: 2 * k + m], rows[2 * k + m:]))
        return (jloops._nll_masked(classi, y, mask) * cj.TeacherGNN.lossa_semantic
                + cj.se_reg * se_reg + l_struct * cj.TeacherGNN.lossa_structure)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    got0 = ranks[0]["step"][1]
    want = {k: t for k, t in params_from_jax(
        flat(grads_j), port_cfg(ct, pd.graph.n_node_pad), flat(v["batch_stats"])).items()
        if k in got0}  # the gradients, not the running statistics
    assert sorted(want) == sorted(got0)
    assert any(k.endswith(".se") for k in want)
    for r in ranks:
        np.testing.assert_allclose(r["step"][0], float(loss_j), **TOL)
    for k, w in want.items():
        if tdg.is_row_sharded(k):
            got = gather(ranks, lambda r: r["step"][1][k])
            np.testing.assert_allclose(got, w.numpy(), **TOL, err_msg=k)
            continue
        for r in ranks:
            np.testing.assert_allclose(r["step"][1][k], w.numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_teacher_sharded_matches_jax(jax_inits, ranks, name):
    """Three epochs on prepare_sharded from the JAX run's initial
    parameters: the records of every rank against JAX's sharded run
    (BatchNorm at n = 90 holds the padded rows in its statistics), and the
    replicated parameters bit-equal across the ranks."""
    cj, ct, arrays, pd, _, _ = jax_inits[name]
    res_j = jloops.train_teacher(cj, pd, seed=SEED, epochs=3)
    view_j = jloops.final_agg_view(cj, pd, is_dist=True) is not None
    for r in ranks:
        got = r["train"][name]
        assert got["columns"] == res_j.columns and got["view"] == view_j
        np.testing.assert_allclose(got["records"], res_j.records, **RECORDS)
    assert view_j == (name == "Residual-n90")
    states = [r["train"][name]["state"] for r in ranks]
    for k in states[0]:
        if not tdg.is_row_sharded(k):
            assert all(np.array_equal(s[k], states[0][k]) for s in states[1:]), k


def test_ranks_counted_their_collectives(ranks):
    """Every rank ran the same collectives (a rank that ran fewer would have
    hung the others); which buckets are empty differs between the ranks."""
    counts = [{k: r["counts"][k] for k in ("ring_shifts", "all_reduces")} for r in ranks]
    assert all(c == counts[0] for c in counts[1:])
    assert counts[0]["ring_shifts"] > 0 and counts[0]["all_reduces"] > 0


def test_cli_sharded_prints_the_one_device_columns(capfd):
    argv = ["--dataset=TEXAS", "--epochs=2", "--device=cpu", "--log_every=1",
            "--force_set_to_best_config=0", "--type_trick=BatchNorm"]
    one = tmain.main(argv)
    out_one = capfd.readouterr().out
    two = tmain.main(argv + ["--n_devices=2"])
    out_two = capfd.readouterr().out
    assert two[0].columns == one[0].columns and two[0].records.shape == (2, 6)
    assert np.isfinite(two[0].records).all()

    def labels(out):
        return [re.split("[=:]", ln)[0] for ln in out.splitlines()
                if ln.startswith(("Ep", "seed", "  ", "==="))]

    assert labels(out_two) == labels(out_one)
    assert out_two.count("Ep001") == 1  # rank 0 prints, the others do not


def _two_d_mesh_students():
    """A student on the 2-D graph x model mesh (here (1, 2) as rank 0 sees
    it, no collective before the refusal)."""
    from gnn_tail_generalization_tpu_torch.parallel.mesh import GRAPH_MODEL, DeviceMesh

    _, ct, arrays = teacher_setup(90, "Residual")
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct,
                             DeviceMesh.layout((1, 2), GRAPH_MODEL, 0), rb=RB,
                             model_axis="model")
    tloops.run_experiment(ct, pd, epochs=1, device="cpu")


CLI = ["--dataset=TEXAS", "--epochs=1", "--device=cpu"]
# what sharding still refuses: link prediction on the CLI (the JAX CLI does
# not shard it either; train_linkpred(comm=...) does); on the two-level
# layout graph dropout (it needs the DistGraph edge view, as JAX asserts),
# any train_which but the teacher (as the JAX CLI) and a --hier_mesh that is
# not HxC; the students on the 2-D mesh (JAX asserts a 1-D mesh)
REFUSED = {
    "linkpred": (lambda: tmain.main(CLI + ["--n_devices=2", "--exp_mode=I2_GTL",
                                           "--task=linkp"]),
                 ValueError, r"train_linkpred\(comm=\.\.\.\)"),
    "hier_mesh": (lambda: tmain.main(CLI + ["--hier_mesh=2x2", "--apply_graph_dropout=1",
                                            "--force_set_to_best_config=0",
                                            "--type_trick=DropEdge"]),
                  ValueError, "edge view"),
    "hier_mesh_semlp": (lambda: tmain.main(CLI + ["--hier_mesh=2x2",
                                                  "--train_which=SEMLP"]),
                        ValueError, "trains the TeacherGNN"),
    "hier_mesh_malformed": (lambda: tmain.main(CLI + ["--hier_mesh=2"]),
                            ValueError, "HxC"),
    "2d_mesh": (_two_d_mesh_students, ValueError, "train the TeacherGNN"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_cli_sharded_raises_for_the_a12b_paths(name):
    call, error, match = REFUSED[name]
    with pytest.raises(error, match=match):
        call()


def test_save_dir_under_sharding_raises(tmp_path):
    """save_dir on a rank writes the sharded checkpoint directory (here one
    rank, no collective), which reads back into the one-device layout and
    raises when read into a template it does not fit."""
    from gnn_tail_generalization_tpu_torch.train import checkpoint as tckpt

    _, ct, arrays = teacher_setup(90, "BatchNorm", "111")
    comm = Comm(0, 1, "cpu", "gloo")
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct, comm, rb=RB)
    res = tloops.train_teacher(ct, pd, epochs=1, device="cpu", save_dir=str(tmp_path))
    path = str(tmp_path / "teacherGNN.pt")
    assert os.path.isdir(tckpt.sharded_dir(path)) and not os.path.exists(path)
    state = tckpt.load_train_state(path)["params"]
    for k, v in res.state_dict.items():
        want = v[:90] if tdg.is_row_sharded(k) else v
        assert torch.equal(state[k], want), k
    template = {"params": {k: torch.zeros(1) for k in state}, "epoch": 0}
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.load_train_state(path, template)
