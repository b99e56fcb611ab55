"""The port's two-axis layouts against the JAX package's runs at the same
layout: the two-level (host x card) SpMM and teacher (``parallel/hier.py``,
``prepare_hier``, ``--hier_mesh``) and the 2-D graph x model mesh
(``prepare_sharded(..., model_axis=...)``).

JAX runs on its 8 fake CPU devices (``tests/conftest.py``), its Pallas
kernels in interpret mode, as ``tests/test_hier.py`` and
``tests/test_distgraph.py`` run them; the port runs 4 gloo ranks on the CPU,
spawned once (``ranks``; their programs in ``test_torch_port_hier_ranks.py``),
which lay out every mesh over the same 4 ranks: hier (2, 2), (1, 4) and
(4, 1), and (graph 2, model 2). Inputs come from numpy seeds: a 96-node
random graph of 600 weighted edges (``tests/test_hier.py:_random_graph``),
``rb = 8``; the teachers at n = 90 (padded to 96), 24 features, hidden 16,
dropout 0. Tolerances, with max |a - b| over max |b| as "relative":
- ``hier_spmm`` and its dx, and the 2-D ``dist_spmm``: 1e-4 against JAX and
  the dense product (f32); under ``pallas_bf16`` both packages round x and
  w to bf16 and sum in f32, so 1e-4 against JAX too;
- the hier SpMM against the port's flat ring at S = 4: 1e-5;
- the teachers, 3 epochs from the JAX run's initial parameters: the records
  at 1e-4 (hier, ``tests/test_hier.py:111``) and rtol 1e-4 / atol 1e-3
  (2-D, ``tests/test_distgraph.py:401-421``); one 2-D step with the
  edgewise loss on fixed pairs: loss and gradients rtol 1e-4, atol 1e-5.
"""
import dataclasses
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
from gnn_tail_generalization_tpu.parallel import hier as jhier
from gnn_tail_generalization_tpu.train import edgewise as jew
from gnn_tail_generalization_tpu.train import loops as jloops

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.graph.core import edge_rows
from gnn_tail_generalization_tpu_torch.parallel import distgraph as tdg
from gnn_tail_generalization_tpu_torch.parallel import hier as thier
from gnn_tail_generalization_tpu_torch.parallel import launch
from gnn_tail_generalization_tpu_torch.parallel.mesh import (GRAPH_MODEL, HOST_CHIP,
                                                             DeviceMesh, parse_hier_mesh)
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax

from test_torch_port_hier_ranks import (CONV_CT, CONV_W, CYCLE_N, HIER_LAYOUTS,
                                        HIER_SPMM_CASES, MESH_2D, N, RB, SEED,
                                        SPMM_2D_CASES, WORLD, cycle_edges, features,
                                        fixed_pairs, port_cfg, random_graph,
                                        rank_program)

EB = 32
F_IN, H = 24, 16
REL = 1e-4
TOL = dict(rtol=1e-4, atol=1e-5)


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def jmesh(shape, names):
    return jax.make_mesh(shape, names, devices=jax.devices()[: int(np.prod(shape))])


def hier_positions(h, c):
    """Rank order of the mesh (row-major) as (h, k) coordinates."""
    return [(p // c, p % c) for p in range(h * c)]


def teacher_setup(n, trick, se, n_class, **extra):
    """``tests/test_hier.py``'s teacher (and ``test_distgraph.py``'s) for both
    packages, at n nodes and ``n_class`` classes, dropout 0."""
    rng = np.random.default_rng(0)
    kw = dict(dataset="Cora", train_which="TeacherGNN", whetherHasSE=se, se_reg=0.5)
    over = dict(N_nodes=n, num_feats=F_IN, num_classes=n_class, dim_hidden=H,
                dropout=0.0, type_trick=trick, use_special_split=True, epochs=4, **extra)
    cj = jcfg.apply_arch_configs(dataclasses.replace(jcfg.build_config(**kw), **over))
    ct = tcfg.apply_arch_configs(dataclasses.replace(tcfg.build_config(**kw), **over))
    x, y = synthetic_features_labels(n, F_IN, n_class, 0)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    train = np.zeros(n, bool)
    train[: n // 2] = True
    arrays = dict(x=x, y=y, edge_index=np.stack([src, dst]), train_mask=train,
                  val_mask=None, test_mask=~train, name="hier-test")
    return cj, ct, arrays


# name -> (trick, SE flags, classes, config changes, JAX reference run): the
# 2-D records held to JAX. Residual: the input Dense and the convs
# column-parallel, out_mlp (5 classes) whole, no SE table (flag [1] is 0),
# held to JAX's 2-D run. BatchNorm: every conv and SE table column-parallel,
# the last conv at 4 classes; JAX's 2-D run raises on an SE table
# (``test_jax_2d_mesh_raises_on_an_se_table``), so it is held to JAX's 1-D
# run over the graph axis (S = 2, the same padding), the function the 2-D
# mesh partitions
TRAIN_2D = {"Residual-n90": ("Residual", "100", 5, {}, "2d"),
            "BatchNorm-n90": ("BatchNorm", "111", 4, {}, "1d")}
STEP_2D = ("BatchNorm", "111", 4, dict(has_loss_component_edgewise=True,
                                       samp_size_p=12, samp_size_n_train=16), "1d")
# Residual with SE flag [1]: an SE table on every conv
TRAIN_HIER = ("Residual", "111", 4, {})


def _init(pd, cj):
    v = jloops.train_teacher(cj, pd, seed=SEED, epochs=0).variables
    return v, {"params": flat(v["params"]),
               "stats": flat(v["batch_stats"]) if "batch_stats" in v else None}


@pytest.fixture(scope="module")
def jax_runs():
    """Per teacher case: the JAX configs, prepared data (2-D or hier) and
    initial variables."""
    out = {}
    for name, (trick, se, nc, extra, ref) in {**TRAIN_2D, "step": STEP_2D}.items():
        cj, ct, arrays = teacher_setup(90, trick, se, nc, **extra)
        if ref == "2d":
            pd = jds.prepare_sharded(jds.NodeData(**arrays), cj, jmesh(MESH_2D, GRAPH_MODEL),
                                     model_axis="model", rb=RB, eb=EB)
        else:
            pd = jds.prepare_sharded(jds.NodeData(**arrays), cj,
                                     jmesh(MESH_2D[:1], ("graph",)), rb=RB, eb=EB)
        out[name] = (cj, ct, arrays, pd) + _init(pd, cj)
    trick, se, nc, extra = TRAIN_HIER
    cj, ct, arrays = teacher_setup(90, trick, se, nc, **extra)
    pd = jds.prepare_hier(jds.NodeData(**arrays), cj, jmesh((2, 2), HOST_CHIP),
                          rb=RB, eb=EB)
    out["hier"] = (cj, ct, arrays, pd) + _init(pd, cj)
    return out


@pytest.fixture(scope="module")
def save_dir_2d(tmp_path_factory):
    """Where the BatchNorm 2-D run saves its checkpoint."""
    return str(tmp_path_factory.mktemp("teacher-2d"))


@pytest.fixture(scope="module")
def ranks(jax_runs, save_dir_2d):
    """The port's 4 gloo ranks, spawned once: rank r's ``rank_program``."""
    def args(name):
        cj, ct, arrays, pd, v, init = jax_runs[name]
        return ct, arrays, init

    spec = {"step_2d": args("step"),
            "train_2d": {n: args(n) + ((save_dir_2d,) if n == "BatchNorm-n90" else ())
                         for n in TRAIN_2D},
            "train_hier": args("hier")}
    return launch.spawn(rank_program, WORLD, "gloo", "cpu", spec, timeout=600)


def by_2d_coords(ranks):
    """The ranks keyed by their (graph, model) coordinates."""
    return {(r["coords"]["2d"]["graph"], r["coords"]["2d"]["model"]): r for r in ranks}


# ---------------------------------------------------------------------------
# the layout (no process group needed)
# ---------------------------------------------------------------------------

def _plan_edges(s, d, w, blk, eb, rb):
    """(row, source, weight) of a JAX plan's slots of nonzero weight."""
    rows = np.asarray(blk)[np.arange(len(d)) // eb] * rb + np.asarray(d)
    keep = np.asarray(w) != 0
    return sorted(zip(rows[keep].tolist(), np.asarray(s)[: len(d)][keep].tolist(),
                      np.asarray(w)[keep].tolist()))


def _bucket_edges(b):
    rows = edge_rows(b.indptr, b.n_edge).numpy()
    return sorted(zip(rows.tolist(), b.indices.numpy().tolist(), b.weight.numpy().tolist()))


@pytest.mark.parametrize("hc", HIER_LAYOUTS + ((2, 4),), ids=lambda hc: "x".join(map(str, hc)))
def test_build_hier_graph_matches_jax_rank_by_rank(hc):
    """Every rank's intra and cross buckets hold the edges of the JAX plan
    arrays' nonzero-weight slots, forward and transposed; the live entries of
    ``halo_idx``, ``u_max``, ``dcn_rows`` and ``n_node_pad`` are JAX's;
    ``dcn_rows_t`` is the transposed graph's JAX count."""
    h_n, c_n = hc
    ei, w, _ = random_graph(h_n * 10 + c_n)
    jg = jhier.build_hier_graph(ei, N, jmesh(hc, HOST_CHIP), edge_weight=w, rb=RB, eb=EB)
    jt = jhier.build_hier_graph(ei[::-1], N, jmesh(hc, HOST_CHIP), edge_weight=w,
                                rb=RB, eb=EB)
    ja = {k: np.asarray(v) if hasattr(v, "shape") else v
          for k, v in vars(jg).items() if v is not None}
    for p, (h, k) in enumerate(hier_positions(*hc)):
        g = thier.build_hier_graph(ei, N, DeviceMesh.layout(hc, HOST_CHIP, p), w, rb=RB)
        assert (g.n_node_pad, g.rows_per_shard) == (jg.n_node_pad, jg.rows)
        assert (g.u_max, g.bwd.u_max, g.dcn_rows) == (jg.u_max, jg.u_max_t, jg.dcn_rows)
        assert g.dcn_rows_t == jt.dcn_rows
        for sfx, d in (("", g.fwd), ("_t", g.bwd)):
            for j in range(c_n):
                want = _plan_edges(ja["ib_s" + sfx][h, k, j], ja["ib_d" + sfx][h, k, j],
                                   ja["ib_w" + sfx][h, k, j], ja["ib_blk" + sfx][h, k, j],
                                   EB, RB)
                assert _bucket_edges(d.intra[j]) == want, (p, sfx, "intra", j)
            for t in range(1, h_n):
                want = _plan_edges(ja["cp_s" + sfx][h, t - 1, k], ja["cp_d" + sfx][h, t - 1, k],
                                   ja["cp_w" + sfx][h, t - 1, k],
                                   ja["cp_blk" + sfx][h, t - 1, k], EB, RB)
                assert _bucket_edges(d.cross[t - 1]) == want, (p, sfx, "cross", t)
                got = d.halo_idx[t - 1].numpy()
                live = int((got >= 0).sum())
                assert (got[live:] == -1).all()
                np.testing.assert_array_equal(got[:live],
                                              ja["halo_idx" + sfx][h, t - 1][:live])
        assert (g.transpose().dcn_rows, g.transpose().u_max) == (jt.dcn_rows, jg.u_max_t)


@pytest.mark.parametrize("d_feat", [128, 256])
def test_hier_comm_stats_match_jax(d_feat):
    """The same keys and values as JAX on the forward graph; on the
    transposed one the port counts the transposed halo (``dcn_rows_t``),
    where JAX's ``transpose()`` keeps the forward count."""
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import symmetrize

    n = 4096
    e = symmetrize(fast_powerlaw_graph(n, 16_000, 5), n)
    e = e[:, e[0] % 3 != 0]  # an asymmetric graph: the two directions' halos differ
    jm = jmesh((2, 4), HOST_CHIP)
    jg = jhier.build_hier_graph(e, n, jm, rb=4, eb=EB)
    g = thier.build_hier_graph(e, n, DeviceMesh.layout((2, 4), HOST_CHIP, 5), rb=4)
    assert thier.hier_comm_stats(g, d_feat) == jhier.hier_comm_stats(jg, d_feat)
    got_t = thier.hier_comm_stats(g.transpose(), d_feat)
    want_t = jhier.hier_comm_stats(jg.transpose(), d_feat)
    jt = jhier.build_hier_graph(e[::-1], n, jm, rb=4, eb=EB)
    assert jt.dcn_rows != jg.dcn_rows
    assert got_t["dcn_rows_halo_unpadded"] == jt.dcn_rows == g.dcn_rows_t
    assert want_t["dcn_rows_halo_unpadded"] == jg.dcn_rows  # the known difference
    for k in want_t:
        if k != "dcn_rows_halo_unpadded":
            assert got_t[k] == want_t[k], k
    assert got_t["flat_over_hier_dcn"] > 1.5


def test_layouts_answer_what_the_loops_ask():
    """Each sharded layout says itself whether it keeps an edge view, gets
    the loss-masked view and trains students (``train/loops.py`` asks
    these, not the graph's type): the 1-D ring all of it, the 2-D mesh no
    student, the two-level layout the teacher alone (as JAX)."""
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm

    ei, w, _ = random_graph(3)
    axis = Comm(0, 2, "cpu", "gloo")
    one_d = tdg.build_dist_graph(ei, N, axis, w, rb=RB, with_edge_view=True)
    two_d = tdg.build_dist_graph(ei, N, axis, w, rb=RB, model_comm=Comm(1, 2, "cpu", "gloo"))
    hier = thier.build_hier_graph(ei, N, DeviceMesh.layout((2, 2), HOST_CHIP, 0), w, rb=RB)
    got = {name: (g.has_edge_view, g.has_loss_view, g.teacher_only)
           for name, g in (("1-D", one_d), ("1-D transposed", one_d.transpose()),
                           ("2-D", two_d), ("hier", hier))}
    assert got == {"1-D": (True, True, False), "1-D transposed": (False, True, False),
                   "2-D": (False, True, True), "hier": (False, False, True)}
    with pytest.raises(ValueError, match="no edge view"):
        tdg.global_edge_view(hier)


def test_prepare_hier_pads_and_keeps_each_ranks_rows():
    cj, ct, arrays = teacher_setup(90, "Residual", "100", 4)
    jp = jds.prepare_hier(jds.NodeData(**arrays), cj, jmesh((2, 2), HOST_CHIP), rb=RB, eb=EB)
    parts = [tds.prepare_hier(tds.NodeData(**arrays), ct,
                              DeviceMesh.layout((2, 2), HOST_CHIP, p), rb=RB)
             for p in range(4)]
    assert parts[0].graph.n_node_pad == jp.graph.n_node_pad == 96
    for f in ("x", "y", "train_mask", "test_mask"):
        np.testing.assert_array_equal(np.concatenate([getattr(p, f) for p in parts]),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in ("large_deg_mask", "small_deg_mask", "zero_deg_mask"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p.splits, f) for p in parts]),
            np.asarray(getattr(jp.splits, f)), err_msg=f)
    over = dataclasses.replace(ct, apply_graph_dropout=True)
    with pytest.raises(ValueError, match="edge view"):
        tds.prepare_hier(tds.NodeData(**arrays), over, DeviceMesh.layout((2, 2), HOST_CHIP, 0))


def test_mesh_coordinates_are_row_major():
    """``jax.make_mesh``'s device order: position p is (p // C, p % C)."""
    for hc in HIER_LAYOUTS + ((2, 4),):
        for p, hk in enumerate(hier_positions(*hc)):
            m = DeviceMesh.layout(hc, HOST_CHIP, p)
            assert (m.coords["host"], m.coords["chip"]) == hk
            assert (m.comm("host").shard, m.comm("chip").shard) == hk
    assert parse_hier_mesh("2X4") == (2, 4)
    for bad in ("2", "2x", "0x2", "axb", "2x2x2"):
        with pytest.raises(ValueError):
            parse_hier_mesh(bad)


def test_initialize_multihost_lays_the_mesh_a_host_a_row(tmp_path, monkeypatch):
    """Under torchrun the (host, chip) mesh's chip axis lies within a host:
    a host holding another number of ranks than C raises."""
    import torch.distributed as dist

    from gnn_tail_generalization_tpu_torch.parallel.multihost import initialize_multihost

    init = f"file://{tmp_path}/rendezvous"
    try:
        mesh = initialize_multihost("gloo", "cpu", rank=0, world_size=1, init_method=init,
                                    mesh=((1, 1), HOST_CHIP))
        assert isinstance(mesh, DeviceMesh) and mesh.coords == {"host": 0, "chip": 0}
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="each host needs 1 ranks"):
            initialize_multihost("gloo", "cpu", rank=0, world_size=1, init_method=init,
                                 mesh=((1, 1), HOST_CHIP))
    finally:
        dist.destroy_process_group()


def test_params_from_jax_cuts_columns_on_the_2d_mesh(jax_runs):
    """A 2-D rank's state: its graph shard's SE rows, its model shard's
    columns of the convs' kernels and SE tables and the column-parallel
    Dense kernels; concatenated over the mesh it is the whole state."""
    cj, ct, arrays, pd, v, init = jax_runs["BatchNorm-n90"]
    npad = pd.graph.n_node_pad
    rows = npad // 2
    whole = params_from_jax(init["params"], port_cfg(ct, npad), init["stats"])
    parts = {(gs, ms): params_from_jax(init["params"], port_cfg(ct, npad), init["stats"],
                                       shard=gs, n_shards=2, model_shard=ms, n_model=2)
             for gs in range(2) for ms in range(2)}
    sliced = set()
    for k, t in whole.items():
        for gs in range(2):
            want = t[gs * rows: (gs + 1) * rows] if tdg.is_row_sharded(k) else t
            a, b = parts[(gs, 0)][k], parts[(gs, 1)][k]
            dims = [d for d in range(want.dim()) if a.shape[d] != want.shape[d]]
            assert len(dims) <= 1, k
            if dims:
                sliced.add(k)
                assert torch.equal(torch.cat([a, b], dim=dims[0]), want), k
            else:
                assert torch.equal(a, want) and torch.equal(b, want), k
    assert sliced == {f"backbone.convs.{i}.{p}" for i in range(2) for p in ("weight", "se")}


# ---------------------------------------------------------------------------
# the ranks against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", HIER_SPMM_CASES,
                         ids=[f"{h}x{c}-{m}" for (h, c), m in HIER_SPMM_CASES])
def test_hier_spmm_matches_jax_and_dense(ranks, case):
    """y and dx (through ``ops/spmm.py:spmm``) concatenated over the ranks
    in shard order, against JAX ``hier_spmm`` (``test_hier.py:40``) and the
    dense product (of bf16-rounded operands under ``pallas_bf16``)."""
    (h, c), method = case
    ei, w, dense = random_graph(h * 10 + c)
    x, ct = features(1, 32), features(2, 32)
    jg = jhier.build_hier_graph(ei, N, jmesh((h, c), HOST_CHIP), edge_weight=w, rb=RB, eb=EB)
    y_j, dx_j = jax.jit(lambda g, x, ct: (lambda y, f: (y, f(ct)[0]))(
        *jax.vjp(lambda x: jspmm(g, x, method), x)))(jg, jnp.asarray(x), jnp.asarray(ct))
    y = np.concatenate([r["hier_spmm"][case][0] for r in ranks])
    dx = np.concatenate([r["hier_spmm"][case][1] for r in ranks])
    assert rel_err(y, np.asarray(y_j)) <= REL and rel_err(dx, np.asarray(dx_j)) <= REL
    if method == "pallas_bf16":
        bf = lambda t: np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        dense, x, ct = np.zeros_like(dense), bf(x), bf(ct)
        np.add.at(dense, (ei[1], ei[0]), bf(w))
    assert rel_err(y, dense @ x) <= REL and rel_err(dx, dense.T @ ct) <= REL


def test_hier_matches_the_flat_ring(ranks):
    """``test_hier.py:60``: the host-major cut is the flat ring's at S = 4."""
    hier_y = np.concatenate([r["flat_vs_hier"][0] for r in ranks])
    flat_y = np.concatenate([r["flat_vs_hier"][1] for r in ranks])
    assert rel_err(hier_y, flat_y) <= 1e-5


@pytest.mark.parametrize("case", SPMM_2D_CASES, ids=[f"d{d}-{m}" for d, m in SPMM_2D_CASES])
def test_dist_spmm_2d_matches_jax_and_dense(ranks, case):
    """The 2-D ring (this model shard's columns, or the whole width where 2
    does not divide it) against JAX's 2-D ``dist_spmm`` and the dense
    product; both model ranks of a graph shard hold the same rows."""
    d, method = case
    ei, w, dense = random_graph(11)
    x, ct = features(4 + d, d), features(5 + d, d)
    jg = jdg.build_dist_graph(ei, N, jmesh(MESH_2D, GRAPH_MODEL), edge_weight=w,
                              model_axis="model", rb=RB, eb=EB)
    y_j, dx_j = jax.jit(lambda g, x, ct: (lambda y, f: (y, f(ct)[0]))(
        *jax.vjp(lambda x: jspmm(g, x, method), x)))(jg, jnp.asarray(x), jnp.asarray(ct))
    rk = by_2d_coords(ranks)
    for m in range(2):
        y = np.concatenate([rk[(gs, m)]["spmm_2d"][case][0] for gs in range(2)])
        dx = np.concatenate([rk[(gs, m)]["spmm_2d"][case][1] for gs in range(2)])
        assert rel_err(y, np.asarray(y_j)) <= REL and rel_err(dx, np.asarray(dx_j)) <= REL
        if method == "auto":
            assert rel_err(y, dense @ x) <= REL and rel_err(dx, dense.T @ ct) <= REL
    for gs in range(2):
        a, b = (rk[(gs, m)]["spmm_2d"][case] for m in range(2))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_dist_take_rows_2d_and_its_gradient(ranks):
    h = features(3, 8, 96)
    idx = np.array([0, 5, 17, 89, 33, 33, 60, 24])
    ct = features(4, 8, 8)
    jg = jdg.build_dist_graph(np.stack([np.arange(90)] * 2), 90, jmesh(MESH_2D, GRAPH_MODEL),
                              model_axis="model", with_plans=False, rb=RB)
    want = np.asarray(jax.jit(lambda h, i: jdg.dist_take_rows(jg, h, i))(
        jnp.asarray(h), jnp.asarray(idx, jnp.int32)))
    want_grad = np.zeros_like(h)
    np.add.at(want_grad, idx, ct)
    rk = by_2d_coords(ranks)
    for r in ranks:
        np.testing.assert_allclose(r["take_rows_2d"][0], want, rtol=1e-6)
    for m in range(2):  # every model rank gets the whole gradient
        got = np.concatenate([rk[(gs, m)]["take_rows_2d"][1] for gs in range(2)])
        np.testing.assert_allclose(got, want_grad, rtol=1e-6, atol=1e-6)


def test_2d_conv_rounds_its_bf16_input_gradient_once(ranks):
    """Under ``pallas_bf16`` the conv's dense step takes bf16 operands, and
    the gradient of its input is rounded to bf16 once, after the model
    shards' parts are summed: every rank's gradient equals the JAX conv's on
    one device bit for bit (``CONV_W``: f32 sums exact, the rounding
    decides)."""
    from gnn_tail_generalization_tpu.graph.core import build_graph
    from gnn_tail_generalization_tpu.nn.gcn import GCNConv as JGCN

    g = build_graph(cycle_edges(), CYCLE_N, with_dense=False, with_plans=True,
                    plan_rb=RB, plan_eb=EB)
    conv = JGCN(4, CYCLE_N, spmm_method="pallas_bf16")

    def loss(x):
        y, _ = conv.apply({"params": {"kernel": jnp.asarray(CONV_W),
                                      "bias": jnp.zeros(4)}}, g, x)
        return (y * jnp.asarray(CONV_CT)).sum()

    want = np.asarray(jax.grad(loss)(jnp.ones((CYCLE_N, 2))))
    assert np.unique(want).tolist() == [2.0]
    for (gs, _), r in by_2d_coords(ranks).items():
        rows = r["conv_bf16_2d"].shape[0]
        assert np.array_equal(r["conv_bf16_2d"], want[gs * rows: (gs + 1) * rows]), gs


def test_one_2d_step_with_the_edgewise_loss_matches_jax(jax_runs, ranks):
    """NLL + SE regulariser + the edgewise loss on fixed pairs on the 2-D
    mesh (``test_distgraph.py:560-582``'s loss) with SE tables on every
    conv: the loss on every rank and each rank's gradients against JAX's
    run over the graph axis (``STEP_2D``), cut as that rank holds them."""
    cj, ct, arrays, pd, v, _ = jax_runs["step"]
    model = JTeacher(dataclasses.replace(cj, N_nodes=pd.graph.n_node_pad))
    pj = [jnp.asarray(p) for p in fixed_pairs(90)]

    def loss_fn(p):
        (common, classi, se_reg, _), _ = model.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, pd.graph, pd.x, train=True,
            mutable=["batch_stats"])
        rows = jdg.dist_take_rows(pd.graph, common, jnp.concatenate(pj))
        k, m = pj[0].shape[0], pj[2].shape[0]
        l_struct, _ = jew.linkp_loss_eva(
            jsddmm.edge_dot(rows[:k], rows[k: 2 * k]),
            jsddmm.edge_dot(rows[2 * k: 2 * k + m], rows[2 * k + m:]))
        return (jloops._nll_masked(classi, pd.y, pd.train_mask) * cj.TeacherGNN.lossa_semantic
                + cj.se_reg * se_reg + l_struct * cj.TeacherGNN.lossa_structure)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    cfg = port_cfg(ct, pd.graph.n_node_pad)
    for r in ranks:
        gs, ms = r["coords"]["2d"]["graph"], r["coords"]["2d"]["model"]
        np.testing.assert_allclose(r["step_2d"][0], float(loss_j), **TOL)
        want = params_from_jax(flat(grads_j), cfg, flat(v["batch_stats"]), shard=gs,
                               n_shards=2, model_shard=ms, n_model=2)
        got = r["step_2d"][1]
        assert set(got) <= set(want) and any(k.endswith(".se") for k in got)
        for k, g in got.items():
            np.testing.assert_allclose(g, want[k].numpy(), **TOL, err_msg=k)


def test_jax_2d_mesh_raises_on_an_se_table():
    """Kept as it is in the JAX package: on the (graph, model) mesh an SE
    table sharded over both axes meets ``jnp.linalg.norm(le.reshape(-1))``
    (``nn/gcn.py:66``), which this JAX's explicit mesh axes refuse. The
    port's 2-D run holds SE slices (``test_train_teacher_2d_matches_jax``)."""
    trick, se, nc, extra, _ = TRAIN_2D["BatchNorm-n90"]
    cj, _, arrays = teacher_setup(90, trick, se, nc, **extra)
    pd = jds.prepare_sharded(jds.NodeData(**arrays), cj, jmesh(MESH_2D, GRAPH_MODEL),
                             model_axis="model", rb=RB, eb=EB)
    with pytest.raises(Exception, match="reshape is not supported"):
        jloops.train_teacher(cj, pd, seed=SEED, epochs=1)


@pytest.mark.parametrize("name", list(TRAIN_2D))
def test_train_teacher_2d_matches_jax(jax_runs, ranks, name):
    """Three epochs on the 2-D mesh from the JAX run's initial parameters:
    every rank's records against JAX's run (``TRAIN_2D``); the replicated
    parameters bit-equal over all 4 ranks, each column slice over the graph
    shards."""
    cj, ct, arrays, pd, _, _ = jax_runs[name]
    res_j = jloops.train_teacher(cj, pd, seed=SEED, epochs=3)
    view_j = jloops.final_agg_view(cj, pd, is_dist=True) is not None
    for r in ranks:
        got = r["train_2d"][name]
        assert got["columns"] == res_j.columns and got["view"] == view_j
        np.testing.assert_allclose(got["records"], res_j.records, rtol=1e-4, atol=1e-3)
    rk = by_2d_coords(ranks)
    states = {c: rk[c]["train_2d"][name]["state"] for c in rk}
    whole = params_from_jax(jax_runs[name][5]["params"], port_cfg(ct, pd.graph.n_node_pad),
                            jax_runs[name][5]["stats"])
    n_sliced = 0
    for k, t in states[(0, 0)].items():
        if tdg.is_row_sharded(k):
            continue
        for m in range(2):  # a column slice, or a whole tensor, over the graph shards
            assert np.array_equal(states[(0, m)][k], states[(1, m)][k]), k
        if t.shape == tuple(whole[k].shape):
            assert all(np.array_equal(st[k], t) for st in states.values()), k
        else:
            n_sliced += 1
    assert n_sliced >= 2


def test_2d_save_dir_writes_the_graph_axis_layout(ranks, save_dir_2d):
    """A 2-D run's ``save_dir`` holds whole columns in the graph axis's
    sharded layout: read back for a graph shard and cut for a model shard,
    it is each rank's final state."""
    from gnn_tail_generalization_tpu_torch.train.checkpoint import load_train_state

    path = f"{save_dir_2d}/teacherGNN.pt"
    for (gs, ms), r in by_2d_coords(ranks).items():
        want = r["train_2d"]["BatchNorm-n90"]["state"]
        whole = load_train_state(path, shard=gs, n_shards=2, n_node_pad=96)["params"]
        got = tdg.slice_model_cols(whole, {k: v.shape for k, v in want.items()}, ms)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), v), (gs, ms, k)
    assert load_train_state(path)["params"]["backbone.convs.0.se"].shape == (90, H)


def test_train_teacher_hier_matches_jax(jax_runs, ranks):
    """``test_hier.py:111`` at (2, 2): three epochs on ``prepare_hier`` from
    the JAX run's initial parameters, records within 1e-4 on every rank, no
    loss-masked view (as JAX), replicated parameters bit-equal."""
    cj, ct, arrays, pd, _, _ = jax_runs["hier"]
    res_j = jloops.train_teacher(cj, pd, seed=SEED, epochs=3)
    for r in ranks:
        got = r["train_hier"]
        assert got["columns"] == res_j.columns and not got["view"]
        np.testing.assert_allclose(got["records"], res_j.records, rtol=1e-4, atol=1e-4)
    states = [r["train_hier"]["state"] for r in ranks]
    for k in states[0]:
        if not tdg.is_row_sharded(k):
            assert all(np.array_equal(s[k], states[0][k]) for s in states[1:]), k


def test_ranks_counted_their_collectives(ranks):
    """Within each axis of each mesh every rank ran the same collectives
    (one that ran fewer would have hung the others)."""
    for key in ("world",):
        assert all(r["counts"][key] == ranks[0]["counts"][key] for r in ranks)
    for hc in HIER_LAYOUTS:
        for axis in HOST_CHIP:
            got = [{k: v for k, v in r["counts"]["hier"][hc][axis].items()
                    if k != "skipped_buckets"} for r in ranks]
            assert all(g == got[0] for g in got), (hc, axis, got)
    c22 = ranks[0]["counts"]["hier"][(2, 2)]
    assert c22["chip"]["ring_shifts"] > 0 and c22["host"]["ring_shifts"] > 0
    assert c22["chip"]["all_gathers"] > 0
    m2d = [r["counts"]["2d"]["model"] for r in ranks]
    assert all(m == m2d[0] for m in m2d) and m2d[0]["all_gathers"] > 0


def test_cli_hier_mesh_prints_the_one_device_columns(capfd):
    argv = ["--dataset=TEXAS", "--epochs=2", "--device=cpu", "--log_every=1"]
    one = tmain.main(argv)
    out_one = capfd.readouterr().out
    two = tmain.main(argv + ["--hier_mesh=2x2", "--dist_transport=gloo"])
    out_two = capfd.readouterr().out
    assert two[0].columns == one[0].columns and np.isfinite(two[0].records).all()

    def labels(out):
        return [re.split("[=:]", ln)[0] for ln in out.splitlines()
                if ln.startswith(("Ep", "seed", "  ", "==="))]

    assert labels(out_two) == labels(out_one)
    assert out_two.count("Ep001") == 1  # rank 0 prints, the others do not
