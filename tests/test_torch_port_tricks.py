"""The port's trick zoo against the JAX package's: the norm layers (train
mode, and eval mode after one train step, running statistics included),
DenseConnection, the teacher with each norm / Dense / Jumping trick
(forward, loss, gradients, batch statistics), three epochs of train_teacher
under BatchNorm, graph dropout (masked graphs, SpMM on them, a teacher step
with fixed masks, the samplers' statistics), and the plan-less SpMM rule.

Tolerances: rtol 1e-4, atol 1e-5 where a path runs an SpMM or a matmul
(the sums are taken in another order), 1e-5 / 1e-6 for the elementwise norm
math, exact where both sides only copy or count. Graphs are built with
``spmm_dense_threshold`` below N, so the JAX side runs its Pallas kernels in
interpret mode and the port the CSR kernels' plain versions. Dropout is 0:
random streams differ between the frameworks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.graph import core as jcore
from gnn_tail_generalization_tpu.models.teacher import TeacherGNN as JTeacher
from gnn_tail_generalization_tpu.nn import graph_dropout as jgd
from gnn_tail_generalization_tpu.nn import norms as jnorms
from gnn_tail_generalization_tpu.nn import residual as jres
from gnn_tail_generalization_tpu.train import loops as jloops

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.nn import graph_dropout as tgd
from gnn_tail_generalization_tpu_torch.nn import norms as tnorms
from gnn_tail_generalization_tpu_torch.nn.residual import DenseConnection
from gnn_tail_generalization_tpu_torch.ops import _build
from gnn_tail_generalization_tpu_torch.ops import spmm as tspmm
from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
from gnn_tail_generalization_tpu_torch.propagation import correlation as tcorr
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.utils.convert import (
    params_from_jax, state_dict_from_flax)

N, F, C, H = 60, 12, 4, 8
TOL = dict(rtol=1e-4, atol=1e-5)
ELEMENTWISE = dict(rtol=1e-5, atol=1e-6)


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def randomized(rng, variables):
    """``variables`` with every leaf redrawn (variances kept positive), so
    scale, bias and running statistics all matter."""
    def draw(path, leaf):
        a = rng.normal(size=leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, variables)


# ---------------------------------------------------------------------------
# norm layers
# ---------------------------------------------------------------------------

NORM_CASES = [  # (kind, node_norm_type, num_groups)
    ("BatchNorm", "n", None), ("PairNorm", "n", None), ("MeanNorm", "n", None),
    ("GroupNorm", "n", 1), ("GroupNorm", "n", 3), ("CombNorm", "n", 3),
    ("CombNorm", "v", 1)] + [("NodeNorm", t, None)
                             for t in ("n", "v", "m", "srv", "pr")]


@pytest.mark.parametrize("kind,node_type,groups", NORM_CASES)
def test_norm_layer_matches_flax(rng, kind, node_type, groups):
    """Train mode, the running statistics it leaves, and eval mode after
    that one train step."""
    d = 8
    x = (rng.normal(size=(N, d)) * 2 + 0.5).astype(np.float32)
    jl = jnorms.NormLayer(kind=kind, dim=d, node_norm_type=node_type,
                          skip_weight=0.3, num_groups=groups)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = randomized(rng, variables)
    y_j, new = jl.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    after = {**variables, **new}
    y_eval_j = jl.apply(after, jnp.asarray(x), train=False)

    tl = tnorms.NormLayer(kind, d, node_type, 0.3, groups)
    tl.load_state_dict(state_dict_from_flax(flat(variables), tl))
    tl.train()
    y_t = tl(torch.from_numpy(x))
    tol = TOL if kind in ("GroupNorm", "CombNorm") else ELEMENTWISE
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **tol)
    want = state_dict_from_flax(flat(after), tl)
    for k, v in tl.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **tol, err_msg=k)
    tl.eval()
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(y_eval_j), **tol)
    if kind == "BatchNorm":
        # torch's own batch norm moves its running variance by the unbiased
        # variance, and its eval output then misses flax's
        before = state_dict_from_flax(flat(variables), tl)
        bn = torch.nn.BatchNorm1d(d, momentum=0.1, eps=1e-5)
        bn.load_state_dict({"weight": before["bn.weight"],
                            "bias": before["bn.bias"],
                            "running_mean": before["bn.running_mean"],
                            "running_var": before["bn.running_var"],
                            "num_batches_tracked": torch.tensor(0)})
        bn.train()(torch.from_numpy(x))
        y_torch = bn.eval()(torch.from_numpy(x)).detach().numpy()
        assert not np.allclose(y_torch, np.asarray(y_eval_j), **ELEMENTWISE)


def test_node_norm_rejects_unknown_type():
    with pytest.raises(ValueError):
        tnorms.node_norm(torch.ones(3, 4), "nope")


@pytest.mark.parametrize("dataset", ["Citeseer", "ogbn-arxiv", "Pubmed", "Cora",
                                     "CoauthorCS", "TEXAS", "CV-x"])
@pytest.mark.parametrize("model", ["GCN", "GAT", "SAGE"])
@pytest.mark.parametrize("layers", [2, 8, 64])
def test_groupnorm_presets_match(dataset, model, layers):
    assert (tnorms.groupnorm_presets(dataset, model, layers)
            == jnorms.groupnorm_presets(dataset, model, layers))


def test_groupnorm_presets_raise_for_unknown_dataset():
    with pytest.raises(NotImplementedError):
        tnorms.groupnorm_presets("nope", "GCN", 2)
    assert [tnorms.norm_kind_of(t) for t in ("NoResNodeNorm", "DenseNoNorm",
                                              "InitialBatchNorm", "CombNorm")] \
        == [jnorms.norm_kind_of(t) for t in ("NoResNodeNorm", "DenseNoNorm",
                                              "InitialBatchNorm", "CombNorm")]


@pytest.mark.parametrize("agg", ["concat", "maxpool", "attention"])
def test_dense_connection_matches_flax(rng, agg):
    xs = [rng.normal(size=(N, H)).astype(np.float32) for _ in range(3)]
    jl = jres.DenseConnection(out_dim=5, aggregation=agg)
    variables = jl.init(jax.random.PRNGKey(1), [jnp.asarray(a) for a in xs])
    variables = randomized(rng, variables)
    y_j = jl.apply(variables, [jnp.asarray(a) for a in xs])
    tl = DenseConnection(H, 5, 3, agg)
    tl.load_state_dict(state_dict_from_flax(flat(variables), tl))
    y_t = tl([torch.from_numpy(a) for a in xs])
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    with pytest.raises(ValueError):
        DenseConnection(H, 5, 3, "mean")


# ---------------------------------------------------------------------------
# the teacher with each trick
# ---------------------------------------------------------------------------


def setup(rng, type_trick, **extra):
    """Same host data and config through both packages' prepare."""
    src, dst = rng.integers(0, N, 240), rng.integers(0, N, 240)
    arrays = dict(
        x=rng.normal(size=(N, F)).astype(np.float32),
        y=rng.integers(0, C, N), edge_index=np.stack([src, dst]),
        train_mask=np.arange(N) < N // 2, val_mask=None,
        test_mask=np.arange(N) >= N // 2, name="port-parity")
    kw = dict(dataset="", train_which="TeacherGNN", N_nodes=N, num_feats=F,
              num_classes=C, dim_hidden=H, dropout=0.0, type_trick=type_trick,
              whetherHasSE="000", lr=0.01, weight_decay=5e-4, num_layers=3,
              force_set_to_best_config=False)
    kw.update(extra)
    cj, ct = jcfg.build_config(**kw), tcfg.build_config(**kw)
    jp = jds.prepare(jds.NodeData(**arrays), cj, spmm_dense_threshold=N // 2)
    tp = tds.prepare(tds.NodeData(**arrays), ct, spmm_dense_threshold=N // 2)
    assert jp.graph.plans is not None and tp.graph.has_plans
    return cj, ct, jp, tp


def step_both(cj, ct, jp, tp, rng, edge_masks=None):
    """One train-mode forward + backward on both sides from the same
    (randomized) variables, then an eval forward with the updated batch
    statistics. Returns what each side computed."""
    model = JTeacher(cj)
    x, y = jnp.asarray(jp.x), jnp.asarray(jp.y)
    mask = jnp.asarray(jp.train_mask)
    key = jax.random.PRNGKey(3)
    variables = jax.jit(lambda g: model.init(
        {"params": key, "dropout": key, "graph_dropout": key}, g, x,
        train=True))(jp.graph)
    variables = randomized(rng, variables)
    params, bs = variables["params"], variables.get("batch_stats")
    g_last_j = jloops.final_agg_view(cj, jp, is_dist=False)

    def loss_fn(p):
        vs = {"params": p} if bs is None else {"params": p, "batch_stats": bs}
        (_, classi, _, _), new = model.apply(
            vs, jp.graph, x, train=True, g_last=g_last_j,
            rngs={"graph_dropout": key}, mutable=["batch_stats"])
        return jloops._nll_masked(classi, y, mask), (classi, new)

    (loss_j, (logits_j, new_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    eval_vs = {"params": params, **new_j}
    eval_j = jax.jit(lambda v: model.apply(v, jp.graph, x, train=False)[1])(eval_vs)

    stats = flat(bs) if bs is not None else None
    tm = TeacherGNN(ct)
    tm.load_state_dict(params_from_jax(flat(params), ct, stats))
    xt, yt = torch.from_numpy(tp.x), torch.from_numpy(tp.y)
    g_last = tloops.final_agg_view(ct, tp)
    assert (g_last is None) == (g_last_j is None)
    tm.train()
    _, classi, _, _ = tm(tp.graph, xt, g_last=g_last,
                         graph_generator=torch.Generator().manual_seed(0))
    loss = tloops._nll_masked(classi, yt, torch.from_numpy(tp.train_mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    np.testing.assert_allclose(classi.detach().numpy(), np.asarray(logits_j), **TOL)
    want = params_from_jax(flat(grads_j), ct,
                           None if bs is None else flat(new_j["batch_stats"]))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() <= want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
    buffers = dict(tm.named_buffers())
    for k, v in buffers.items():  # the batch statistics the step left
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL, err_msg=k)
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(tp.graph, xt)[1].numpy(),
                                   np.asarray(eval_j), **TOL)
    return buffers


TEACHER_TRICKS = [
    ("BatchNorm", {}), ("GroupNorm", dict(skip_weight=0.3, num_groups=3)),
    ("PairNorm", {}), ("NodeNorm", {}), ("MeanNorm", {}),
    ("CombNorm", dict(skip_weight=0.3, num_groups=2, node_norm_type="v")),
    ("DenseNoNorm", dict(layer_agg="concat")),
    ("DenseNoNorm", dict(layer_agg="maxpool")),
    ("DenseNoNorm", dict(layer_agg="attention")),
    ("Jumping", {})]


@pytest.mark.parametrize("trick,extra", TEACHER_TRICKS,
                         ids=[t + "-" + "-".join(map(str, e.values()))
                              for t, e in TEACHER_TRICKS])
def test_teacher_step_matches_flax(rng, trick, extra):
    cj, ct, jp, tp = setup(rng, trick, **extra)
    buffers = step_both(cj, ct, jp, tp, rng)
    assert bool(buffers) == (trick in ("BatchNorm", "GroupNorm", "CombNorm"))


def test_train_teacher_batchnorm_matches_jax(rng):
    cj, ct, jp, tp = setup(rng, "BatchNorm", num_layers=2)
    init = jloops.train_teacher(cj, jp, seed=0, epochs=0)
    res_j = jloops.train_teacher(cj, jp, seed=0, epochs=3)
    state = params_from_jax(flat(init.variables["params"]), ct,
                            flat(init.variables["batch_stats"]))
    res_t = tloops.train_teacher(ct, tp, seed=0, epochs=3, init_state=state,
                                 device="cpu")
    assert res_t.columns == res_j.columns
    np.testing.assert_allclose(res_t.records[:, 0], res_j.records[:, 0],
                               rtol=1e-4)
    train, s = tp.train_mask, tp.splits
    counts = {"acc_train": train.sum(), "acc_test": tp.test_mask.sum(),
              "head": (s.large_deg_mask & ~train).sum(),
              "tail": (s.small_deg_mask & ~train).sum(),
              "iso": (s.zero_deg_mask & ~train).sum()}
    for i, col in enumerate(res_t.columns[1:], start=1):
        one_node = 100.0 / max(counts[col], 1) + 1e-6
        diff = np.abs(res_t.records[:, i] - res_j.records[:, i]).max()
        assert diff <= one_node, (col, res_t.records[:, i], res_j.records[:, i])
    # the final batch statistics travel in the state_dict. Only the
    # variances are compared: a conv bias in front of a batch norm has a
    # gradient that is zero up to rounding, Adam turns its sign into steps
    # of +-lr, and the running means follow those biases
    final = params_from_jax(flat(res_j.variables["params"]), ct,
                            flat(res_j.variables["batch_stats"]))
    for k in ("backbone.norms.0.bn.running_var", "backbone.norms.1.bn.running_var"):
        np.testing.assert_allclose(res_t.state_dict[k].numpy(),
                                   final[k].numpy(), **TOL)


# ---------------------------------------------------------------------------
# graph dropout
# ---------------------------------------------------------------------------


def _graph_pair(rng, n=50, e=300, weighted=True):
    ei = jcore.standard_pipeline(
        np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), n)
    w = rng.normal(size=ei.shape[1]).astype(np.float32) if weighted else None
    return (ei, w, jcore.build_graph(ei, n, w, with_dense=False),
            tcore.build_graph(ei, n, w, with_dense=False, with_plans=True))


def _pad(m, e_pad):
    return np.concatenate([m, np.zeros(e_pad - len(m), m.dtype)])


def test_masked_graph_matches_jax(rng):
    ei, w, jg, tg = _graph_pair(rng)
    m = (rng.random(tg.n_edge) < 0.6).astype(np.float32)
    jm = jgd.masked_graph(jg, jnp.asarray(_pad(m, jg.e_pad)), jg.t_from_fwd)
    tm = tgd.masked_graph(tg, torch.from_numpy(m))
    e = tg.n_edge
    np.testing.assert_array_equal(tg.t_from_fwd.numpy(), np.asarray(jg.t_from_fwd)[:e])
    np.testing.assert_array_equal(tm.weight.numpy(), np.asarray(jm.edge_weight)[:e])
    np.testing.assert_array_equal(tm.weight_t.numpy(), np.asarray(jm.edge_weight_t)[:e])
    np.testing.assert_array_equal(tm.deg_in.numpy(), np.asarray(jm.deg_in))
    np.testing.assert_array_equal(tm.deg_out.numpy(), np.asarray(jm.deg_out))
    assert tm.dense_adj is None and not tm.has_plans
    tt = tm.transpose()  # the transposed view masks the same edges
    np.testing.assert_array_equal(tt.weight[tt.t_from_fwd].numpy(), tt.weight_t.numpy())


@pytest.mark.parametrize("method", ["auto", "pallas", "pallas_bf16"])
def test_spmm_on_a_masked_graph_matches_the_dense_product(rng, method):
    ei, w, _, tg = _graph_pair(rng)
    keep = rng.random(tg.n_edge) < 0.5
    g = tgd.masked_graph(tg, torch.from_numpy(keep.astype(np.float32)))
    # the dense A of the surviving edges, in the forward CSR's order
    rows = tcore.edge_rows(tg.indptr, tg.n_edge).numpy()
    a = np.zeros((50, 50), np.float64)
    np.add.at(a, (rows, tg.indices.numpy()), tg.weight.numpy() * keep)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    ct = rng.normal(size=(50, 6)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tspmm.spmm(g, xt, method)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), a @ x, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), a.T @ ct, **TOL)


@pytest.mark.parametrize("trick,layerwise", [("DropEdge", True),
                                              ("FastGCN", False)])
def test_teacher_step_with_fixed_masks_matches_jax(rng, monkeypatch, trick,
                                                   layerwise):
    cj, ct, jp, tp = setup(rng, trick, apply_graph_dropout=True,
                           layerwise_dropout=layerwise, graph_dropout=0.3)
    e = tp.graph.n_edge
    masks = [(rng.random(e) < 0.7).astype(np.float32) for _ in range(3)]
    if not layerwise:
        masks = [masks[0]] * 3
    e_pad = jp.graph.e_pad
    monkeypatch.setattr(jgd, "per_layer_edge_masks", lambda *a, **k: [
        jnp.asarray(_pad(m, e_pad)) for m in masks])
    monkeypatch.setattr(tgd, "per_layer_edge_masks", lambda *a, **k: [
        torch.from_numpy(m) for m in masks])
    step_both(cj, ct, jp, tp, rng)


def _node_keep(g, mask):
    """Which nodes a node-sampling mask kept, read off the self loops every
    node of the standard pipeline has."""
    rows = tcore.edge_rows(g.indptr, g.n_edge)
    loops = (rows == g.indices.long()) & (mask > 0)
    keep = torch.zeros(g.n_node, dtype=torch.bool)
    keep[rows[loops]] = True
    return keep, rows


def test_drop_edge_keep_rate_is_within_4_sigma(rng):
    _, _, _, g = _graph_pair(rng, n=400, e=6000)
    p = 0.3
    m = tgd.drop_edge(torch.Generator().manual_seed(0), g, p)
    assert m.shape == (g.n_edge,) and set(m.unique().tolist()) <= {0.0, 1.0}
    sigma = (p * (1 - p) / g.n_edge) ** 0.5
    assert abs(m.mean().item() - (1 - p)) < 4 * sigma


def test_drop_node_keeps_only_edges_inside_the_kept_nodes(rng):
    _, _, _, g = _graph_pair(rng, n=300, e=3000)
    m = tgd.drop_node(torch.Generator().manual_seed(1), g, 0.4)
    keep, rows = _node_keep(g, m)
    torch.testing.assert_close(m, (keep[rows] & keep[g.indices.long()]).float())
    assert 0.4 < keep.float().mean().item() < 0.8


def test_fastgcn_keeps_k_nodes_and_no_zero_q_node(rng):
    n, p = 120, 0.25
    ei = jcore.standard_pipeline(
        np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)]), n)
    ei = ei[:, ei[1] >= 5]  # nodes 0..4 have no in-edges: q = 0
    g = tcore.build_graph(ei, n, with_dense=False)
    for seed in range(3):
        m = tgd.fastgcn(torch.Generator().manual_seed(seed), g, p)
        keep, rows = _node_keep(g, m)
        src = g.indices.long()
        assert not (m[src < 5] > 0).any()  # a zero-q node is never kept
        assert int(keep.sum()) == int(n * (1 - p))
        torch.testing.assert_close(m, (keep[rows] & keep[src]).float())


def test_ladies_is_layerwise_and_reversed(rng):
    _, _, _, g = _graph_pair(rng, n=200, e=1500)
    with pytest.raises(ValueError, match="layer-wise"):
        tgd.per_layer_edge_masks(torch.Generator(), g, "LADIES", 0.3, 3,
                                 layerwise=False, train=True)
    masks = tgd.per_layer_edge_masks(torch.Generator().manual_seed(2), g,
                                     "LADIES", 0.3, 3, layerwise=True,
                                     train=True)
    assert len(masks) == 3
    # the first draw samples from the full graph's q; it is the LAST mask
    gen = torch.Generator().manual_seed(2)
    rows = tcore.edge_rows(g.indptr, g.n_edge)
    q = torch.zeros(g.n_node).index_add_(0, rows, g.weight**2)
    keep = tgd._keep_topk_nodes(gen, q, int(g.n_node * 0.7))
    first = (keep[g.indices.long()] & keep[rows]).float()
    torch.testing.assert_close(masks[-1], first)
    assert not torch.equal(masks[0], masks[-1])


def test_eval_mode_keeps_the_full_graph(rng):
    _, _, _, g = _graph_pair(rng)
    assert tgd.per_layer_edge_masks(torch.Generator(), g, "DropEdge", 0.5, 2,
                                    layerwise=True, train=False) is None
    cj, ct, _, tp = setup(rng, "DropEdge", apply_graph_dropout=True)
    tm = TeacherGNN(ct, generator=torch.Generator().manual_seed(0)).eval()
    plain = TeacherGNN(dataclasses.replace(ct, apply_graph_dropout=False)).eval()
    plain.load_state_dict(tm.state_dict())
    x = torch.from_numpy(tp.x)
    with torch.no_grad():
        torch.testing.assert_close(tm(tp.graph, x)[1], plain(tp.graph, x)[1],
                                   rtol=0, atol=0)
        tm.train()  # train mode draws, and needs a generator
        with pytest.raises(ValueError, match="Generator"):
            tm(tp.graph, x)
        out = tm(tp.graph, x, graph_generator=torch.Generator().manual_seed(0))[1]
    assert not torch.allclose(out, plain(tp.graph, x)[1])


# ---------------------------------------------------------------------------
# plan-less graphs compute in f32 under pallas_bf16
# ---------------------------------------------------------------------------


def test_planless_graphs_compute_in_f32_under_pallas_bf16(rng):
    """The JAX package falls back to an f32 gather on a graph without Pallas
    plans; so does the port. Graphs with plans keep the bf16 kernel."""
    ei, w, _, tg = _graph_pair(rng)
    x = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    args = (tg.indptr, tg.indices, tg.weight, x)
    f32, bf16 = K.spmm_csr_f32(*args), K.spmm_csr_bf16(*args)
    assert not torch.allclose(f32, bf16, rtol=1e-5, atol=1e-6)
    planless = dataclasses.replace(tg, has_plans=False)  # built by hand
    _build.reset_launch_counts()
    torch.testing.assert_close(tspmm.spmm(planless, x, "pallas_bf16"), f32,
                               rtol=0, atol=0)
    torch.testing.assert_close(tspmm.spmm(tg, x, "pallas_bf16"), bf16,
                               rtol=0, atol=0)
    assert _build.LAUNCHES["spmm_csr_plain"] == 2
    # a masked graph of a graph with plans, and a propagation adjacency,
    # are plan-less; prepare's graph and its loss-masked view keep plans
    ones = torch.ones(tg.n_edge)
    assert not tgd.masked_graph(tg, ones).has_plans
    torch.testing.assert_close(
        tspmm.spmm(tgd.masked_graph(tg, ones), x, "pallas_bf16"), f32,
        rtol=0, atol=0)
    dad = tcorr.gen_normalized_adjs(ei, 50, dense_threshold=10)[0]
    assert not dad.has_plans and dad.dense_adj is None
    _, ct, _, tp = setup(rng, "InitialBatchNorm")
    assert tp.graph.has_plans and tloops.final_agg_view(ct, tp).has_plans
    assert tp.graph.transpose().has_plans
    small = tds.prepare(tds.NodeData(
        x=tp.x, y=tp.y, edge_index=tp.edge_index_bkup, train_mask=tp.train_mask,
        val_mask=None, test_mask=tp.test_mask), ct)
    assert not small.graph.has_plans and small.graph.dense_adj is not None
