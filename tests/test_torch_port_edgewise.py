"""The port's I2-GTL teacher loss against the JAX package's: SDDMM edge
scores (1e-6), ``spmm_edge_grad`` forward, dx and dw edge by edge on a
weighted multigraph (1e-5), ``spmm_normalized`` (1e-5), the edgewise plan
(exact), ``linkp_loss_eva`` with tied scores (1e-6), the negative sampler's
split constraints, one teacher step from transplanted weights with fixed
pairs (loss and every gradient, rtol 1e-4, atol 1e-5), and a 3-epoch run.
The random streams differ between the packages by design, so the sampler is
held to its constraints, and the loss to fixed pairs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.data import synthetic as jsyn
from gnn_tail_generalization_tpu.graph import core as jcore
from gnn_tail_generalization_tpu.models.teacher import TeacherGNN as JTeacher
from gnn_tail_generalization_tpu.ops import sddmm as jsddmm
from gnn_tail_generalization_tpu.ops import spmm as jspmm
from gnn_tail_generalization_tpu.train import edgewise as jew
from gnn_tail_generalization_tpu.train import loops as jloops

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.ops import sddmm as tsddmm
from gnn_tail_generalization_tpu_torch.ops import spmm as tspmm
from gnn_tail_generalization_tpu_torch.train import edgewise as tew
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def test_edge_dot_and_sddmm_match_jax(rng):
    h = rng.normal(size=(50, 24)).astype(np.float32)
    s, r = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    ht = torch.from_numpy(h)
    np.testing.assert_allclose(
        tsddmm.sddmm(ht, torch.from_numpy(s), torch.from_numpy(r)).numpy(),
        np.asarray(jsddmm.sddmm(jnp.asarray(h), jnp.asarray(s), jnp.asarray(r))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tsddmm.edge_dot(ht[s], ht[r]).numpy(),
        np.asarray(jsddmm.edge_dot(jnp.asarray(h[s]), jnp.asarray(h[r]))),
        rtol=1e-6, atol=1e-6)


def multigraph(rng, n=70, e=400):
    """Random weighted edges with 60 exact duplicates and self loops."""
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ei = np.stack([src, dst])
    ei = np.concatenate([ei, ei[:, :60], np.stack([np.arange(5)] * 2)], axis=1)
    return ei, rng.normal(size=ei.shape[1]).astype(np.float32)


@pytest.mark.parametrize("method", ["auto", "gather", "dense"])
def test_spmm_edge_grad_matches_jax_edge_by_edge(rng, method):
    n, d = 70, 12
    ei, w0 = multigraph(rng, n)
    jg = jcore.build_graph(ei, n, w0, with_dense=False)
    tg = tcore.build_graph(ei, n, w0, with_dense=method == "dense")
    e = tg.n_edge
    w = rng.normal(size=e).astype(np.float32)  # dst-sorted = forward-CSR order
    x = rng.normal(size=(n, d)).astype(np.float32)
    dy = rng.normal(size=(n, d)).astype(np.float32)

    wpad = jnp.zeros(jg.e_pad, jnp.float32).at[:e].set(w)
    y_j, vjp = jax.vjp(lambda x, w: jspmm.spmm_edge_grad(jg, x, w, "gather"),
                       jnp.asarray(x), wpad)
    dx_j, dw_j = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y_t = tspmm.spmm_edge_grad(tg, xt, wt, method)
    y_t.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j)[:e], **TOL)
    assert not np.asarray(dw_j)[e:].any()  # JAX's padding slots, which the port lacks


def test_with_edge_weight(rng):
    n = 40
    ei, w0 = multigraph(rng, n, 150)
    tg = tcore.build_graph(ei, n, w0, with_plans=True)
    w = torch.from_numpy(rng.normal(size=tg.n_edge).astype(np.float32))
    gw = tg.with_edge_weight(w)
    assert gw.dense_adj is None and not gw.has_plans
    assert gw.schedule is tg.schedule and gw.schedule_t is tg.schedule_t
    assert torch.equal(gw.weight_t, w[tg.t_from_fwd])
    gd = tg.with_edge_weight(w, rebuild_dense=True)
    jg = jcore.build_graph(ei, n, w0)
    wpad = jnp.zeros(jg.e_pad, jnp.float32).at[:tg.n_edge].set(w.numpy())
    np.testing.assert_allclose(
        gd.dense_adj.numpy(),
        np.asarray(jg.with_edge_weight(wpad, rebuild_dense=True).dense_adj),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="w must be"):
        tg.with_edge_weight(w[:-1])


@pytest.mark.parametrize("norm", ["both", "left", "right"])
def test_spmm_normalized_matches_jax(rng, norm):
    n, d = 60, 10
    ei, w0 = multigraph(rng, n, 300)
    jg = jcore.build_graph(ei, n, w0, with_dense=False)
    tg = tcore.build_graph(ei, n, w0, with_dense=False)
    x = rng.normal(size=(n, d)).astype(np.float32)
    dy = rng.normal(size=(n, d)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x: jspmm.spmm_normalized(jg, x, norm, "gather"),
                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y_t = tspmm.spmm_normalized(tg, xt, norm, "auto")
    y_t.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               **TOL)


def setup_split(n=200):
    """tests/test_edgewise.py's setup, through both packages' prepare."""
    kw = dict(dataset="Cora", train_which="TeacherGNN", exp_mode="I2_GTL")
    over = dict(N_nodes=n, num_feats=40, num_classes=4, samp_size_p=32,
                samp_size_n_train=32, samp_size_n_test_times_p=2)
    cj = dataclasses.replace(jcfg.build_config(**kw), **over)
    ct = dataclasses.replace(tcfg.build_config(**kw), **over)
    data = jsyn.synthetic_planetoid(n_node=n, n_feat=40, n_class=4, seed=3, name="s")
    data.train_mask = np.zeros(n, bool)
    data.train_mask[np.random.default_rng(0).permutation(n)[:n // 2]] = True
    data.test_mask = ~data.train_mask
    jp = jds.prepare(data, cj)
    tp = tds.prepare(tds.NodeData(**dataclasses.asdict(data)), ct)
    return cj, ct, jp, tp


def test_build_edgewise_plan_matches_jax():
    cj, ct, jp, tp = setup_split()
    pj, pt = jew.build_edgewise_plan(cj, jp), tew.build_edgewise_plan(ct, tp)
    for f in dataclasses.fields(jew.EdgewisePlan):
        a, b = getattr(pt, f.name), getattr(pj, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert pt.train_edges.shape[1] > 0 and pt.test_edges.shape[1] > 0


@pytest.mark.parametrize("p,n_neg", [(200, 4000), (30, 75), (7, 7)])
def test_linkp_loss_eva_matches_jax_with_ties(rng, p, n_neg):
    # one decimal: many exact ties between positives and negatives
    pos = np.round(rng.normal(size=p), 1).astype(np.float32)
    neg = np.round(rng.normal(size=n_neg), 1).astype(np.float32)
    neg[:p] = pos[:min(p, n_neg)]
    lt, mt = tew.linkp_loss_eva(torch.from_numpy(pos), torch.from_numpy(neg))
    lj, mj = jew.linkp_loss_eva(jnp.asarray(pos), jnp.asarray(neg))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(mt.item(), float(mj), rtol=1e-6)
    assert 0 < mt.item() <= 1


@pytest.mark.parametrize("mode", ["train", "test"])
def test_negative_sampler_respects_the_split(mode):
    """Train negatives: at least 95% valid (both endpoints in train, not an
    edge), as the JAX package's own test; test negatives: never both in
    train. The JAX sampler, on its own stream, meets the same bounds."""
    cj, ct, jp, tp = setup_split()
    plan = tew.build_edgewise_plan(ct, tp)
    ew = tew.edgewise_consts(plan, "cpu")
    count = 4000
    src, dst = tew._sample_split_negatives(
        torch.Generator().manual_seed(0), ew["keys_sorted"], ew["train_mask"],
        ew["train_idx"], ew["test_idx"], plan.n_node, count, mode)
    tm = plan.train_mask
    js, jd = jew._sample_split_negatives(
        jax.random.PRNGKey(0), jnp.asarray(plan.keys_sorted), jnp.asarray(tm),
        jnp.asarray(np.where(tm)[0]), jnp.asarray(np.where(~tm)[0]), plan.n_node,
        count, mode)
    edges = set(zip(*tp.edge_index.tolist()))
    for s, d in ((src.numpy(), dst.numpy()), (np.asarray(js), np.asarray(jd))):
        assert s.shape == d.shape == (count,)
        is_edge = np.array([(a, b) in edges or a == b for a, b in zip(s, d)])
        both = tm[s] & tm[d]
        if mode == "train":
            assert (both & ~is_edge).mean() >= 0.95
        else:
            assert not both.any()
            assert is_edge.mean() <= 0.05


def test_draw_pairs_shapes_and_split():
    cj, ct, jp, tp = setup_split()
    plan = tew.build_edgewise_plan(ct, tp)
    ew = tew.edgewise_consts(plan, "cpu")
    gen = torch.Generator().manual_seed(1)
    for mode, n_neg, edges in (("train", 32, plan.train_edges),
                               ("test", 64, plan.test_edges)):
        ps, pd, ns, nd = tew.draw_pairs(plan, ew, gen, mode)
        assert ps.shape == pd.shape == (32,) and ns.shape == nd.shape == (n_neg,)
        pos = set(zip(*edges.tolist()))
        assert all((a, b) in pos for a, b in zip(ps.tolist(), pd.tolist()))
    empty = dataclasses.replace(plan, test_edges=plan.test_edges[:, :0])
    with pytest.raises(ValueError, match="no test edges"):
        tew.draw_pairs(empty, tew.edgewise_consts(empty, "cpu"), gen, "test")


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("trick,se", [("InitialBatchNorm", "111"),
                                      ("ResidualNoNorm", "100")])
def test_i2gtl_teacher_step_matches_jax(trick, se):
    """One train-mode step at dropout 0 from the same weights and the same
    pairs: the edgewise loss (+ se_reg) and every gradient."""
    cj, ct, jp, tp = setup_split()
    over = dict(dropout=0.0, type_trick=trick, whetherHasSE=se, se_reg=0.5,
                dim_hidden=16, force_set_to_best_config=False)
    kw = dict(dataset="", train_which="TeacherGNN", exp_mode="I2_GTL",
              N_nodes=200, num_feats=40, num_classes=4, samp_size_p=32,
              samp_size_n_train=32, samp_size_n_test_times_p=2, **over)
    cj, ct = jcfg.build_config(**kw), tcfg.build_config(**kw)
    assert jloops.final_agg_view(cj, jp, is_dist=False) is None
    assert tloops.final_agg_view(ct, tp) is None
    plan = tew.build_edgewise_plan(ct, tp)
    pairs = tew.draw_pairs(plan, tew.edgewise_consts(plan, "cpu"),
                           torch.Generator().manual_seed(2), "train")
    pj = [jnp.asarray(p.numpy()) for p in pairs]

    model = JTeacher(cj)
    x = jnp.asarray(jp.x)
    params = jax.jit(lambda g: model.init(jax.random.PRNGKey(4), g, x,
                                          train=True))(jp.graph)["params"]

    def loss_fn(p):
        common, _, se_reg, _ = model.apply({"params": p}, jp.graph, x, train=True)
        l_struct, mrr = jew.linkp_loss_eva(
            jsddmm.edge_dot(common[pj[0]], common[pj[1]]),
            jsddmm.edge_dot(common[pj[2]], common[pj[3]]))
        loss = l_struct * cj.TeacherGNN.lossa_structure
        if se_reg is not None:
            loss = loss + cj.se_reg * se_reg
        return loss, mrr

    (loss_j, mrr_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)

    tm = TeacherGNN(ct)
    tm.load_state_dict(params_from_jax(flat(params), ct))
    tm.train()
    common, classi, se_reg, _ = tm(tp.graph, torch.from_numpy(tp.x))
    l_struct, mrr = tew.score_pairs(common, pairs)
    loss = tloops.teacher_loss(ct, classi, se_reg, torch.from_numpy(tp.y),
                               torch.from_numpy(tp.train_mask), l_struct)
    loss.backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_j), **tol)
    np.testing.assert_allclose(mrr.item(), float(mrr_j), **tol)
    want = params_from_jax(flat(grads_j), ct)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


def test_i2gtl_train_teacher_three_epochs():
    cj, ct, jp, tp = setup_split()
    res = tloops.train_teacher(ct, tp, seed=0, epochs=3, device="cpu")
    cols_j = jloops.train_teacher(cj, jp, seed=0, epochs=0).columns
    assert res.columns == cols_j
    assert res.columns[-2:] == ["linkp_train", "linkp_test"]
    assert res.records.shape == (3, len(cols_j)) and np.isfinite(res.records).all()
    mrr = res.records[:, -2:]
    assert (mrr > 0).all() and (mrr <= 1).all()
    assert res.last("linkp_test") == res.records[-1, -1]
    assert res.best("loss_train") == res.records[:, 0].max()
    again = tloops.train_teacher(ct, tp, seed=0, epochs=3, device="cpu")
    np.testing.assert_array_equal(again.records, res.records)  # seeded pairs
