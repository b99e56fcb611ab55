"""The port's label propagation and Correct & Smooth against the JAX
package's: the normalized adjacencies (weights and direction), label
propagation and the three C&S functions on dense and sparse adjacencies,
``run_pure_lp``, ``lp_step``, the mid-step models, the pipeline end to end,
and the copied host preprocessing (propagation/diffusion.py).

Tolerances: rtol = atol = 1e-5 for the propagations (f32 sums in another
order, 50 steps, values in [-1, 1]); rtol 1e-4, atol 1e-5 for the mid-step
MLP (matmuls); exact for the copied numpy code; the spectral features by
the subspace they span (ARPACK's start vector is process state)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.ops import spmm as jspmm
from gnn_tail_generalization_tpu.propagation import correlation as jcorr
from gnn_tail_generalization_tpu.propagation import cs as jcs
from gnn_tail_generalization_tpu.propagation import diffusion as jdiff
from gnn_tail_generalization_tpu.train import loops as jloops

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.ops import spmm as tspmm
from gnn_tail_generalization_tpu_torch.propagation import correlation as tcorr
from gnn_tail_generalization_tpu_torch.propagation import cs as tcs
from gnn_tail_generalization_tpu_torch.propagation import diffusion as tdiff
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.utils.convert import state_dict_from_flax

PROP = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
N, C = 60, 3


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def directed_edges(rng, n=N, e=200):
    """Directed random edges among the first n - 8 nodes: the last 8 are
    isolated (zero degree, zero rows in every normalization)."""
    return np.stack([rng.integers(0, n - 8, e), rng.integers(0, n - 8, e)])


def labels_and_outputs(rng, n=N):
    y = rng.integers(0, C, n)
    logits = rng.normal(size=(n, C)).astype(np.float32)
    model_out = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    idx = np.sort(rng.choice(n, n // 3, replace=False))
    return y, model_out.astype(np.float32), idx


@pytest.mark.parametrize("threshold", [N, 10], ids=["dense", "sparse"])
def test_normalized_adjs_match_jax(rng, threshold):
    e = directed_edges(rng)
    js = jcorr.gen_normalized_adjs(e, N, dense_threshold=threshold)
    ts = tcorr.gen_normalized_adjs(e, N, dense_threshold=threshold)
    x = rng.normal(size=(N, 5)).astype(np.float32)
    for name, jg, tg in zip(("DAD", "DA", "AD"), js, ts):
        assert not tg.has_plans and jg.plans is None
        assert (tg.dense_adj is None) == (jg.dense_adj is None)
        k = tg.n_edge
        np.testing.assert_array_equal(tg.indices.numpy(),
                                      np.asarray(jg.senders)[:k], err_msg=name)
        np.testing.assert_array_equal(tcore.edge_rows(tg.indptr, k).numpy(),
                                      np.asarray(jg.receivers)[:k], err_msg=name)
        np.testing.assert_array_equal(tg.weight.numpy(),
                                      np.asarray(jg.edge_weight)[:k], err_msg=name)
        np.testing.assert_allclose(
            tspmm.spmm(tg, torch.from_numpy(x)).numpy(),
            np.asarray(jspmm.spmm(jg, jnp.asarray(x))), **PROP, err_msg=name)
    # DA = D^-1 A is row-stochastic on the connected rows, AD column-
    # stochastic: a flipped edge list would swap the two
    ones = torch.ones(N, 1)
    da, ad = ts[1], ts[2]
    np.testing.assert_allclose(tspmm.spmm(da, ones)[: N - 8].numpy(), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(tspmm.spmm(ad.transpose(), ones)[: N - 8].numpy(),
                               1.0, rtol=1e-5)
    assert tcorr.gen_normalized_adjs(e, N, which={"DA"})[::2] == (None, None)


def _cs_call(mod, fn, y, model_out, idx, A1, A2, to):
    if fn == "label_propagation":
        return (mod.label_propagation(to(y), to(idx), A1, 0.7, 50, C),)
    if fn == "only_outcome_correlation":
        return mod.only_outcome_correlation(to(y), to(model_out), to(idx), A1,
                                            0.6, 50, C)
    f = getattr(mod, fn)
    return f(to(y), to(model_out), to(idx), to(idx), A1, 0.98, 50, A2, 0.75,
             50, C)


@pytest.mark.parametrize("fn", ["label_propagation", "double_correlation_autoscale",
                                "double_correlation_fixed",
                                "only_outcome_correlation"])
@pytest.mark.parametrize("threshold", [N, 10], ids=["dense", "sparse"])
def test_propagations_match_jax(rng, fn, threshold):
    e = directed_edges(rng)
    y, model_out, idx = labels_and_outputs(rng)
    jdad, jda, jad = jcorr.gen_normalized_adjs(e, N, dense_threshold=threshold)
    tdad, tda, tad = tcorr.gen_normalized_adjs(e, N, dense_threshold=threshold)
    j1, t1 = (jdad, tdad) if fn in ("label_propagation",
                                    "only_outcome_correlation") else (jda, tda)
    got = _cs_call(tcorr, fn, y, model_out, idx, t1, tad, torch.as_tensor)
    want = _cs_call(jcorr, fn, y, model_out, idx, j1, jad, jnp.asarray)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PROP)


def test_autoscale_rules(rng):
    """inf and > 1000 scales become 1; NaN rows fall back to model_out."""
    e = directed_edges(rng)
    y, model_out, idx = labels_and_outputs(rng)
    _, da, ad = tcorr.gen_normalized_adjs(e, N)
    y_t, out_t, idx_t = map(torch.as_tensor, (y, model_out, idx))
    res, _ = tcorr.double_correlation_autoscale(y_t, out_t, idx_t, idx_t, da,
                                                0.98, 5, ad, 0.75, 5, C)
    # unlabeled isolated rows keep a zero residual: scale inf -> 1
    iso = torch.tensor([i for i in range(N - 8, N) if i not in set(idx)])
    assert len(iso)
    torch.testing.assert_close(res[iso], out_t[iso])
    nan_out = out_t.clone()
    nan_out[0] = torch.nan
    res, _ = tcorr.double_correlation_autoscale(y_t, nan_out, idx_t, idx_t,
                                                da, 0.98, 5, ad, 0.75, 5, C)
    assert torch.isnan(res[0]).all()  # model_out itself is the fallback


def two_cluster_arrays(rng, n=120, intra=400):
    """tests/test_propagation.py's planted clusters."""
    h = n // 2
    a, b = rng.integers(0, h, intra), rng.integers(0, h, intra)
    e = np.concatenate([np.stack([a, b]), np.stack([a + h, b + h]),
                        np.stack([[0], [h]])], axis=1)
    e = tcore.remove_self_loops(tcore.symmetrize(e, n))
    y = np.concatenate([np.zeros(h), np.ones(h)]).astype(np.int64)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[:, 0] += y * 2
    train = rng.random(n) < 0.4
    return dict(x=x, y=y, edge_index=e, train_mask=train,
                val_mask=(~train) & (rng.random(n) < 0.5), test_mask=None,
                name="two-cluster")


def prepared_pair(rng, **extra):
    arrays = two_cluster_arrays(rng)
    kw = dict(dataset="", train_which="LP", force_set_to_best_config=False,
              N_nodes=120, num_feats=6, num_classes=2, use_special_split=False,
              lr=0.01)
    kw.update(extra)
    cj, ct = jcfg.build_config(**kw), tcfg.build_config(**kw)
    ct = dataclasses.replace(ct, preStep=dataclasses.replace(
        ct.preStep, pre_methods="diffusion"))
    cj = dataclasses.replace(cj, preStep=ct.preStep)
    return (cj, ct, jds.prepare(jds.NodeData(**arrays), cj),
            tds.prepare(tds.NodeData(**arrays), ct))


@pytest.mark.parametrize("method", ["auto", "pallas_bf16"])
def test_run_pure_lp_matches_jax(rng, method):
    cj, ct, jp, tp = prepared_pair(rng, spmm_method=method)
    got, want = tloops.run_pure_lp(ct, tp, device="cpu"), jloops.run_pure_lp(cj, jp)
    assert got.keys() == want.keys() == {"acc_train", "acc_test"}
    n_train = tp.train_mask.sum()
    for k, count in (("acc_train", n_train), ("acc_test", 120 - n_train)):
        assert abs(got[k] - want[k]) <= 100.0 / count + 0.01, (k, got, want)
    assert tloops.run_experiment(ct, tp, device="cpu") == got


@pytest.mark.parametrize("fn", ["double_correlation_autoscale",
                                "double_correlation_fixed",
                                "only_outcome_correlation"])
def test_lp_step_matches_jax(rng, fn):
    cj, ct, jp, tp = prepared_pair(rng)
    lp = dataclasses.replace(ct.lpStep, no_prep=False, fn=fn,
                             num_propagations1=20, num_propagations2=20)
    cj, ct = (dataclasses.replace(c, lpStep=lp) for c in (cj, ct))
    logits = rng.normal(size=(120, 2)).astype(np.float32)
    out = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    idx = tp.train_idx
    got = tcs.lp_step(ct, tp, torch.from_numpy(out), torch.from_numpy(idx),
                      torch.from_numpy(idx))
    want = jcs.lp_step(cj, jp, jnp.asarray(out), jnp.asarray(idx), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PROP)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_csmlp_matches_flax(rng, train):
    """Forward, gradients and (train mode) batch statistics, at dropout 0."""
    x = rng.normal(size=(40, 10)).astype(np.float32)
    ct_ = rng.normal(size=(40, 3)).astype(np.float32)
    jm = jcs.CSMLp(16, 3, 3, dropout=0.0)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(np.abs(rng.normal(size=v.shape)) + 0.5
                                 if p[-1].key == "var"
                                 else rng.normal(size=v.shape), jnp.float32),
        variables)

    def loss(p):
        out, new = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=train, mutable=["batch_stats"])
        return jnp.sum(out * ct_), (out, new)

    (_, (out_j, new_j)), grads_j = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    tm = tcs.CSMLp(10, 16, 3, 3, dropout=0.0)
    tm.load_state_dict(state_dict_from_flax(flat(variables), tm))
    tm.train(train)
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(ct_)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    want = state_dict_from_flax({**flat(grads_j), **flat(new_j)}, tm)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), **TOL, err_msg=k)
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[k].numpy(), **TOL, err_msg=k)
    jl = jcs.CSLinear(3)
    lv = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tl = tcs.CSLinear(10, 3)
    tl.load_state_dict(state_dict_from_flax(flat(lv), tl))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl.apply(lv, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("model", ["mlp", "linear"])
def test_run_cs_pipeline_ends_finite_above_chance(rng, model):
    _, ct, _, tp = prepared_pair(rng)
    ct = dataclasses.replace(ct, midStep=dataclasses.replace(ct.midStep,
                                                             model=model))
    res = tcs.run_cs_pipeline(ct, tp, epochs=30, device="cpu")
    assert res["out"].shape == (120, 2) and torch.isfinite(res["out"]).all()
    assert res["acc_test"] > 70.0 and 0.0 <= res["acc_valid_mid"] <= 100.0


def test_pre_step_cache(tmp_path, rng):
    _, ct, _, tp = prepared_pair(rng)
    a = tcs.pre_step(ct, tp, cache_dir=str(tmp_path))
    assert list(tmp_path.iterdir())
    np.testing.assert_array_equal(tcs.pre_step(ct, tp, cache_dir=str(tmp_path)), a)


# ---------------------------------------------------------------------------
# propagation/diffusion.py, the copy, against the original
# ---------------------------------------------------------------------------


def test_diffusion_features_equal_the_original(rng):
    a = two_cluster_arrays(rng)
    e, x, y = a["edge_index"], a["x"], a["y"]
    train_idx = np.where(a["train_mask"])[0]
    adj_t, adj_j = tdiff.dad_adjacency(e, 120), jdiff.dad_adjacency(e, 120)
    np.testing.assert_array_equal(adj_t.toarray(), adj_j.toarray())
    np.testing.assert_array_equal(tdiff.sgc_features(x, adj_t, 4),
                                  jdiff.sgc_features(x, adj_j, 4))
    np.testing.assert_array_equal(tdiff.lp_features(adj_t, train_idx, y, 5),
                                  jdiff.lp_features(adj_j, train_idx, y, 5))
    np.testing.assert_array_equal(tdiff.diffusion_features(x, adj_t, 5),
                                  jdiff.diffusion_features(x, adj_j, 5))
    np.testing.assert_array_equal(tdiff.louvain_communities(e, 120, seed=3),
                                  jdiff.louvain_communities(e, 120, seed=3))
    np.testing.assert_array_equal(tdiff.community_features(e, 120),
                                  jdiff.community_features(e, 120))


def test_spectral_features_span_the_original_subspace(rng):
    e = two_cluster_arrays(rng)["edge_index"]
    t, j = tdiff.spectral_embedding(e, 120, 8), jdiff.spectral_embedding(e, 120, 8)
    assert t.shape == j.shape == (120, 8)
    # cosines of the principal angles between the two column spaces
    qt, qj = np.linalg.qr(t)[0], np.linalg.qr(j)[0]
    cos = np.linalg.svd(qt.T @ qj, compute_uv=False)
    np.testing.assert_allclose(cos, 1.0, atol=1e-4)
