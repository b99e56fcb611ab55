"""The port's link prediction against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages, with
weights carried across by ``utils/convert.py``. Sizes: n = 300 (a dense
adjacency on both sides) and n = 5,000 (above the JAX package's 4,096-node
dense limit: Pallas plans, so the JAX side runs its Pallas kernel in
interpret mode and the port the CSR kernels' plain versions).

Tolerances:
- samplers' hashes, hits@K, recall and host copies: exact;
- MRR (a float32 mean of reciprocal ranks, summed in another order by XLA
  and torch): 1e-6 relative;
- losses, value and gradient: 1e-6;
- predictors, encoders and whole-model forward and gradients under
  ``auto``/``pallas``: 1e-4 relative, with an absolute floor of 1e-5 of the
  largest gradient (the Transformer's key bias has a gradient that is zero
  up to rounding: softmax is shift-invariant);
- under ``pallas_bf16``: outputs and gradients 2^-7 relative, with an
  absolute floor of 2^-7 of the tensor's largest entry. Each Dense computes
  and rounds its output, and its parameter gradients, to bf16's 8-bit
  significand; XLA and torch accumulate the products in another order, so
  an entry may land a bf16 unit (2^-8 of the magnitudes summed into it)
  away, and a result built on it carries that on. Bias gradients: 3e-2 of
  their largest entry, because a bias's gradient is a sum of a bf16
  cotangent over the N rows, which XLA on the CPU accumulates in bf16 (1%
  from the float64 sum at n = 300) and torch in f32 (0.14%);
- one train step (loss, then every parameter after the clipped Adam/AdamW
  update): 1e-5 relative, parameters 1e-6 absolute; except entries whose
  first gradient is rounding noise, below 1e-7 of the model's largest
  gradient (the Transformer's key bias, whose gradient is zero but for
  rounding since softmax is shift-invariant; two node-embedding entries of
  the Transformer case at n = 5,000, near 1e-8): Adam divides by
  the gradient's own size, so their steps (up to ``lr``) follow the noise,
  and they are held within 2 ``lr`` a step. Under 1% of the entries are;
- edge LP: 1e-5.
Dropout is 0 wherever both sides are compared: random streams differ
between frameworks by design, so the samplers are held to properties.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization_tpu.graph import core as jcore
from gnn_tail_generalization_tpu.linkpred import edge_lp as jelp
from gnn_tail_generalization_tpu.linkpred import encoders as jenc
from gnn_tail_generalization_tpu.linkpred import losses as jloss
from gnn_tail_generalization_tpu.linkpred import metrics as jmet
from gnn_tail_generalization_tpu.linkpred import model as jlpm
from gnn_tail_generalization_tpu.linkpred import predictors as jpred
from gnn_tail_generalization_tpu.linkpred import sampling as jsamp

from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.linkpred import edge_lp as telp
from gnn_tail_generalization_tpu_torch.linkpred import encoders as tenc
from gnn_tail_generalization_tpu_torch.linkpred import losses as tloss
from gnn_tail_generalization_tpu_torch.linkpred import metrics as tmet
from gnn_tail_generalization_tpu_torch.linkpred import model as tlpm
from gnn_tail_generalization_tpu_torch.linkpred import predictors as tpred
from gnn_tail_generalization_tpu_torch.linkpred import sampling as tsamp
from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
from gnn_tail_generalization_tpu_torch.utils.convert import (
    linkpred_params_from_jax, state_dict_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [300, 5000]
F, H = 12, 16  # feature and hidden widths


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def msg_graph(n, seed=0):
    return jcore.symmetrize(fast_powerlaw_graph(n, 4 * n, seed), n)


def jax_link_graph(cfg, msg, n):
    """The graph the JAX package's train_linkpred builds (model.py:408-443)."""
    e_msg, w = msg, None
    if cfg.encoder.upper() == "GCN":
        e_msg = jcore.add_self_loops(jcore.remove_self_loops(msg), n)
        w = jcore.gcn_norm_weights(e_msg, n)
    return jcore.build_graph(e_msg, n, edge_weight=w, with_dense=n <= 4096,
                             with_plans=n > 4096)


#: two units of bf16's 8-bit significand (the module docstring)
BF16_TOL = 2.0 ** -7


def assert_close_mrr(got, want):
    """Metric dicts equal, the MRR means to 1e-6 relative."""
    assert got.keys() == want.keys()
    for k in want:
        if k == "MRR":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            assert got[k] == want[k], k


def assert_grads(got, want, rtol=1e-4, floor=1e-5, bias_rtol=None,
                 bf16=False):
    """Every parameter gradient of ``got`` (name -> tensor) equals ``want``
    (name -> tensor): ``rtol``, with an absolute floor of ``floor`` x the
    largest gradient; ``bias_rtol``: bias gradients to that fraction of
    their largest entry instead; ``bf16``: the other gradients to BF16_TOL
    relative, with a floor of BF16_TOL x the tensor's largest entry."""
    assert got.keys() == want.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        w = w.numpy()
        if bias_rtol is not None and k.endswith("bias"):
            atol, rt = bias_rtol * np.abs(w).max(), 0.0
        elif bf16:
            atol, rt = BF16_TOL * np.abs(w).max(), BF16_TOL
        else:
            atol, rt = floor * scale, rtol
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rt, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _sentinel_pair(n_node):
    """A (src, dst) pair of node ids below ``n_node`` whose hash is the
    membership table's empty-slot sentinel -2^31."""
    src = np.arange(n_node, dtype=np.int64)
    inv97 = pow(97, -1, 2**32)
    dst = ((2**31 - src * int(jsamp._H1)) * inv97) % 2**32
    i = int(np.flatnonzero(dst < n_node)[0])
    return int(src[i]), int(dst[i])


@pytest.mark.parametrize("slots", [8, 1])
def test_is_member_matches_jax(slots):
    """The torch hash and both membership tests (bucket table with spill,
    sorted keys) equal the JAX ones on the same candidates: node ids near
    2.93M, a key equal to the table's sentinel, and (slots=1) most keys
    spilled."""
    rng = np.random.default_rng(0)
    n = 2_927_963
    s_src, s_dst = _sentinel_pair(n)
    e = np.stack([rng.integers(n - 5000, n, 4000), rng.integers(0, n, 4000)])
    e = np.concatenate([e, [[s_src], [s_dst]]], axis=1)
    keys = tsamp.edge_keys(e, n)
    np.testing.assert_array_equal(keys, jsamp.edge_keys(e, n))
    assert (keys == tsamp._EMPTY).any()
    cand = np.concatenate([e, rng.integers(n - 100, n, (2, 3000)),
                           np.arange(n - 50, n)[None].repeat(2, 0)], axis=1)
    src, dst = torch.from_numpy(cand[0]), torch.from_numpy(cand[1])
    with np.errstate(over="ignore"):
        want_hash = jsamp._hash32(cand[0].astype(np.int32),
                                  cand[1].astype(np.int32))
    np.testing.assert_array_equal(tsamp.hash32(src, dst).numpy(), want_hash)
    tm, jm = tsamp.build_membership(keys, slots), jsamp.build_membership(keys, slots)
    np.testing.assert_array_equal(tm.buckets.numpy(), np.asarray(jm.buckets))
    np.testing.assert_array_equal(tm.spill.numpy(), np.asarray(jm.spill))
    if slots == 1:
        assert tm.spill.numel() > 100
    for tk, jk in ((tm, jm), (torch.from_numpy(keys), jnp.asarray(keys))):
        got = tsamp._is_member(tk, src, dst).numpy()
        want = np.asarray(jsamp._is_member(jk, jnp.asarray(cand[0]),
                                           jnp.asarray(cand[1])))
        np.testing.assert_array_equal(got, want)
        assert got[:e.shape[1]].all()  # every edge is found, the sentinel too


def _sampling_setup(use_table):
    n = 5000
    msg = msg_graph(n)
    keys_np = tsamp.edge_keys(msg, n)
    keys = (tsamp.build_membership(keys_np) if use_table
            else torch.from_numpy(keys_np))
    edge_set = set(zip(msg[0].tolist(), msg[1].tolist()))
    return n, msg, keys, edge_set


def _non_edges(pairs, edge_set):
    return all(a != b and (a, b) not in edge_set
               for a, b in pairs.reshape(-1, 2).tolist())


@pytest.mark.parametrize("use_table", [True, False])
def test_global_samplers_never_return_an_edge(use_table):
    n, _, keys, edge_set = _sampling_setup(use_table)
    gen = torch.Generator().manual_seed(0)
    neg = tsamp.global_neg_sample(gen, keys, n, 4000, 3)
    assert neg.shape == (4000, 3, 2) and neg.dtype == torch.int64
    assert _non_edges(neg, edge_set)
    perm = tsamp.global_perm_neg_sample(gen, keys, n, 4000, 3, perm_within=1000)
    assert perm.shape == (4000, 3, 2) and _non_edges(perm, edge_set)
    # each copy permutes the base draw within every group of 1000
    base = perm[:, 0].reshape(4, 1000, 2).numpy()
    for j in (1, 2):
        copy = perm[:, j].reshape(4, 1000, 2).numpy()
        assert not np.array_equal(copy, base)
        for b, c in zip(base, copy):
            np.testing.assert_array_equal(np.unique(b, axis=0), np.unique(c, axis=0))
    with pytest.raises(ValueError, match="groups"):
        tsamp.global_perm_neg_sample(gen, keys, n, 4000, 3, perm_within=999)


def test_local_sampler_keeps_the_source():
    n, msg, _, _ = _sampling_setup(False)
    pos = torch.from_numpy(msg.T[:500].copy())
    gen = torch.Generator().manual_seed(1)
    neg = tsamp.local_neg_sample(gen, pos, n, 4)
    assert neg.shape == (500, 4, 2)
    assert torch.equal(neg[:, :, 0], pos[:, :1].expand(500, 4))
    assert 0 <= int(neg[..., 1].min()) and int(neg[..., 1].max()) < n
    # uniform destinations: 2,000 draws of 5,000 ids give ~1,650 distinct
    assert len(torch.unique(neg[..., 1])) > 1500


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

LOSS_NAMES = ["auc_loss", "adaptive_auc_loss", "log_rank_loss", "ce_loss",
              "info_nce_loss"]


def _call_loss(mod, name, pos, neg, num_neg, valid, weight):
    fn = getattr(mod, name)
    if name == "ce_loss":
        return fn(pos, neg, valid=valid, num_neg=num_neg)
    if name == "adaptive_auc_loss":
        return fn(pos, neg, num_neg, weight, valid=valid)
    return fn(pos, neg, num_neg, valid=valid)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_value_and_gradient_match_jax(name, masked):
    rng = np.random.default_rng(3)
    b, k = 40, 3
    pos = (rng.normal(size=b) * 3).astype(np.float32)
    neg = (rng.normal(size=b * k) * 3).astype(np.float32)
    weight = rng.random(b).astype(np.float32)
    valid = (np.arange(b) < 29).astype(np.float32) if masked else None

    def jloss_of(p, q):
        return _call_loss(jloss, name, p, q, k,
                          None if valid is None else jnp.asarray(valid),
                          jnp.asarray(weight))

    lj, (gpj, gnj) = jax.value_and_grad(jloss_of, argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg))
    tp = torch.from_numpy(pos).requires_grad_()
    tn = torch.from_numpy(neg).requires_grad_()
    lt = _call_loss(tloss, name, tp, tn, k,
                    None if valid is None else torch.from_numpy(valid),
                    torch.from_numpy(weight))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gpj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gnj), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_stay_finite_at_large_scores(name):
    pos = torch.tensor([500.0, -500.0, 500.0], requires_grad=True)
    neg = torch.tensor([-500.0, 500.0, 500.0, -500.0, 500.0, -500.0],
                       requires_grad=True)
    loss = _call_loss(tloss, name, pos, neg, 2, torch.ones(3), torch.ones(3))
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(pos.grad).all()
    assert torch.isfinite(neg.grad).all()


def test_hits_and_mrr_match_jax():
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 6, 50).astype(np.float32)  # integers: many ties
    neg = rng.integers(0, 6, (50, 20)).astype(np.float32)
    tpos, tneg = torch.from_numpy(pos), torch.from_numpy(neg)
    np.testing.assert_allclose(tmet.mrr(tpos, tneg),
                               jmet.mrr(jnp.asarray(pos), jnp.asarray(neg)),
                               rtol=1e-6)
    flat_neg = neg.reshape(-1)
    for k in (1, 20, 100, 5000):
        assert tmet.hits_at_k(tpos, torch.from_numpy(flat_neg), k) == \
            jmet.hits_at_k(jnp.asarray(pos), jnp.asarray(flat_neg), k)


@pytest.mark.parametrize("n_neg", [1000, 1013, 30])  # even, truncated, shared
def test_group_negs_and_evaluators_match_jax(n_neg):
    rng = np.random.default_rng(5)
    pv, pt = rng.normal(size=50).astype(np.float32), rng.normal(size=50).astype(np.float32)
    nv, nt = (rng.normal(size=n_neg).astype(np.float32) for _ in range(2))
    ptr, ntr = rng.normal(size=80).astype(np.float32), rng.normal(size=70).astype(np.float32)
    t = [torch.from_numpy(a) for a in (ptr, ntr, pv, nv, pt, nt)]
    j = [jnp.asarray(a) for a in (ptr, ntr, pv, nv, pt, nt)]
    np.testing.assert_array_equal(tmet._group_negs(t[2], t[3]).numpy(),
                                  np.asarray(jmet._group_negs(j[2], j[3])))
    assert_close_mrr(tmet.evaluate_mrr(*t[2:]), jmet.evaluate_mrr(*j[2:]))
    assert tmet.evaluate_hits(*t[2:]) == jmet.evaluate_hits(*j[2:])
    for topk in (None, 0, 1.25, 10):
        assert tmet.evaluate_recall_my(*t, topk=topk) == \
            jmet.evaluate_recall_my(*j, topk=topk)


# ---------------------------------------------------------------------------
# predictors and encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["DOT", "BIL", "MLP", "MLPCAT", "MLPDOT",
                                  "MLPBIL"])
def test_predictor_matches_flax(name):
    rng = np.random.default_rng(6)
    xi, xj = (rng.normal(size=(64, H)).astype(np.float32) for _ in range(2))
    r = rng.normal(size=64).astype(np.float32)
    jp = jpred.create_predictor(name, H, 3, 0.0)
    variables = jp.init(jax.random.PRNGKey(0), jnp.asarray(xi), jnp.asarray(xj))
    params = variables.get("params", {})

    def f(p, a, b):
        return jnp.sum(jp.apply({"params": p}, a, b) * r)

    out_j = jp.apply({"params": params}, jnp.asarray(xi), jnp.asarray(xj))
    grads_j, gxi_j = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(xi),
                                                 jnp.asarray(xj))
    tp = tpred.create_predictor(name, H, H, 3, 0.0)
    tp.load_state_dict(state_dict_from_flax(flat(params), tp))
    txi = torch.from_numpy(xi).requires_grad_()
    out = tp(txi, torch.from_numpy(xj))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(txi.grad.numpy(), np.asarray(gxi_j), rtol=1e-4,
                               atol=1e-5)
    if params:
        assert_grads({k: p.grad for k, p in tp.named_parameters()},
                     state_dict_from_flax(flat(grads_j), tp))


ENCODER_CASES = ([(k, m) for k in ("SAGE", "GCN", "WSAGE")
                  for m in ("auto", "pallas", "pallas_bf16")]
                 + [("Transformer", "auto"), ("MLP", "auto")])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,method", ENCODER_CASES)
def test_encoder_matches_flax(kind, method, n):
    """Forward and every parameter gradient of a 2-layer encoder; n = 5000
    runs the JAX side's Pallas kernel in interpret mode."""
    cfg = jlpm.LinkPredConfig(encoder=kind, spmm_method=method)
    msg = msg_graph(n)
    jg = jax_link_graph(cfg, msg, n)
    tg = tlpm.link_graph(tlpm.LinkPredConfig(encoder=kind, spmm_method=method),
                         msg, n)
    assert (jg.plans is not None) == tg.has_plans == (n > 4096)
    # a seed whose first-layer pre-activations keep clear of relu's kink:
    # one within f32 rounding of 0 (seed 7 puts one at 5e-8 under MLP at
    # n = 5000) switches on one side only and moves a gradient by a whole
    # row's cotangent
    rng = np.random.default_rng(17)
    x = rng.normal(size=(n, F)).astype(np.float32)
    r = rng.normal(size=(n, H)).astype(np.float32)
    je = jenc.GNNEncoder(kind, H, H, 2, 0.0, method)
    params = je.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))["params"]

    def f(p):
        h = je.apply({"params": p}, jg, jnp.asarray(x))
        return jnp.sum(h * r), h

    (_, h_j), grads_j = jax.value_and_grad(f, has_aux=True)(params)
    te = tenc.GNNEncoder(kind, F, H, H, 2, 0.0, method)
    te.load_state_dict(state_dict_from_flax(flat(params), te))
    h = te(tg, torch.from_numpy(x))
    (h * torch.from_numpy(r)).sum().backward()
    assert h.dtype == torch.float32
    bf16 = method == "pallas_bf16"
    rtol, floor = (BF16_TOL, BF16_TOL) if bf16 else (1e-4, 1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), rtol=rtol,
                               atol=floor * float(jnp.abs(h_j).max()))
    assert_grads({k: p.grad for k, p in te.named_parameters()},
                 state_dict_from_flax(flat(grads_j), te),
                 bias_rtol=3e-2 if bf16 else None, bf16=bf16)


@pytest.mark.parametrize("method", ["auto", "pallas_bf16"])
@pytest.mark.parametrize("kind", ["SAGE", "WSAGE", "GCN"])
def test_hoisted_first_agg_equals_the_unhoisted_encode(kind, method):
    n = 5000
    cfg = tlpm.LinkPredConfig(encoder=kind, spmm_method=method)
    g = tlpm.link_graph(cfg, msg_graph(n), n)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(n, F)).astype(np.float32))
    enc = tenc.GNNEncoder(kind, F, H, H, 2, 0.0, method,
                          generator=torch.Generator().manual_seed(0))
    agg0 = tenc.hoisted_first_agg(kind, g, x, method)
    if method == "pallas_bf16":
        agg0 = agg0.to(torch.bfloat16)  # as train_linkpred stores it
    with torch.no_grad():
        want, got = enc(g, x), enc(g, x, agg0=agg0)
    if kind == "GCN":  # A (x W) against (A x) W: the same up to rounding
        tol = 2e-2 if method == "pallas_bf16" else 1e-5
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol * float(want.abs().max()))
    else:  # the same aggregation, the same operands
        assert torch.equal(got, want)
    assert not tenc.hoistable("Transformer") and not tenc.hoistable("MLP")
    with pytest.raises(ValueError, match="agg0"):
        tenc.GNNEncoder("MLP", F, H, H, 2)(g, x, agg0=agg0)


def test_spmm_takes_a_bf16_input_and_returns_its_dtype_in_the_gradient():
    n = 5000
    g = tcore.build_graph(msg_graph(n), n, with_dense=False, with_plans=True)
    x = torch.randn(n, 8, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16).requires_grad_()
    y = spmm(g, xb, "pallas_bf16")
    assert y.dtype == torch.float32
    y.sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(y.detach().numpy(),
                               spmm(g, xb.detach().float(), "gather").numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model, one train step, evaluate
# ---------------------------------------------------------------------------


def model_pair(n, **kw):
    """The same LinkPredModel in both packages: configs, graphs, features,
    flax params, the port's model holding them, and both step constants."""
    kw.setdefault("dropout", 0.0)
    kw.setdefault("gnn_hidden_channels", H)
    kw.setdefault("mlp_hidden_channels", H)
    kw.setdefault("emb_hidden_channels", H)
    cj, ct = jlpm.LinkPredConfig(**kw), tlpm.LinkPredConfig(**kw)
    msg = msg_graph(n)
    jg, tg = jax_link_graph(cj, msg, n), tlpm.link_graph(ct, msg, n)
    x = np.random.default_rng(9).normal(size=(n, F)).astype(np.float32)
    jm = jlpm.LinkPredModel(cj, n, F)
    z = jnp.zeros(2, jnp.int32)
    params = jm.init(jax.random.PRNGKey(2), jg, jnp.asarray(x), z, z)["params"]
    tm = tlpm.LinkPredModel(ct, n, F)
    tm.load_state_dict(linkpred_params_from_jax(flat(params), ct, n, F))
    agg0_j = None
    if cj.use_node_feats and not cj.train_node_emb and jenc.hoistable(cj.encoder):
        agg0_j = jenc.hoisted_first_agg(cj.encoder, jg, jnp.asarray(x),
                                        cj.spmm_method).astype(
            jnp.bfloat16 if cj.spmm_method == "pallas_bf16" else jnp.float32)
    const_j = {"g": jg, "x": jnp.asarray(x), "agg0": agg0_j}
    const_t = tlpm.link_const(ct, tg, torch.from_numpy(x))
    assert (agg0_j is None) == (const_t["agg0"] is None)
    return cj, ct, msg, jm, params, tm, const_j, const_t


def batch(n, msg, b=96, num_neg=3, n_valid=70, seed=10):
    rng = np.random.default_rng(seed)
    pos = msg.T[rng.choice(msg.shape[1], b, replace=False)]
    neg = rng.integers(0, n, (b, num_neg, 2))
    valid = (np.arange(b) < n_valid).astype(np.float32)
    return pos, neg, valid


STEP_CASES = [
    # (n, config overrides, whether the first gradient's global norm reaches
    # the clip): the reference default (a trainable embedding), raw features
    # with the hoisted aggregation, both, AdamW on both sides of the clip,
    # other losses
    (300, dict(loss_func="auc_loss"), True),
    (300, dict(), False),
    (300, dict(optimizer="AdamW", predictor="MLP", encoder="GCN"), False),
    (300, dict(use_node_feats=True, train_node_emb=False, encoder="WSAGE",
               loss_func="info_nce_loss", predictor="BIL"), True),
    (5000, dict(use_node_feats=True, train_node_emb=False), True),
    (5000, dict(use_node_feats=True, train_node_emb=True, encoder="GCN",
                optimizer="AdamW", loss_func="log_rank_loss"), False),
    (5000, dict(loss_func="auc_loss", encoder="Transformer",
                predictor="MLPDOT", optimizer="AdamW"), True),
]


@pytest.mark.parametrize("n,kw,clips", STEP_CASES)
def test_train_step_matches_jax(n, kw, clips):
    """Two train_linkpred steps from the same parameters on fixed positives,
    negatives and valid mask: the loss of each and every parameter after the
    global-norm clip and the Adam/AdamW update."""
    cj, ct, msg, jm, params, tm, const_j, const_t = model_pair(n, **kw)
    pos, neg, valid = batch(n, msg, num_neg=cj.num_neg)
    base = optax.adamw(cj.lr) if cj.optimizer == "AdamW" else optax.adam(cj.lr)
    tx = optax.chain(optax.clip_by_global_norm(cj.grad_clip_norm), base)
    jstep = jlpm.make_train_step(cj, jm, tx)
    opt_state = tx.init(params)
    tstep = tlpm.make_train_step(ct, tm, tlpm.make_optimizer(ct, tm.parameters()))
    loss_fn = jlpm.make_loss_fn(cj, jm)
    args_j = (const_j, jnp.asarray(pos), jnp.asarray(neg),
              jax.random.PRNGKey(0), jnp.asarray(valid))
    grads = jax.grad(loss_fn)(params, *args_j)
    norm = float(optax.global_norm(grads))
    grads = linkpred_params_from_jax(flat(grads), ct, n, F)
    # entries whose gradient is rounding noise (the module docstring)
    g_max = max(float(g.abs().max()) for g in grads.values())
    noise = {k: g.abs() < 1e-7 * g_max for k, g in grads.items()}
    tm.train()
    steps = 2
    for _ in range(steps):
        params, opt_state, loss_j = jstep(params, opt_state, *args_j)
        loss_t = tstep(const_t, torch.from_numpy(pos), torch.from_numpy(neg),
                       None, torch.from_numpy(valid))
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = linkpred_params_from_jax(flat(params), ct, n, F)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        w, g, m = want[k].numpy(), got[k].numpy(), noise[k].numpy()
        np.testing.assert_allclose(g[~m], w[~m], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g[m], w[m], rtol=0, atol=2 * steps * cj.lr,
                                   err_msg=k)
    assert (norm >= cj.grad_clip_norm) == clips, norm
    # the noise rule leaves all but a few entries to the strict bound
    assert sum(int(m.sum()) for m in noise.values()) <= 0.01 * sum(
        m.numel() for m in noise.values())


def test_clip_by_global_norm_is_optax_rule():
    p = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    for scale in (0.1, 10.0):
        grads = [torch.tensor([1.0, -2.0, 2.0]) * scale, torch.tensor([4.0, 0.0]) * scale]
        for q, g in zip(p, grads):
            q.grad = g.clone()
        tlpm.clip_by_global_norm(p, 2.0)
        want = optax.clip_by_global_norm(2.0).update(
            [jnp.asarray(g.numpy()) for g in grads], None)[0]
        for q, w in zip(p, want):
            np.testing.assert_allclose(q.grad.numpy(), np.asarray(w), rtol=1e-6)


def _jax_eval_fns(jm, params):
    """encode_all and predict_chunked as train_linkpred defines them."""
    def encode_all(p, c):
        return jm.apply({"params": p}, c["g"], c["x"], train=False,
                        agg0=c.get("agg0"), method=jm.encode)

    def predict_chunked(p, h, edges):
        edges = jnp.asarray(np.asarray(edges))
        return jm.apply({"params": p}, h[edges[:, 0]], h[edges[:, 1]],
                        train=False, method=jm.predict_pairs)

    return encode_all, predict_chunked


def _split(n, msg, seed=0):
    split_edge, _ = jlpm.simple_split_edges(msg, n, num_neg_eval=20, seed=seed)
    return split_edge


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("metric", ["mrr", "hits", "recall_my@1.25"])
def test_evaluate_matches_jax(n, metric):
    cj, ct, msg, jm, params, tm, const_j, const_t = model_pair(
        n, eval_metric=metric, use_node_feats=True, train_node_emb=False,
        predictor="MLP")
    split_edge = _split(n, msg)
    want = jlpm.evaluate(cj, jm, params, const_j, split_edge,
                         *_jax_eval_fns(jm, params))
    got = tlpm.evaluate(ct, tm, const_t, split_edge)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_predict_chunked_equals_whole_split_scoring():
    n = 300
    _, ct, msg, _, _, tm, _, const_t = model_pair(n, predictor="MLPCAT")
    tm.eval()
    with torch.no_grad():
        h = tlpm.encode_all(tm, const_t)
        edges = msg.T[:1000]
        whole = tm.predict_pairs(h[edges[:, 0]], h[edges[:, 1]])
        for chunk in (7, 64, 1000, 5000):
            np.testing.assert_allclose(
                tlpm.predict_chunked(tm, h, edges, chunk=chunk).numpy(),
                whole.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# edge-level label propagation
# ---------------------------------------------------------------------------


def _elp_setup(m=400, n=300):
    rng = np.random.default_rng(11)
    msg = msg_graph(n)
    scored = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], axis=1)
    scored[5] = scored[0]  # a duplicate, for the xmc dedup
    logits = rng.normal(size=m).astype(np.float32)
    h = rng.normal(size=(n, 8)).astype(np.float32)
    return n, msg, scored, logits, h


def test_build_edge_graph_equals_the_jax_numpy_path():
    _, _, scored, _, _ = _elp_setup()
    got = telp.build_edge_graph(scored)
    want = jelp.build_edge_graph(scored)  # C++ or numpy: the same pairs
    np.testing.assert_array_equal(np.unique(got, axis=1), np.unique(want, axis=1))
    assert got.shape == want.shape


@pytest.mark.parametrize("mode", ["logit", "emb", "xmc"])
def test_edge_lp_matches_jax(mode):
    n, msg, scored, logits, h = _elp_setup()
    if mode == "logit":
        got = telp.run_logit_lp(scored, torch.from_numpy(logits), 100, 250,
                                max_degree=None)
        want = jelp.run_logit_lp(scored, jnp.asarray(logits), 100, 250,
                                 max_degree=None)
    elif mode == "emb":
        got = telp.run_emb_lp(scored, torch.from_numpy(h), max_degree=None)
        want = jelp.run_emb_lp(scored, jnp.asarray(h), max_degree=None)
    else:
        got = telp.run_xmc_lp(msg, n, scored, torch.from_numpy(logits), 100,
                              250, col_chunk=64)
        want = jelp.run_xmc_lp(msg, n, scored, jnp.asarray(logits), 100, 250,
                               col_chunk=64)
        assert got[5] == got[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["logit", "emb", "xmc"])
def test_evaluate_with_edge_lp_matches_jax(mode):
    n = 300
    cj, ct, msg, jm, params, tm, const_j, const_t = model_pair(
        n, eval_metric="mrr", edge_lp_mode=mode)
    split_edge = _split(n, msg)
    edges = np.concatenate([split_edge[s][k] for s in ("train", "valid", "test")
                            for k in ("edge", "edge_neg") if k in split_edge[s]])
    # no node reaches max_degree = 256 incident scored edges: both packages
    # keep every incidence (the C++ subsample of the JAX side draws otherwise)
    assert np.bincount(edges.reshape(-1)).max() < 256
    want = jlpm.evaluate(cj, jm, params, const_j, split_edge,
                         *_jax_eval_fns(jm, params))
    got = tlpm.evaluate(ct, tm, const_t, split_edge)
    np.testing.assert_allclose(got["MRR"], want["MRR"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoder", ["CN", "AA", "PPR"])
def test_heuristic_short_circuit_equals_jax(encoder):
    n = 300
    msg = msg_graph(n)
    split_edge = _split(n, msg)
    kw = dict(encoder=encoder, eval_metric="mrr")
    want = jlpm.train_linkpred(jlpm.LinkPredConfig(**kw), None, msg, n,
                               split_edge=split_edge)
    got = tlpm.train_linkpred(tlpm.LinkPredConfig(**kw), None, msg, n,
                              split_edge=split_edge, device="cpu")
    assert got["params"] is None and got["stats"].keys() == want["stats"].keys()
    for k, v in want["stats"].items():  # the best-by-valid MRR means
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-6, err_msg=k)


TRAIN_CASES = [
    dict(neg_sampler="global"),
    dict(neg_sampler="local", eval_metric="hits"),
    dict(neg_sampler="global_perm", eval_metric="mrr"),
    dict(neg_sampler="local", max_steps_per_epoch=2),
    dict(neg_sampler="global_perm", dropout=0.5),
    dict(neg_sampler="global", optimizer="AdamW"),
]


@pytest.mark.parametrize("kw", TRAIN_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_train_linkpred_runs_and_learns(kw):
    """Whole runs on the CPU: finite statistics and per-epoch times, and a
    train loss that falls (the random streams are the port's own)."""
    kw = dict(kw)
    cap = kw.pop("max_steps_per_epoch", None)
    n = 300
    msg = msg_graph(n)
    split_edge = _split(n, msg)
    cfg = tlpm.LinkPredConfig(batch_size=256, lr=0.01, emb_hidden_channels=H,
                              gnn_hidden_channels=H, mlp_hidden_channels=H,
                              **kw)
    out = tlpm.train_linkpred(cfg, None, msg, n, epochs=3, runs=2,
                              split_edge=split_edge, max_steps_per_epoch=cap,
                              device="cpu")
    assert set(out["stats"]) == {"valid_mean", "valid_std", "test_mean",
                                 "test_std"}
    assert all(np.isfinite(v) for v in out["stats"].values()), out["stats"]
    assert len(out["epoch_s"]) == 6 and len(out["logger"].results[1]) == 3
    assert out["params"]["node_emb"].shape == (n, H)


@pytest.mark.parametrize("kw", [dict(), dict(use_node_feats=True, encoder="Transformer",
                                          train_node_emb=False)],
                         ids=["node_emb", "Transformer"])
def test_train_linkpred_refuses_a_mesh(kw):
    """Sharded (``comm=``, the JAX package's ``mesh=``) link prediction
    refuses a trainable node embedding (the default config) and the
    Transformer encoder, as the JAX package asserts."""
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm

    x = np.zeros((50, F), np.float32)
    with pytest.raises(ValueError, match="sharded link prediction"):
        tlpm.train_linkpred(tlpm.LinkPredConfig(**kw), x, msg_graph(50), 50,
                            comm=Comm(0, 1, "cpu", "gloo"), device="cpu")


def test_i2gtl_cli_prints_the_stats_line():
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_tail_generalization_tpu_torch.main",
         "--exp_mode=I2_GTL", "--task=linkp", "--device=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    stats = json.loads(lines[-1])
    assert set(stats) == {"valid_mean", "valid_std", "test_mean", "test_std"}
    assert all(np.isfinite(v) for v in stats.values()), stats


def test_i2gtl_cli_refuses_raw_ogbl_files(tmp_path, capsys):
    """Raw ogbl-citation2 files under --data_root are read now
    (data/ogb.py:load_ogbl_graph) and go through the i2t surgery; the CLI
    prints the stats line without the stand-in's note."""
    import gzip

    rng = np.random.default_rng(0)
    n = 400
    raw = tmp_path / "ogbl_citation2" / "raw"
    raw.mkdir(parents=True)

    def save(name, arr, fmt):
        with gzip.open(raw / name, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    save("edge.csv.gz", fast_powerlaw_graph(n, 3000, 1).T, "%d")
    save("node-feat.csv.gz", rng.normal(size=(n, 8)), "%.5f")
    save("node_year.csv.gz", rng.integers(2010, 2020, (n, 1)), "%d")
    stats = tmain.main(["--exp_mode=I2_GTL", "--task=linkp", "--device=cpu",
                        f"--data_root={tmp_path}"])[0]
    out = capsys.readouterr().out
    assert "NOTE: no ogbl raw files" not in out
    assert json.loads(out.splitlines()[-1]) == stats
    assert all(np.isfinite(v) for v in stats.values()), stats
