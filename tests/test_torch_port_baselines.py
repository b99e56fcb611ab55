"""The PyTorch port's self-supervised baselines against the JAX package's.

Small graphs (``tests/test_baselines.py``'s ring and a 50-node random graph,
through the loader pipeline) on both routes of the aggregation: ``dense``
(the graph carries ``dense_adj``) and ``csr`` (``with_dense=False``: the
JAX package's gather, the port's CSR kernel, whose plain version runs on
the CPU). Inputs come from numpy seeds; flax parameters and batch
statistics are carried across with ``baseline_params_from_jax``; random
inputs (permutations, ego flows, VGAE's batch and noise) are fixed and fed
to both. Tolerances: losses and embeddings 1e-5 relative, gradients 1e-4
(max-relative per tensor), the MI measures 1e-6; the host copies are exact.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu.baselines import api as japi
from gnn_tail_generalization_tpu.baselines import dgi as jdgi
from gnn_tail_generalization_tpu.baselines import egi as jegi
from gnn_tail_generalization_tpu.baselines import egi_bound as jbound
from gnn_tail_generalization_tpu.baselines import encoders as jenc
from gnn_tail_generalization_tpu.baselines import mi as jmi
from gnn_tail_generalization_tpu.baselines import pretrain_gin as jgin
from gnn_tail_generalization_tpu.baselines import structure_pretrain as jsp
from gnn_tail_generalization_tpu.baselines import vgae as jvgae
from gnn_tail_generalization_tpu.graph import core as jcore

from gnn_tail_generalization_tpu_torch.baselines import api as tapi
from gnn_tail_generalization_tpu_torch.baselines import dgi as tdgi
from gnn_tail_generalization_tpu_torch.baselines import egi as tegi
from gnn_tail_generalization_tpu_torch.baselines import egi_bound as tbound
from gnn_tail_generalization_tpu_torch.baselines import encoders as tenc
from gnn_tail_generalization_tpu_torch.baselines import mi as tmi
from gnn_tail_generalization_tpu_torch.baselines import pretrain_gin as tgin
from gnn_tail_generalization_tpu_torch.baselines import structure_pretrain as tsp
from gnn_tail_generalization_tpu_torch.baselines import vgae as tvgae
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.utils.convert import baseline_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ROUTES = ("dense", "csr")


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def ring(n=60, extra=80, seed=0):
    """tests/test_baselines.py's ring with random chords."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, extra)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, extra)])
    return np.stack([src, dst])


def random_graph(n=50, m=200, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, m), rng.integers(0, n, m)])


GRAPHS = {"ring": (ring, 60), "random50": (random_graph, 50)}


@dataclasses.dataclass
class Case:
    e: np.ndarray  # the pipeline's edges
    n: int
    jg: object  # the JAX Graph
    tg: tcore.Graph
    x: np.ndarray


def case(route, graph="ring", feat=10, seed=2) -> Case:
    make, n = GRAPHS[graph]
    e = jcore.standard_pipeline(make(), n)
    dense = route == "dense"
    x = np.random.default_rng(seed).normal(size=(n, feat)).astype(np.float32)
    return Case(e, n, jcore.build_graph(e, n, with_dense=dense),
                tcore.build_graph(e, n, with_dense=dense), x)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def init(model, *args, **kw):
    return jax.jit(lambda *a: model.init({"params": jax.random.PRNGKey(0)}, *a, **kw))(*args)


def jax_step(model, variables, *args, **kw):
    """Loss, flat gradients and flat new batch statistics of one train-mode
    apply of ``model``."""
    bs = variables.get("batch_stats")

    def f(p):
        vs = {"params": p} if bs is None else {"params": p, "batch_stats": bs}
        out, nv = model.apply(vs, *args, **kw,
                              mutable=["batch_stats"] if bs is not None else [])
        return out, nv.get("batch_stats") if bs is not None else None

    (loss, new_bs), grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    return float(loss), flat({"params": grads}), (
        {} if new_bs is None else flat({"batch_stats": new_bs}))


def port(module, variables):
    """``module`` holding the flax ``variables``."""
    module.load_state_dict(baseline_params_from_jax(flat(variables), module))
    return module


def torch_step(module, *args):
    module.train()
    module.zero_grad(set_to_none=True)
    loss = module(*args)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in module.named_parameters()}


def _zero_grad(name):
    """Parameters whose gradient is zero up to rounding, in either package:
    a GIN layer's second Dense bias feeds a train-mode batch norm (ROADMAP
    C), and a centrality scorer's bias cancels in s[u] - s[v]."""
    return name.endswith("dense.1.bias") or (
        name.startswith("cent_decoders.") and name.endswith(".bias"))


def assert_grads(module, got, grads_j, bs_j):
    """Every parameter gradient of ``module`` against the flax gradients
    (GRAD_TOL max-relative); the ``_zero_grad`` ones rounding-level in both."""
    want = baseline_params_from_jax({**grads_j, **bs_j}, module)
    scale = max(float(w.abs().max()) for k, w in want.items() if k in got)
    assert set(got) <= set(want)
    for k, g in got.items():
        if g is None:  # unused in the loss (EGI's fc_m at 2 hops): flax's zeros
            assert not want[k].any(), k
        elif _zero_grad(k):
            assert float(g.abs().max()) <= 1e-5 * scale, k
            assert float(want[k].abs().max()) <= 1e-5 * scale, k
        else:
            assert rel(g.numpy(), want[k].numpy()) <= GRAD_TOL, (k, rel(g, want[k]))


def assert_stats(module, bs_j):
    """The running statistics of ``module`` against flax's batch_stats."""
    sd = module.state_dict()
    assert bs_j
    for path, arr in bs_j.items():
        name = _buffer_name(module, path)
        assert rel(sd[name].numpy(), arr) <= LOSS_TOL, (name, rel(sd[name], arr))


def _buffer_name(module, path):
    from gnn_tail_generalization_tpu_torch.utils.convert import _port_name

    return _port_name(module, path.removeprefix("batch_stats/").split("/"))[0]


# --------------------------------------------------------------------------
# MI measures and MINE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("measure", tmi.MEASURES)
def test_mi_measures_match(measure):
    rng = np.random.default_rng(3)
    p = rng.normal(size=(7, 5)).astype(np.float32) * 2
    q = rng.normal(size=(7, 5)).astype(np.float32) * 2
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    for avg in (True, False):
        np.testing.assert_allclose(
            tmi.positive_expectation(pt, measure, avg).numpy(),
            np.asarray(jmi.positive_expectation(jnp.asarray(p), measure, avg)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tmi.negative_expectation(qt, measure, avg).numpy(),
            np.asarray(jmi.negative_expectation(jnp.asarray(q), measure, avg)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tmi.fenchel_dual_loss(pt, qt, measure).item(),
        float(jmi.fenchel_dual_loss(jnp.asarray(p), jnp.asarray(q), measure)),
        rtol=1e-6, atol=1e-6)
    if measure == "DV":  # a scalar logsumexp whatever ``average`` is
        assert tmi.negative_expectation(qt, measure, average=False).dim() == 0


def test_mine_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(9, 6)).astype(np.float32)
    y = rng.normal(size=(9, 3)).astype(np.float32)
    jm = jmi.Mine(hidden=16)
    vs = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    tm = port(tmi.Mine(9, hidden=16), vs)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert rel(got, jm.apply(vs, jnp.asarray(x), jnp.asarray(y))) <= LOSS_TOL


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------

LAYERS = {
    "GIN": (lambda: jenc.GINLayer(8), lambda f: tenc.GINLayer(f, 8), True),
    "MeanSAGE": (lambda: jenc.MeanSAGELayer(8), lambda f: tenc.MeanSAGELayer(f, 8), False),
    "GCNSAGE": (lambda: jenc.GCNSAGELayer(8, activation=False),
                lambda f: tenc.GCNSAGELayer(f, 8, activation=False), False),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_encoder_layer_matches_flax(route, layer):
    """Forward (train mode), the gradient of every parameter and of the
    input (the backward SpMM), and GIN's moved batch statistics."""
    c = case(route)
    make_j, make_t, has_bn = LAYERS[layer]
    cot = np.random.default_rng(5).normal(size=(c.n, 8)).astype(np.float32)
    jl = make_j()
    kw = {"train": True} if has_bn else {}
    vs = init(jl, c.jg, jnp.asarray(c.x), **kw)
    bs = vs.get("batch_stats")

    def f(p, h):
        v = {"params": p} if bs is None else {"params": p, "batch_stats": bs}
        out, nv = jl.apply(v, c.jg, h, **kw, mutable=["batch_stats"] if has_bn else [])
        return jnp.sum(out * cot), (out, nv)

    (_, (out_j, nv_j)), (gp_j, gx_j) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        vs["params"], jnp.asarray(c.x))
    tl = port(make_t(c.x.shape[1]), vs)
    tl.train()
    xt = torch.from_numpy(c.x).requires_grad_()
    out = tl(c.tg, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel(out.detach().numpy(), out_j) <= LOSS_TOL
    assert rel(xt.grad.numpy(), gx_j) <= GRAD_TOL
    bs_j = flat({"batch_stats": nv_j["batch_stats"]}) if has_bn else {}
    assert_grads(tl, {k: p.grad for k, p in tl.named_parameters()},
                 flat({"params": gp_j}), bs_j)
    if has_bn:
        assert_stats(tl, bs_j)


# --------------------------------------------------------------------------
# DGI, EGI, VGAE
# --------------------------------------------------------------------------


def _perm(n, seed=6):
    return np.random.default_rng(seed).permutation(n)


@pytest.mark.parametrize("route", ROUTES)
def test_dgi_loss_grads_and_running_stats_match(route):
    """Loss and gradients with a fixed perm, and the running statistics
    after the step's two encoder passes (clean, then corrupted)."""
    c = case(route)
    perm = _perm(c.n)
    jm = jdgi.DGI(16)
    vs = init(jm, c.jg, jnp.asarray(c.x), jnp.asarray(perm), train=True)
    loss_j, grads_j, bs_j = jax_step(jm, vs, c.jg, jnp.asarray(c.x), jnp.asarray(perm),
                                     train=True)
    tm = port(tdgi.DGI(c.x.shape[1], 16), vs)
    loss_t, grads_t = torch_step(tm, c.tg, torch.from_numpy(c.x), torch.from_numpy(perm))
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    assert_grads(tm, grads_t, grads_j, bs_j)
    assert_stats(tm, bs_j)
    # one pass moves them less: both passes are in the statistics
    one = port(tdgi.DGI(c.x.shape[1], 16), vs).train()
    one.embed(c.tg, torch.from_numpy(c.x))
    assert not torch.equal(one.state_dict()["encoder.layers.0.bn.running_mean"],
                           tm.state_dict()["encoder.layers.0.bn.running_mean"])


def _flows(c, seed=7, n_seeds=8, hops=2, fanout=3):
    """The same ego flows from both samplers (one numpy state each)."""
    seeds = np.random.default_rng(seed).choice(c.n, size=n_seeds, replace=False)
    jf = jegi.sample_ego_flows(c.e, c.n, seeds, hops, fanout, np.random.default_rng(seed))
    tf = tegi.sample_ego_flows(c.tg.indptr.numpy(), c.tg.indices.numpy(), seeds, hops,
                               fanout, np.random.default_rng(seed))
    return jf, tf


@pytest.mark.parametrize("route", ROUTES)
def test_egi_loss_and_grads_match(route):
    c = case(route)
    jf, tf = _flows(c)
    perm = _perm(c.n)
    jm = jegi.EGI(16)
    args_j = (c.jg, jnp.asarray(c.x), jf, jnp.asarray(perm))
    vs = init(jm, *args_j, train=True)
    loss_j, grads_j, bs_j = jax_step(jm, vs, *args_j, train=True)
    tm = port(tegi.EGI(c.x.shape[1], 16), vs)
    loss_t, grads_t = torch_step(tm, c.tg, torch.from_numpy(c.x), tf,
                                 torch.from_numpy(perm))
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    assert_grads(tm, grads_t, grads_j, bs_j)
    assert_stats(tm, bs_j)


def test_egi_rejects_dv():
    with pytest.raises(ValueError, match="per-sample"):
        tegi.EGI(4, 8, measure="DV")


@pytest.mark.parametrize("route", ROUTES)
def test_vgae_loss_and_grads_match(route):
    """A fixed batch, and JAX's own reparameterisation noise fed to the port."""
    c = case(route)
    bidx = _perm(c.n, seed=8)[:24]
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (c.n, 8)))
    jm = jvgae.VGAE(16, 8)
    args_j = (c.jg, jnp.asarray(c.x), key, jnp.asarray(bidx))
    vs = init(jm, *args_j)
    loss_j, grads_j, _ = jax_step(jm, vs, *args_j)
    tm = port(tvgae.VGAE(c.x.shape[1], 16, 8), vs)
    loss_t, grads_t = torch_step(tm, c.tg, torch.from_numpy(c.x), torch.from_numpy(bidx),
                                 torch.from_numpy(noise))
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    assert_grads(tm, grads_t, grads_j, {})
    sub_j = np.asarray(jvgae._sub_adjacency(c.jg, jnp.asarray(bidx)))
    np.testing.assert_array_equal(
        tvgae.sub_adjacency(c.tg, torch.from_numpy(bidx)).numpy(), sub_j)
    assert sub_j.sum() > 0


# --------------------------------------------------------------------------
# GIN pretraining and structural pretraining
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("masked", [False, True])
def test_masking_gin_matches(route, masked):
    c = case(route, "random50")
    labels = np.minimum(np.bincount(c.e[1], minlength=c.n), 31).astype(np.int32)
    mask = (np.random.default_rng(10).random(c.n) < 0.4) if masked else None
    jm = jgin.MaskingGIN(16)
    args_j = (c.jg, jnp.asarray(c.x), jnp.asarray(labels),
              None if mask is None else jnp.asarray(mask))
    vs = init(jm, *args_j, train=True)
    loss_j, grads_j, bs_j = jax_step(jm, vs, *args_j, train=True)
    tm = port(tgin.MaskingGIN(c.x.shape[1], 16), vs)
    loss_t, grads_t = torch_step(tm, c.tg, torch.from_numpy(c.x), torch.from_numpy(labels),
                                 None if mask is None else torch.from_numpy(mask))
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    assert_grads(tm, grads_t, grads_j, bs_j)


def _context_batch(c, n_centers=12):
    centers = np.random.default_rng(11).choice(c.n, size=n_centers, replace=False)
    kw = dict(l1=1, l2=3, k_sub=2, max_nodes=16)
    jb = jgin.build_context_graphs(c.e, c.n, centers, rng=np.random.default_rng(12), **kw)
    tb = tgin.build_context_graphs(c.e, c.n, centers, rng=np.random.default_rng(12), **kw)
    return centers, jb, tb


@pytest.mark.parametrize("route", ROUTES)
def test_contextpred_gin_matches(route):
    """The same context batch (the builders are held equal below)."""
    c = case(route, "random50")
    centers, jb, tb = _context_batch(c)
    jm = jgin.ContextPredGIN(16)
    args_j = (c.jg, jnp.asarray(c.x), *jb, jnp.asarray(centers, jnp.int32))
    vs = init(jm, *args_j, train=True)
    loss_j, grads_j, bs_j = jax_step(jm, vs, *args_j, train=True)
    tm = port(tgin.ContextPredGIN(c.x.shape[1], 16), vs)
    loss_t, grads_t = torch_step(tm, c.tg, torch.from_numpy(c.x), *tb,
                                 torch.from_numpy(centers))
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    assert_grads(tm, grads_t, grads_j, bs_j)


def _struct_inputs(c, rng):
    keep = rng.random(c.e.shape[1]) > 0.3
    link_edges = np.stack([rng.integers(0, c.n, 32), rng.integers(0, c.n, 32)], axis=1)
    link_labels = rng.integers(0, 2, 32)
    cents = jsp.compute_centralities(c.e, c.n)
    pairs = np.stack([rng.integers(0, c.n, 32), rng.integers(0, c.n, 32)], axis=1)
    cent_labels = (cents[pairs[:, 0]] > cents[pairs[:, 1]]).astype(np.int32)
    return keep, (link_edges, link_labels, pairs, cent_labels)


@pytest.mark.parametrize("route", ROUTES)
def test_struct_feat_pretrain_matches(route):
    c = case(route, "random50", feat=12)
    keep, arrays = _struct_inputs(c, np.random.default_rng(13))
    dense = route == "dense"
    jgm = jcore.build_graph(c.e[:, keep], c.n, with_dense=dense)
    tgm = tcore.build_graph(c.e[:, keep], c.n, with_dense=dense)
    jm = jsp.StructFeatPretrain(hidden_dim=16, num_layers=2)
    args_j = (c.jg, jgm, jnp.asarray(c.x), *map(jnp.asarray, arrays))
    vs = init(jm, *args_j, train=True)
    loss_j, grads_j, bs_j = jax_step(jm, vs, *args_j, train=True)
    tm = port(tsp.StructFeatPretrain(c.x.shape[1], 16), vs)
    loss_t, grads_t = torch_step(tm, c.tg, tgm, torch.from_numpy(c.x),
                                 *map(torch.from_numpy, arrays))
    assert abs(loss_t - loss_j) <= LOSS_TOL * abs(loss_j)
    assert_grads(tm, grads_t, grads_j, bs_j)
    fresh = port(tsp.StructFeatPretrain(c.x.shape[1], 16), vs).eval()
    with torch.no_grad():  # eval mode: the init's running statistics
        emb = fresh.embed(c.tg, torch.from_numpy(c.x)).numpy()
    emb_j = jm.apply(vs, c.jg, jnp.asarray(c.x), train=False, method=jm.embed)
    assert rel(emb, emb_j) <= LOSS_TOL


def test_ntn_decoder_matches():
    rng = np.random.default_rng(14)
    u = rng.normal(size=(7, 8)).astype(np.float32)
    v = rng.normal(size=(7, 8)).astype(np.float32)
    jd = jsp.NTNDecoder(tensor_dim=4)
    vs = jd.init(jax.random.PRNGKey(0), jnp.asarray(u), jnp.asarray(v))
    td = port(tsp.NTNDecoder(8, tensor_dim=4), vs)
    ut, vt = torch.from_numpy(u).requires_grad_(), torch.from_numpy(v).requires_grad_()
    out = td(ut, vt)
    out.sum().backward()
    out_j, (gu, gv) = jax.value_and_grad(
        lambda a, b: jd.apply(vs, a, b).sum(), argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    assert out.shape == (7,)
    assert rel(out.sum().item(), out_j) <= LOSS_TOL
    assert rel(out.detach().numpy(), jd.apply(vs, jnp.asarray(u), jnp.asarray(v))) <= LOSS_TOL
    assert rel(ut.grad.numpy(), gu) <= GRAD_TOL and rel(vt.grad.numpy(), gv) <= GRAD_TOL


def test_flax_xavier_uniform_bound():
    """flax's fans for the NTN tensor [K, d, d]: (d + d) * K."""
    w = tsp.xavier_uniform((4, 8, 8), torch.Generator().manual_seed(0))
    limit = (6.0 / (16 * 4)) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit


# --------------------------------------------------------------------------
# trainers
# --------------------------------------------------------------------------


def _jax_dgi_perms(n, epochs, seed):
    """The permutations JAX's train_dgi draws (its key chain, dgi.py:52-85)."""
    k = jax.random.PRNGKey(seed)
    perms = []
    for _ in range(epochs):
        k, kk = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(kk, n)))
    return perms


@pytest.mark.parametrize("route", ROUTES)
def test_train_dgi_matches_jax(route):
    """3 epochs from the JAX init, with JAX's own permutations fed to the
    port. Every trained parameter matches, but the GIN layers' pre-batch-norm
    biases: their gradient is rounding noise (``_zero_grad``), which Adam
    turns into steps of up to lr of either sign, so each may drift by up to
    2 x epochs x lr between the packages, and with them the running means. The
    embeddings match in train mode (batch statistics, invariant to those
    biases) within 1e-5; the returned eval-mode ones carry the drift."""
    c = case(route)
    x = jnp.asarray(c.x)
    seed, epochs, lr = 0, 3, 1e-3
    k = jax.random.PRNGKey(seed)
    jm = jdgi.DGI(16)
    vs = jax.jit(lambda g, x, p: jm.init({"params": k}, g, x, p, train=True))(
        c.jg, x, jax.random.permutation(k, c.n))
    embs_j, params_j = jdgi.train_dgi(c.jg, x, hidden_dim=16, epochs=epochs, seed=seed,
                                      lr=lr)
    model = tdgi.DGI(c.x.shape[1], 16)
    state = baseline_params_from_jax(flat(vs), model)
    embs_t, best = tdgi.train_dgi(c.tg, c.x, hidden_dim=16, epochs=epochs, seed=seed,
                                  lr=lr, device="cpu", init_state=state,
                                  perms=_jax_dgi_perms(c.n, epochs, seed))
    assert embs_t.shape == (c.n, 16) and torch.isfinite(embs_t).all()
    want = baseline_params_from_jax(flat({**vs, "params": params_j}), model)
    for name, _ in model.named_parameters():
        if _zero_grad(name):
            # each package moves it by at most lr a step, either way
            assert float((best[name] - want[name]).abs().max()) <= 2 * epochs * lr, name
        else:
            assert rel(best[name].numpy(), want[name].numpy()) <= GRAD_TOL, name
    model.load_state_dict(best)
    model.train()
    with torch.no_grad():
        train_mode = model.embed(c.tg, torch.from_numpy(c.x)).numpy()
    train_mode_j, _ = jm.apply({"params": params_j, "batch_stats": vs["batch_stats"]},
                               c.jg, x, train=True, method=jm.embed,
                               mutable=["batch_stats"])
    assert rel(train_mode, train_mode_j) <= LOSS_TOL
    assert rel(embs_t.numpy(), embs_j) <= 2 * epochs * lr * 4


def test_train_dgi_early_stopping_keeps_the_best_epoch():
    """The embeddings are those of the state after the step with the lowest
    loss, its batch statistics included, not the last state's."""
    c = case("csr")
    stats = {}
    embs, best = tdgi.train_dgi(c.tg, c.x, hidden_dim=16, epochs=40, patience=3,
                                lr=0.05, device="cpu", stats=stats)
    losses = stats["loss"]
    b = stats["best_epoch"]
    assert b == int(np.argmin(losses)) and stats["epochs_run"] == len(losses)
    stopped = len(losses) < 40
    assert stopped and len(losses) == b + 1 + 3, (b, losses)
    model = tdgi.DGI(c.x.shape[1], 16)
    model.load_state_dict(best)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model.embed(c.tg, torch.from_numpy(c.x)), embs)
    # the eval embeddings read the running statistics: one more train-mode
    # pass moves them, and the embeddings with them
    model.train()
    with torch.no_grad():
        model.embed(c.tg, torch.from_numpy(c.x))
    model.eval()
    with torch.no_grad():
        assert not torch.equal(model.embed(c.tg, torch.from_numpy(c.x)), embs)


@pytest.mark.parametrize("alg", ["DGI", "EGI", "VGAE"])
def test_gen_baseline_embs_structure(alg):
    """What cannot match bit for bit (the device draws): finite embeddings
    of the right shape, on both graph routes (dense at <= 4,096 nodes)."""
    stats = {}
    embs = tapi.gen_baseline_embs(ring(), 60, alg, epochs=5, hidden_dim=16,
                                  device="cpu", stats=stats)
    assert embs.shape == (60, 32 if alg == "VGAE" else 16) and np.isfinite(embs).all()
    assert stats["epochs_run"] >= 1 and {"pipeline_s", "build_s"} <= stats.keys()
    big = random_graph(4200, 9000, seed=3)
    embs = tapi.gen_baseline_embs(big, 4200, alg, epochs=2, hidden_dim=8, device="cpu")
    assert embs.shape[0] == 4200 and np.isfinite(embs).all()


@pytest.mark.parametrize("variant", ["masking", "contextpred"])
def test_train_pretrain_gin_runs(variant):
    c = case("csr", "random50")
    stats = {}
    embs, state = tgin.train_pretrain_gin(c.tg, c.x, variant, hidden_dim=16, epochs=4,
                                          device="cpu", stats=stats)
    assert embs.shape == (50, 16) and torch.isfinite(embs).all()
    assert len(stats["loss"]) == 4 and np.isfinite(stats["loss"]).all()
    assert (variant == "contextpred") == ("context_s" in stats)


# --------------------------------------------------------------------------
# host copies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sample_ego_flows_matches_jax(graph):
    """From the graph's CSR, and from an edge list through host_csr: the
    JAX sampler's src/dst/mask exactly, for the same generator state."""
    c = case("csr", graph)
    for hops, fanout in ((2, 3), (3, 2)):
        jf, tf = _flows(c, hops=hops, fanout=fanout)
        ip, src = tegi.host_csr(c.e, c.n)
        seeds = np.random.default_rng(7).choice(c.n, size=8, replace=False)
        tf2 = tegi.sample_ego_flows(ip, src, seeds, hops, fanout, np.random.default_rng(7))
        for f in (tf, tf2):
            assert (f.hops, f.e_max) == (jf.hops, jf.e_max)
            for k in ("src", "dst", "mask"):
                np.testing.assert_array_equal(getattr(f, k).numpy(), np.asarray(getattr(jf, k)))
        assert tf.mask.sum() > 0


def test_train_egi_draws_the_jax_seeds_and_flows():
    """train_egi's host draws (seeds, then flows, per epoch) follow the JAX
    order: the first batch equals JAX's flows0."""
    c = case("csr")
    nprng = np.random.default_rng(0)
    seeds = nprng.choice(c.n, size=16, replace=False)
    jf = jegi.sample_ego_flows(c.e, c.n, seeds, 2, 3, nprng)
    stats = {}
    embs, _ = tegi.train_egi(c.tg, c.x, hidden_dim=12, epochs=3, batch_seeds=16, fanout=3,
                             device="cpu", stats=stats)
    assert embs.shape == (c.n, 12) and torch.isfinite(embs).all()
    assert len(stats["sample_s"]) == stats["epochs_run"]
    ip, src = c.tg.indptr.numpy(), c.tg.indices.numpy()
    nprng = np.random.default_rng(0)
    tf = tegi.sample_ego_flows(ip, src, nprng.choice(c.n, size=16, replace=False), 2, 3, nprng)
    np.testing.assert_array_equal(tf.dst.numpy(), np.asarray(jf.dst))
    # an edge list given to train_egi is sorted as the JAX sampler sorts it:
    # the graph's own edges give the same run
    again, _ = tegi.train_egi(c.tg, c.x, hidden_dim=12, epochs=3, batch_seeds=16, fanout=3,
                              edge_index=c.e, device="cpu")
    assert torch.equal(again, embs)


def test_build_context_graphs_matches_jax():
    c = case("csr", "random50")
    centers, jb, tb = _context_batch(c, n_centers=20)
    jug, tug = jb[0], tb[0]
    for a, b in zip(tb[1:], jb[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    e = jug.n_edge
    assert (tug.n_node, tug.n_edge) == (jug.n_node, e) and tug.dense_adj is None
    np.testing.assert_array_equal(tug.indices.numpy(), np.asarray(jug.senders)[:e])
    rows = np.repeat(np.arange(tug.n_node), np.diff(tug.indptr.numpy()))
    np.testing.assert_array_equal(rows, np.asarray(jug.receivers)[:e])


def test_degree_bucketing_and_centralities_match():
    c = case("csr", "random50")
    for md in (8, 32):
        np.testing.assert_array_equal(tapi.degree_bucketing(c.e, c.n, md),
                                      japi.degree_bucketing(c.e, c.n, md))
    np.testing.assert_array_equal(tsp.compute_centralities(c.e, c.n),
                                  jsp.compute_centralities(c.e, c.n))


def _without_docstring(path):
    tree = ast.parse(open(path).read())
    return ast.unparse(ast.Module(body=tree.body[1:], type_ignores=[]))


def test_egi_bound_copy_matches_the_original():
    """baselines/egi_bound.py is a copy: the code after the docstring is the
    original's, and so is its value."""
    port_path = os.path.join(REPO, "gnn_tail_generalization_tpu_torch", "baselines",
                             "egi_bound.py")
    orig = os.path.join(REPO, "gnn_tail_generalization_tpu", "baselines", "egi_bound.py")
    assert _without_docstring(port_path) == _without_docstring(orig)
    a, b = ring(), ring(60, extra=400, seed=5)
    assert tbound.egi_bound(a, 60, b, 60, n_pairs=8) == jbound.egi_bound(a, 60, b, 60, n_pairs=8)


# --------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# --------------------------------------------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device, the entry points called without ``device``
    raise; they never return a CPU result."""
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.data.datasets import prepare
    from gnn_tail_generalization_tpu_torch.data.synthetic import synthetic_planetoid
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.train import loops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build_config(dataset="", train_which="TeacherGNN", N_nodes=80, num_feats=12,
                       num_classes=3, dim_hidden=8)
    pd = prepare(synthetic_planetoid(n_node=80, n_feat=12, n_class=3, seed=0), cfg)
    calls = {
        "train_teacher": lambda: loops.train_teacher(cfg, pd, epochs=1),
        "run_experiment": lambda: loops.run_experiment(cfg, pd, epochs=1),
        "train_linkpred": lambda: lpm.train_linkpred(
            lpm.LinkPredConfig(gnn_hidden_channels=8), None, ring(), 60, epochs=1),
        "gen_baseline_embs": lambda: tapi.gen_baseline_embs(ring(), 60, "DGI", epochs=1),
        "train_dgi": lambda: tdgi.train_dgi(case("csr").tg, case("csr").x, epochs=1),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
