"""The port's Cold Brew student path against the JAX package's.

Module by module (MLP, BlockResMLP, latent_neighbor_replace, SEMLP parts 1
and 2, StudentBaseMLP, GraphMLP and its NContrast loss, the adjacency power,
collect_teacher_se): the same seed-made numpy inputs and flax -> torch
transplanted weights through both packages, forward values and gradients to
rtol 1e-4 / atol 1e-5 unless a case says otherwise. Dropout is 0 in train
mode, as random streams differ between the frameworks. Then the slice as a
whole: one part-1 and one part-2 Adam step on the same batch against optax,
and ``run_experiment("SEMLP")`` through both packages, compared by columns,
shapes, finiteness and a falling part-1 MSE (whole loops draw different
batches, so they are not compared value by value)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.models import semlp as jsemlp
from gnn_tail_generalization_tpu.models.teacher import TeacherGNN as JTeacher
from gnn_tail_generalization_tpu.nn import mlp as jmlp
from gnn_tail_generalization_tpu.ops.topk_attention import (
    latent_neighbor_replace as jreplace)
from gnn_tail_generalization_tpu.train import loops as jloops
from gnn_tail_generalization_tpu.train.optim import make_optimizer as jmake_optimizer

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.models import semlp
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.nn.mlp import MLP, BlockResMLP
from gnn_tail_generalization_tpu_torch.ops import _build, topk_kernels
from gnn_tail_generalization_tpu_torch.ops.topk_attention import (
    latent_neighbor_replace, top_k_lowest_index)
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.train.optim import make_optimizer
from gnn_tail_generalization_tpu_torch.utils.convert import (
    params_from_jax, state_dict_from_flax)

TOL = dict(rtol=1e-4, atol=1e-5)
N, F_, C, SE = 60, 12, 4, 16


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


def configs(**kw):
    """The same config through both packages' build_config."""
    base = dict(dataset="", train_which="SEMLP", N_nodes=N, num_feats=F_,
                num_classes=C, dim_hidden=8, dropout=0.0, dropout_MLP=0.0,
                type_trick="InitialBatchNorm", whetherHasSE="111", se_reg=0.5,
                lr=0.01, weight_decay=5e-4)
    base.update(kw)
    return jcfg.build_config(**base), tcfg.build_config(**base)


def prepared(rng, cj, ct, n=N, **data_kw):
    """Same host data through both packages' prepare (sparse graph path)."""
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    arrays = dict(
        x=rng.normal(size=(n, F_)).astype(np.float32),
        y=rng.integers(0, C, n), edge_index=np.stack([src, dst]),
        train_mask=np.arange(n) < n // 2, val_mask=None,
        test_mask=np.arange(n) >= n // 2, name="port-parity")
    arrays.update(data_kw)
    jp = jds.prepare(jds.NodeData(**arrays), cj, spmm_dense_threshold=n // 2)
    tp = tds.prepare(tds.NodeData(**arrays), ct, spmm_dense_threshold=n // 2)
    return jp, tp


def init(jmod, *args, seed=1):
    """flax parameters of ``jmod`` for ``args`` (jitted: eager flax
    dispatches op by op)."""
    return jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(seed), *a))(
        *args)["params"]


def grads_match(tmod, jgrads):
    """Every parameter gradient of ``tmod`` equals the flax gradients."""
    want = state_dict_from_flax(flat(jgrads), tmod)
    got = {k: p.grad for k, p in tmod.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        g = got[k] if got[k] is not None else torch.zeros_like(want[k])
        close(g, want[k], err_msg=k, **TOL)


def check_against_flax(jmod, tmod, jargs, targs, train, rng):
    """Forward values and gradients of sum(out * w) for random w."""
    params = init(jmod, *jargs)
    tmod.load_state_dict(state_dict_from_flax(flat(params), tmod))

    def apply(p):
        return jmod.apply({"params": p}, *jargs, train=train)

    w = rng.normal(size=jax.eval_shape(apply, params).shape).astype(np.float32)

    def loss(p):
        out = apply(p)
        return jnp.sum(out * w), out

    (_, out_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tmod.train(train)
    out_t = tmod(*targs)
    (out_t * torch.from_numpy(w)).sum().backward()
    close(out_t.detach(), out_j)
    grads_match(tmod, grads)


# ---------------------------------------------------------------------------
# nn/mlp.py
# ---------------------------------------------------------------------------

MLPS = [  # (case, input width, flax module, port module)
    ("mlp 4 widths", F_, lambda: jmlp.MLP([F_, 16, 8, 5], dropout=0.0),
     lambda: MLP([F_, 16, 8, 5], dropout=0.0)),
    ("mlp last_dropout", F_,
     lambda: jmlp.MLP([F_, 16, 5], dropout=0.0, last_dropout=True),
     lambda: MLP([F_, 16, 5], dropout=0.0, last_dropout=True)),
    ("mlp bare linear", F_, lambda: jmlp.MLP([F_, 5], dropout=0.0),
     lambda: MLP([F_, 5], dropout=0.0)),
    ("blockres no in_proj", F_, lambda: jmlp.BlockResMLP((F_, 5), 2, dropout=0.0),
     lambda: BlockResMLP((F_, 5), 2, dropout=0.0)),
    ("blockres both projs", F_,
     lambda: jmlp.BlockResMLP((F_, 5), 2, 3, dim_model=16, dropout=0.0),
     lambda: BlockResMLP((F_, 5), 2, skip_conn_period=3, dim_model=16,
                         dropout=0.0)),
    ("blockres no out_proj", 5, lambda: jmlp.BlockResMLP((5, F_), 3, dropout=0.0),
     lambda: BlockResMLP((5, F_), 3, dropout=0.0)),
]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,width,jmake,tmake", MLPS, ids=[m[0] for m in MLPS])
def test_mlp_matches_flax(rng, name, width, jmake, tmake, train):
    x = rng.normal(size=(9, width)).astype(np.float32)
    check_against_flax(jmake(), tmake(), (jnp.asarray(x),), (torch.from_numpy(x),),
                       train, rng)


def test_mlp_identity_and_widths(rng):
    x = torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))
    assert MLP([7])(x) is x and MLP([])(x) is x
    res = BlockResMLP((128, 40), 4)  # dim_model min(128, 256) = 128: no in_proj
    assert res.in_proj is None and res.out_proj.out_features == 40
    assert res.blocks[0].dense[0].out_features == int(128 * 1.5) + 2
    assert [b.last_dropout for b in res.blocks] == [True, True, True, False]
    assert res.blocks[0].norms[0].eps == 1e-6  # flax LayerNorm's


# ---------------------------------------------------------------------------
# ops/topk_attention.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,row_chunk,score_dtype", [
    (1, 8192, None), (2, 5, None), (3, 4, None), (2, 5, "bf16")])
def test_latent_neighbor_replace_matches_jax(rng, k, row_chunk, score_dtype):
    se = rng.normal(size=(N, SE)).astype(np.float32)
    guess = rng.normal(size=(17, SE)).astype(np.float32)  # 17 > row_chunk
    want = jreplace(jnp.asarray(guess), jnp.asarray(se), k, row_chunk=row_chunk,
                    score_dtype=jnp.bfloat16 if score_dtype else None)
    got = latent_neighbor_replace(
        torch.from_numpy(guess), torch.from_numpy(se), k, row_chunk=row_chunk,
        score_dtype=torch.bfloat16 if score_dtype else None)
    assert got.shape == (17, SE) and got.dtype == torch.float32
    close(got, want)


def lexsort_top_k(scores: np.ndarray, k: int):
    """numpy's (values, indices) of each row's K best: score descending,
    then index ascending (np.lexsort's last key is its first)."""
    idx = np.stack([np.lexsort((np.arange(row.size), -row))[:k] for row in scores])
    return np.take_along_axis(scores, idx, axis=1), idx


@pytest.mark.parametrize("neg_inf", [False, True], ids=["finite", "neg_inf"])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_latent_neighbor_replace_tie_breaking(k, neg_inf):
    """Exactly tied scores select the lowest index, as jax.lax.top_k does
    (tests/test_torch_parity_tricks.py:362): ``top_k_lowest_index`` (the
    plain version on the CPU) against numpy's lexsort and JAX on rows of
    many ties across the K-th place (and with -inf columns, as
    ``dist_latent_replace`` pads a shard's rows, some rows holding fewer
    than K finite scores); then the replacement on a chunk where only some
    rows tie."""
    rng = np.random.default_rng(k)
    scores = rng.integers(-3, 4, size=(24, 40)).astype(np.float32)
    if neg_inf:
        scores[rng.random(scores.shape) < 0.5] = -np.inf
        scores[0] = -np.inf
        scores[1, k - 1:] = -np.inf
    vals, idx = top_k_lowest_index(torch.from_numpy(scores), k)
    want_vals, want_idx = lexsort_top_k(scores, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(vals.numpy(), want_vals)
    np.testing.assert_array_equal(np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]),
                                  want_idx)

    se = np.zeros((12, 4), np.float32)
    se[:, 0] = 1.0  # every row scores 1 against guess row 0
    se[2, 1] = 5.0  # a distinguishable payload on row 2
    guess = np.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [2.0, 1.0, 0, 0]],
                       np.float32)
    got = latent_neighbor_replace(torch.from_numpy(guess),
                                  torch.from_numpy(se), k).numpy()
    close(got[0], se[:k].mean(axis=0), rtol=1e-5, atol=1e-6)  # the k lowest rows
    picked = [2, 0, 1, 3, 4, 5, 6, 7][:k]  # row 2, then the lowest of the tied
    top = np.asarray([5.0] + [0.0] * (k - 1))
    w = np.exp(top - top.max()) / np.exp(top - top.max()).sum()
    close(got[1], w @ se[picked], rtol=1e-5, atol=1e-6)
    close(got, jreplace(jnp.asarray(guess), jnp.asarray(se), k))


@pytest.mark.parametrize("shape,k,dtype,transposed,error", [
    ((4, 40), 33, torch.float32, False, ValueError),  # K above the kernel's 32
    ((4, 40), 0, torch.float32, False, ValueError),
    ((4, 40), 2, torch.float64, False, TypeError),
    ((4, 40), 2, torch.bfloat16, False, TypeError),
    ((40, 4), 2, torch.float32, True, ValueError),  # not contiguous
    ((4, 3), 4, torch.float32, False, ValueError),  # fewer columns than K
    ((4,), 2, torch.float32, False, ValueError),  # not 2-D
], ids=["k33", "k0", "f64", "bf16", "non_contiguous", "n_cols_below_k", "1d"])
def test_topk_kernel_argument_check_raises(shape, k, dtype, transposed, error):
    """The kernel's argument check, which needs no card, refuses what the
    kernel does not take; the CUDA route would raise there and never take
    the plain version."""
    scores = torch.zeros(shape, dtype=dtype)
    if transposed:
        scores = scores.T
    with pytest.raises(error):
        topk_kernels.check_rows(scores, k)


def test_topk_kernel_route_takes_only_cuda_tensors():
    """What the check accepts, and the kernel's wrapper raising on a device
    other than CUDA (no fallback), while ``top_k_lowest_index`` sends a CPU
    tensor to the plain version and no other."""
    for shape, k in (((4, 40), 32), ((1, 1), 1), ((3, 5), 5)):
        topk_kernels.check_rows(torch.zeros(shape), k)
    meta = torch.zeros(4, 40, device="meta")
    with pytest.raises(ValueError, match="no top-K kernel for device meta"):
        top_k_lowest_index(meta, 2)
    with pytest.raises(ValueError, match="no top-K kernel for device cpu"):
        topk_kernels.topk_rows_f32(torch.zeros(4, 40), 2)
    before = _build.launch_counts("topk")
    top_k_lowest_index(torch.randn(4, 40), 2)
    assert _build.launch_counts("topk") == before


# ---------------------------------------------------------------------------
# models/semlp.py
# ---------------------------------------------------------------------------


# the BlockResMLP archs keep their fixed dropout 0.1, so train mode (where
# random streams differ) is compared at dropout_MLP 0 for the MLP archs only
@pytest.mark.parametrize("arch,train", [
    ("2layer", False), ("2layer", True), ("3layer", False), ("3layer", True),
    ("residual", False)])
def test_semlp_part1_matches_flax(rng, arch, train):
    cj, ct = configs(SEMLP_part1_arch=arch)
    x = rng.normal(size=(9, F_)).astype(np.float32)
    check_against_flax(jsemlp.SEMLPPart1(cj, se_dim=SE), semlp.SEMLPPart1(ct, SE),
                       (jnp.asarray(x),), (torch.from_numpy(x),), train, rng)


PART2 = [("include part1out", {}),
         ("leave out part1out", {"SEMLP__include_part1out": False}),
         ("downgraded", {"SEMLP_topK_2_replace": -99}),
         ("StudentBaseMLP", {"train_which": "StudentBaseMLP",
                             "SEMLP_topK_2_replace": -99})]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,kw", PART2, ids=[p[0] for p in PART2])
def test_semlp_part2_matches_flax(rng, name, kw, train):
    if train and name == "StudentBaseMLP":
        train = False  # its BlockResMLP keeps dropout 0.1: eval mode twice
    cj, ct = configs(**kw)
    assert ct.SEMLP__downgrade_to_MLP == ("downgraded" in name or name == "StudentBaseMLP")
    x = rng.normal(size=(9, F_)).astype(np.float32)
    p1 = rng.normal(size=(9, SE)).astype(np.float32)
    table = rng.normal(size=(N, SE)).astype(np.float32)
    tmod = semlp.SEMLPPart2(ct, SE)
    check_against_flax(jsemlp.SEMLPPart2(cj), tmod,
                       tuple(map(jnp.asarray, (x, p1, table))),
                       tuple(map(torch.from_numpy, (x, p1, table))), train, rng)
    if not ct.SEMLP__downgrade_to_MLP:
        assert tmod.alphas.grad[1] != 0
        assert (tmod.alphas.grad[0] != 0) == ct.SEMLP__include_part1out


def test_semlp_part2_grad_flows_only_to_part2_and_alphas(rng):
    """Reference semantics (MLP_model/__init__.py:107-108): part 1's output
    is detached, so part-2 training leaves part 1's parameters untouched
    (the port of tests/test_training.py:146)."""
    _, ct = configs()
    x = torch.from_numpy(rng.normal(size=(32, F_)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(N, SE)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    p1, p2 = semlp.SEMLPPart1(ct, SE, gen).eval(), semlp.SEMLPPart2(ct, SE, gen).eval()
    (p2(x, p1(x), table) ** 2).sum().backward()
    assert all(p.grad is None or not p.grad.any() for p in p1.parameters())
    assert p2.alphas.grad.abs().max() > 0


def test_student_base_mlp_matches_flax(rng):
    cj, ct = configs(train_which="StudentBaseMLP", StudentMLP__dim_model=16,
                     studentMLP__skip_conn_T_and_res_blks="3&2")
    x = rng.normal(size=(9, F_)).astype(np.float32)
    tmod = semlp.StudentBaseMLP(ct)
    assert tmod.net.in_proj.out_features == 16 and len(tmod.net.blocks) == 2
    check_against_flax(jsemlp.StudentBaseMLP(cj), tmod, (jnp.asarray(x),),
                       (torch.from_numpy(x),), False, rng)


def test_neighbor_contrastive_loss_matches_jax(rng):
    z = rng.normal(size=(10, 6)).astype(np.float32)
    crop = (rng.random((10, 10)) < 0.4).astype(np.float32)
    crop[3] = 0.0  # a row whose numerator is 0: left out of the mean
    jl, jg = jax.jit(jax.value_and_grad(jsemlp.neighbor_contrastive_loss),
                     static_argnums=2)(jnp.asarray(z), jnp.asarray(crop), 2.0)
    zt = torch.from_numpy(z).requires_grad_()
    tl = semlp.neighbor_contrastive_loss(zt, torch.from_numpy(crop), 2.0)
    tl.backward()
    close(tl.item(), float(jl))
    close(zt.grad, jg)
    # zero-norm rows are guarded: finite, and equal to JAX's
    z[4] = 0.0
    got = semlp.cosine_sim(torch.from_numpy(z))
    assert torch.isfinite(got).all()
    close(got, jsemlp.cosine_sim(jnp.asarray(z)))


def test_graphmlp_matches_flax(rng):
    cj, ct = configs(train_which="GraphMLP")
    x = rng.normal(size=(10, F_)).astype(np.float32)
    crop = (rng.random((10, 10)) < 0.4).astype(np.float32)
    jmod, tmod = jsemlp.GraphMLP(cj), semlp.GraphMLP(ct).eval()
    params = init(jmod, jnp.asarray(x), seed=2)
    tmod.load_state_dict(state_dict_from_flax(flat(params), tmod))

    def loss(p):
        logits, z = jmod.apply({"params": p}, jnp.asarray(x))
        return (jnp.sum(logits ** 2)
                + jsemlp.neighbor_contrastive_loss(z, jnp.asarray(crop), 2.0))

    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    logits, z = tmod(torch.from_numpy(x))
    tl = (logits ** 2).sum() + semlp.neighbor_contrastive_loss(
        z, torch.from_numpy(crop), 2.0)
    tl.backward()
    close(tl.item(), float(jl))
    grads_match(tmod, jg)


# ---------------------------------------------------------------------------
# train/loops.py and utils/convert.py
# ---------------------------------------------------------------------------


def test_adj_pow_matches_jax(rng):
    cj, ct = configs(train_which="GraphMLP")
    jp, tp = prepared(rng, cj, ct)
    for r in (1, 3):
        a_j, a_t = jloops._sparse_adj_pow(jp, r), tloops._sparse_adj_pow(tp, r)
        np.testing.assert_array_equal(a_t.toarray(), a_j.toarray())
        np.testing.assert_array_equal(tloops._dense_adj_pow(tp, r), a_j.toarray())
    bidx = rng.integers(0, N, 7)
    np.testing.assert_array_equal(tloops.adj_pow_crop(a_t, bidx),
                                  jloops.adj_pow_crop(a_j, bidx))
    np.testing.assert_array_equal(tloops.adj_pow_crop(a_t, bidx),
                                  tloops._dense_adj_pow(tp, 3)[bidx][:, bidx])


@pytest.mark.parametrize("trick,se,se_dim", [("InitialBatchNorm", "111", 8 + 8),
                                             ("NoResNodeNorm", "100", 8 + C)])
def test_collect_teacher_se_matches_jax(rng, trick, se, se_dim):
    cj, ct = configs(type_trick=trick, whetherHasSE=se)
    jp, tp = prepared(rng, cj, ct)
    params = init(JTeacher(cj), jp.graph, jnp.asarray(jp.x), seed=3)
    want = jloops.collect_teacher_se(cj, jp, {"params": params})
    got = tloops.collect_teacher_se(ct, tp, params_from_jax(flat(params), ct),
                                   device="cpu")
    assert got.shape == (N, se_dim) and not got.requires_grad
    close(got, want)


def test_proj2class_head_matches_flax(rng):
    cj, ct = configs(train_which="TeacherGNN", has_proj2class=True)
    jp, tp = prepared(rng, cj, ct)
    model = JTeacher(cj)
    params = init(model, jp.graph, jnp.asarray(jp.x), seed=4)
    tm = TeacherGNN(ct).eval()
    tm.load_state_dict(params_from_jax(flat(params), ct))
    assert tuple(tm.proj2class.dense[0].weight.shape) == (20, 128)
    _, classi, _, _ = tm(tp.graph, torch.from_numpy(tp.x))
    want = jax.jit(lambda p, g, x: model.apply({"params": p}, g, x)[1])(
        params, jp.graph, jnp.asarray(jp.x))
    assert classi.shape == (N, C)
    close(classi.detach(), want)


def test_best_state_dict_is_the_best_epoch(rng):
    cj, ct = configs(dropout=0.5, lr=0.05)
    _, tp = prepared(rng, cj, ct)
    res = tloops.train_teacher(ct, tp, seed=1, epochs=8, device="cpu")
    best = int(np.argmax(res.records[:, res.columns.index("acc_test")]))
    again = tloops.train_teacher(ct, tp, seed=1, epochs=best + 1, device="cpu")
    for k, v in again.state_dict.items():
        assert torch.equal(res.best_state_dict[k], v), k
    if best < 7:  # a snapshot, not the live parameters Adam kept updating
        assert any(not torch.equal(res.best_state_dict[k], v)
                   for k, v in res.state_dict.items())
    plain = tloops.train_teacher(dataclasses.replace(ct, train_which="TeacherGNN"),
                                 tp, seed=1, epochs=2, device="cpu")
    assert plain.best_state_dict is plain.state_dict


def adam_step(loss, params, tx):
    """(loss, gradients, updated parameters) of one optax step."""
    @jax.jit
    def step(p):
        val, g = jax.value_and_grad(loss)(p)
        upd, _ = tx.update(g, tx.init(p), p)
        return val, g, optax.apply_updates(p, upd)

    return step(params)


def test_one_part1_and_part2_step_match_optax(rng):
    """One Adam step of each SEMLP phase from the same weights, on the same
    batch: loss, gradients and updated parameters."""
    cj, ct = configs()
    x = rng.normal(size=(N, F_)).astype(np.float32)
    y = rng.integers(0, C, N)
    table = rng.normal(size=(N, SE)).astype(np.float32)
    bidx = rng.integers(0, N, 24)
    xb, seb, yb = x[bidx], table[bidx], y[bidx]

    # part 1
    jp1 = jsemlp.SEMLPPart1(cj, se_dim=SE)
    params1 = init(jp1, jnp.asarray(xb), seed=5)
    tp1 = semlp.SEMLPPart1(ct, SE)
    tp1.load_state_dict(state_dict_from_flax(flat(params1), tp1))
    tx = jmake_optimizer(cj)

    def loss1(p):
        out = jp1.apply({"params": p}, jnp.asarray(xb), train=True)
        return jnp.mean((out - jnp.asarray(seb)) ** 2)

    l1, g1, new1 = adam_step(loss1, params1, tx)
    opt = make_optimizer(ct, tp1.parameters())
    tp1.train()
    tl1 = F.mse_loss(tp1(torch.from_numpy(xb)), torch.from_numpy(seb))
    tl1.backward()
    close(tl1.item(), float(l1))
    grads_match(tp1, g1)
    opt.step()
    for k, v in state_dict_from_flax(flat(new1), tp1).items():
        close(tp1.state_dict()[k], v, err_msg=k, **TOL)

    # part 2, part 1 in train mode at dropout 0 (with its updated weights)
    jp2 = jsemlp.SEMLPPart2(cj)
    p1_out = jax.jit(lambda p: jp1.apply({"params": p}, jnp.asarray(xb),
                                         train=True))(new1)
    params2 = init(jp2, jnp.asarray(xb), p1_out, jnp.asarray(table), seed=6)
    tp2 = semlp.SEMLPPart2(ct, SE)
    tp2.load_state_dict(state_dict_from_flax(flat(params2), tp2))

    def loss2(p):
        logits = jp2.apply({"params": p}, jnp.asarray(xb), p1_out,
                           jnp.asarray(table), train=True)
        lsm = jax.nn.log_softmax(logits, axis=1)
        return -jnp.mean(jnp.take_along_axis(lsm, jnp.asarray(yb)[:, None], 1))

    l2, g2, new2 = adam_step(loss2, params2, tx)
    opt = make_optimizer(ct, tp2.parameters())
    with torch.no_grad():
        tp1_out = tp1(torch.from_numpy(xb))
    close(tp1_out, p1_out)
    tl2 = F.cross_entropy(tp2(torch.from_numpy(xb), tp1_out, torch.from_numpy(table)),
                          torch.from_numpy(yb))
    tl2.backward()
    close(tl2.item(), float(l2))
    grads_match(tp2, g2)
    opt.step()
    for k, v in state_dict_from_flax(flat(new2), tp2).items():
        close(tp2.state_dict()[k], v, err_msg=k, **TOL)


def test_run_experiment_semlp_through_both(rng):
    cj, ct = configs(dropout=0.2, dropout_MLP=0.2)
    jp, tp = prepared(rng, cj, ct)
    res_j = jloops.run_experiment(cj, jp, seed=0, epochs=20)
    res_t = tloops.run_experiment(ct, tp, seed=0, epochs=20, device="cpu")
    assert res_t.columns == res_j.columns == [
        "loss_train", "acc_test", "head", "tail", "iso"]
    assert res_t.records.shape == res_j.records.shape == (20, 5)
    p1_j, p1_t = res_j.extra["part1"], res_t.extra["part1"]
    assert p1_t.columns == p1_j.columns == ["loss_train", "loss_test"]
    for rec in (res_t.records, res_j.records, p1_t.records, p1_j.records,
                res_t.extra["teacher"].records):
        assert np.isfinite(rec).all()
    for p1 in (p1_t, p1_j):  # part-1 train MSE falls over the 20 epochs
        assert p1.records[-5:, 0].mean() < 0.8 * p1.records[:5, 0].mean()
    assert len(res_t.step_ms) == len(res_t.eval_ms) == 20


def test_graphmlp_sparse_adjacency_path(rng):
    """Above 8192 nodes GraphMLP crops [B, B] blocks of the sparse power on
    the host per step."""
    n = 8200
    _, ct = configs(train_which="GraphMLP", N_nodes=n, graphMLP_reg=1.0)
    src, dst = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    tp = tds.prepare(tds.NodeData(
        x=rng.normal(size=(n, F_)).astype(np.float32), y=rng.integers(0, C, n),
        edge_index=np.stack([src, dst]), train_mask=np.arange(n) < 40,
        val_mask=None, test_mask=np.arange(n) >= 40, name="sparse"),
        ct, spmm_dense_threshold=64)
    res = tloops.run_experiment(ct, tp, seed=0, epochs=2, device="cpu")
    assert res.records.shape == (2, 5) and np.isfinite(res.records).all()


@pytest.mark.parametrize("student", ["SEMLP", "StudentBaseMLP", "GraphMLP"])
def test_main_cli_students_on_cpu(capsys, student):
    results = tmain.main(["--dataset=TEXAS", f"--train_which={student}",
                          "--epochs=2", "--device=cpu", "--log_every=1"])
    assert len(results) == 1 and np.isfinite(results[0].records).all()
    assert results[0].columns == ["loss_train", "acc_test", "head", "tail", "iso"]
    out = capsys.readouterr().out
    assert "p2 Ep001 loss_train=" in out and "=== mean ± std over seeds" in out
    assert ("p1 Ep001 train/test mse" in out) == (student == "SEMLP")
