"""The port's TeacherGNN path against the JAX package's: forward, loss and
gradients through flax -> torch transplanted weights (rtol 1e-4, atol 1e-5),
and three epochs of train_teacher from the same initial parameters (loss to
1e-4 relative, each accuracy within one node). Graphs are built with
``spmm_dense_threshold`` below N, so ``auto`` takes the sparse path on both
sides: the Pallas kernels in interpret mode there, the CSR kernels' plain
versions here. Dropout is 0: random streams differ between frameworks."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.models.teacher import TeacherGNN as JTeacher
from gnn_tail_generalization_tpu.train import loops as jloops

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.nn.backbone import dense_layer
from gnn_tail_generalization_tpu_torch.nn.dropout import dropout
from gnn_tail_generalization_tpu_torch.nn.gcn import GCNConv
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax

N, F, C, H = 60, 12, 4, 8


def setup(rng, type_trick, se, **extra):
    """Same host data and config through both packages' prepare."""
    src, dst = rng.integers(0, N, 240), rng.integers(0, N, 240)
    arrays = dict(
        x=rng.normal(size=(N, F)).astype(np.float32),
        y=rng.integers(0, C, N), edge_index=np.stack([src, dst]),
        train_mask=np.arange(N) < N // 2, val_mask=None,
        test_mask=np.arange(N) >= N // 2, name="port-parity")
    kw = dict(dataset="", train_which="TeacherGNN", N_nodes=N, num_feats=F,
              num_classes=C, dim_hidden=H, dropout=0.0, type_trick=type_trick,
              whetherHasSE=se, se_reg=0.5, lr=0.01, weight_decay=5e-4, **extra)
    cj, ct = jcfg.build_config(**kw), tcfg.build_config(**kw)
    jp = jds.prepare(jds.NodeData(**arrays), cj, spmm_dense_threshold=N // 2)
    tp = tds.prepare(tds.NodeData(**arrays), ct, spmm_dense_threshold=N // 2)
    assert jp.graph.plans is not None and tp.graph.dense_adj is None
    return cj, ct, jp, tp


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


# the arxiv best config (Initial branch; SE from flag [1]), a non-residual
# trick with SE on every layer, and the Residual branch
TRICKS = [("InitialBatchNorm", "111"), ("NoResNodeNorm", "111"),
          ("ResidualNoNorm", "100")]


@pytest.mark.parametrize("trick,se", TRICKS)
def test_forward_loss_grads_match_flax(rng, trick, se):
    cj, ct, jp, tp = setup(rng, trick, se)
    model = JTeacher(cj)
    x, y = jnp.asarray(jp.x), jnp.asarray(jp.y)
    mask = jnp.asarray(jp.train_mask)
    params = jax.jit(lambda g: model.init(jax.random.PRNGKey(3), g, x, train=True))(
        jp.graph)["params"]
    g_last_j = jloops.final_agg_view(cj, jp, is_dist=False)

    def loss_fn(p):
        _, classi, se_reg, _ = model.apply({"params": p}, jp.graph, x,
                                           train=True, g_last=g_last_j)
        loss = jloops._nll_masked(classi, y, mask)
        if se_reg is not None:
            loss = loss + cj.se_reg * se_reg
        return loss, classi

    (loss_j, logits_j), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    eval_j = jax.jit(lambda p: model.apply({"params": p}, jp.graph, x,
                                           train=False)[1])(params)

    tm = TeacherGNN(ct)
    tm.load_state_dict(params_from_jax(flat(params), ct))
    xt, yt = torch.from_numpy(tp.x), torch.from_numpy(tp.y)
    g_last = tloops.final_agg_view(ct, tp)
    assert g_last is not None and g_last.n_edge < tp.graph.n_edge
    tm.train()
    _, classi, se_reg, _ = tm(tp.graph, xt, g_last=g_last)
    loss = tloops._nll_masked(classi, yt, torch.from_numpy(tp.train_mask))
    if se_reg is not None:
        loss = loss + ct.se_reg * se_reg
    loss.backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_j), **tol)
    np.testing.assert_allclose(classi.detach().numpy(), np.asarray(logits_j), **tol)
    want = params_from_jax(flat(grads_j), ct)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(tp.graph, xt)[1].numpy(),
                                   np.asarray(eval_j), **tol)


def test_train_teacher_matches_jax(rng):
    cj, ct, jp, tp = setup(rng, "InitialBatchNorm", "111")
    init = jloops.train_teacher(cj, jp, seed=0, epochs=0)
    res_j = jloops.train_teacher(cj, jp, seed=0, epochs=3)
    state = params_from_jax(flat(init.variables["params"]), ct)
    res_t = tloops.train_teacher(ct, tp, seed=0, epochs=3, init_state=state)
    assert res_t.columns == res_j.columns == [
        "loss_train", "acc_train", "acc_test", "head", "tail", "iso"]
    np.testing.assert_allclose(res_t.records[:, 0], res_j.records[:, 0],
                               rtol=1e-4)
    train = tp.train_mask
    s = tp.splits
    counts = {"acc_train": train.sum(), "acc_test": tp.test_mask.sum(),
              "head": (s.large_deg_mask & ~train).sum(),
              "tail": (s.small_deg_mask & ~train).sum(),
              "iso": (s.zero_deg_mask & ~train).sum()}
    for i, col in enumerate(res_t.columns[1:], start=1):
        one_node = 100.0 / max(counts[col], 1) + 1e-6
        diff = np.abs(res_t.records[:, i] - res_j.records[:, i]).max()
        assert diff <= one_node, (col, res_t.records[:, i], res_j.records[:, i])
    assert len(res_t.step_ms) == 3


def test_main_cli_on_cpu(capsys):
    results = tmain.main(["--dataset=TEXAS", "--epochs=2", "--device=cpu",
                          "--log_every=1", "--N_exp=2", "--dropout=0.5"])
    assert len(results) == 2 and all(np.isfinite(r.records).all() for r in results)
    out = capsys.readouterr().out
    # --N_exp > 1 goes through train/multiseed.py, which prints the JAX
    # package's per-epoch "[multiseed]" lines across the seeds
    assert "[multiseed] ep 1: acc_test=" in out and "seed 1: loss_train=" in out
    assert "=== mean ± std over seeds" in out


@pytest.mark.parametrize("argv,match", [
    (["--exp_mode=I2_GTL"], None),
    (["--n_devices=2"], "A12"), (["--hier_mesh=2x4"], "A12"),
    (["--prog=1-0-2"], None),
    (["--records_path={tmp}"], None)],
    ids=["argv0-A8", "argv1-A12", "argv2-A12", "argv3-A11", "argv4-A11"])
def test_main_raises_for_unported_parts(tmp_path, argv, match):
    """Only the multi-device flags (ROADMAP A12) still raise. The flags that
    once raised here (the I2-GTL edgewise loss, A8; ``--prog`` and
    ``--records_path``, A11) now run: finite records, with the MRR columns
    under I2_GTL, the grid cell recorded under ``--prog``, the curves saved
    under ``--records_path``."""
    base = ["--dataset=TEXAS", "--epochs=1", "--device=cpu",
            "--force_set_to_best_config=0"]
    argv = [a.format(tmp=tmp_path) for a in argv]
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tmain.main(base + argv)
        return
    if argv[0].startswith("--prog"):
        argv = argv + [f"--records_path={tmp_path}"]
    results = tmain.main(base + argv)
    assert len(results) == 1 and np.isfinite(results[0].records).all()
    cols = results[0].columns
    assert (cols[-2:] == ["linkp_train", "linkp_test"]) == ("I2_GTL" in argv[0])
    if argv[0].startswith("--prog"):
        assert (tmp_path / "res.npy").exists()
    if argv[0].startswith("--records_path"):
        assert (tmp_path / "TEXAS" / "acc_test@TeacherGNN.npy").exists()


@pytest.mark.parametrize("argv", [
    ["--train_which=LP"], ["--type_trick=BatchNorm"], ["--type_trick=Jumping"],
    ["--apply_graph_dropout=1", "--type_trick=DropEdge"]],
    ids=["LP", "BatchNorm", "Jumping", "graph_dropout"])
def test_main_runs_ported_parts(capsys, argv):
    """The flags that once raised run on the CPU: finite records, or for LP
    one JSON line of accuracies."""
    results = tmain.main(["--dataset=TEXAS", "--epochs=2", "--device=cpu",
                          "--force_set_to_best_config=0"] + argv)
    assert len(results) == 1
    if argv == ["--train_which=LP"]:
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        assert len(lines) == 1
        res = json.loads(lines[0])
        assert res == results[0] and set(res) == {"acc_train", "acc_test"}
        assert all(np.isfinite(v) for v in res.values())
    else:
        assert results[0].records.shape[0] == 2
        assert np.isfinite(results[0].records).all()


def test_main_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--dataset=TEXAS", "--epochs=1", "--device=cuda"])


def test_dropout_uses_the_generator():
    x = torch.ones(400, 50)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, train=True, generator=None)
    a = dropout(x, 0.3, train=True, generator=torch.Generator().manual_seed(1))
    b = dropout(x, 0.3, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert abs((a == 0).float().mean().item() - 0.3) < 0.02
    assert abs(a.mean().item() - 1.0) < 0.03  # inverted scaling keeps E[x]
    assert dropout(x, 0.3, train=False, generator=None) is x


def test_init_distributions():
    """flax inits drawn from the generator: lecun-normal (truncated) Dense,
    xavier-uniform conv kernel, N(0, 1) SE, zero biases."""
    g = torch.Generator().manual_seed(0)
    lin = dense_layer(1000, 300, g)
    std = (1 / 1000) ** 0.5
    assert abs(lin.weight.std().item() / std - 1) < 0.03
    assert lin.weight.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not lin.bias.any()
    conv = GCNConv(400, 200, 500, has_se=True, generator=g)
    bound = (6 / 600) ** 0.5
    assert conv.weight.abs().max().item() <= bound
    assert abs(conv.weight.std().item() / (bound / 3 ** 0.5) - 1) < 0.03
    assert abs(conv.se.std().item() - 1) < 0.02 and not conv.bias.any()
    again = GCNConv(400, 200, 500, has_se=True,
                    generator=torch.Generator().manual_seed(0))
    assert not torch.equal(again.weight, conv.weight)  # the stream advanced


def test_featureless_and_learnable_input(rng):
    _, ct, _, tp = setup(rng, "InitialBatchNorm", "000",
                         change_to_featureless=True)
    tm = TeacherGNN(ct, generator=torch.Generator().manual_seed(0)).eval()
    out = tm(tp.graph, torch.from_numpy(tp.x))[0]
    assert torch.equal(out, tm(tp.graph, torch.zeros(N, F))[0])
    ct2 = dataclasses.replace(ct, change_to_featureless=False,
                              dim_learnable_input=6)
    ct2 = tcfg.apply_arch_configs(ct2)
    tm2 = TeacherGNN(ct2, generator=torch.Generator().manual_seed(0)).eval()
    assert tm2.input_embs.shape == (N, 6)
    assert tm2(tp.graph, torch.from_numpy(tp.x))[0].shape == (N, C)


def test_params_from_jax_rejects_what_does_not_fit(rng):
    _, ct, _, _ = setup(rng, "InitialBatchNorm", "000")
    good = {k: v.numpy() for k, v in TeacherGNN(ct).state_dict().items()}
    flax_like = {"backbone/conv_0/kernel": good["backbone.convs.0.weight"]}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(flax_like, ct)
    with pytest.raises(KeyError, match="no port parameter"):
        params_from_jax({"backbone/norm_0/scale": np.ones(H)}, ct)
