"""The port's sharded students, label propagation and C&S stages, sharded
link prediction and the sharded checkpoint pair against the JAX package's
sharded functions and against the port's one-device runs.

JAX runs on 4 of the 8 fake CPU devices (``tests/conftest.py``), its Pallas
kernels in interpret mode; the port runs 4 gloo ranks on the CPU, spawned
once for the module (``ranks``; their program and the inputs of both sides
in ``test_torch_port_dist_students_ranks.py``), at n = 90 padded to 96
(``rb = 8``) and, for GraphMLP's host-cropped adjacency power, n = 8200.
Tolerances, with max |a - b| over max |b| as "relative":
- ``dist_latent_replace``: equal to JAX ``make_dist_latent_replace`` and to
  the one-device op within 1e-6 (the same scores, the same selection);
- the students (SEMLP's teacher, SE table, part 1 and part 2;
  StudentBaseMLP; GraphMLP dense and cropped) sharded against the one-device
  run from the same streams: records rtol 1e-4, atol 1e-3, the SE table
  1e-5; LP's accuracies equal; the replicated parameters bit-equal across
  the ranks;
- LP and both C&S stages on sharded adjacencies against JAX's: rtol 1e-4,
  atol 1e-5, under ``auto`` and ``pallas_bf16``;
- sharded ``train_linkpred`` against the one-device run: stats rtol 1e-4;
  one sharded step against JAX's sharded loss: loss 1e-5, gradients rtol
  1e-4 with a floor of 1e-5 x the largest.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from gnn_tail_generalization_tpu.graph import core as jcore
from gnn_tail_generalization_tpu.linkpred import encoders as jenc
from gnn_tail_generalization_tpu.linkpred import model as jlpm
from gnn_tail_generalization_tpu.ops.topk_attention import make_dist_latent_replace
from gnn_tail_generalization_tpu.parallel import distgraph as jdg
from gnn_tail_generalization_tpu.propagation import correlation as jcorr

from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.linkpred import model as tlpm
from gnn_tail_generalization_tpu_torch.ops.topk_attention import latent_neighbor_replace
from gnn_tail_generalization_tpu_torch.parallel import distgraph as tdg
from gnn_tail_generalization_tpu_torch.parallel import launch
from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
from gnn_tail_generalization_tpu_torch.train import checkpoint as tckpt
from gnn_tail_generalization_tpu_torch.train import loops as tloops

from test_torch_port_dist_students_ranks import (
    C, METHODS, N_PROP, N_SMALL, RB, REPLACE_CASES, S, SEED, STUDENTS, link_batch,
    link_case, link_msg, lp_arrays, pad_rows, rank_program, replace_case, run_student,
    student_case, teacher_init)

EB = 32
RECORDS = dict(rtol=1e-4, atol=1e-3)


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def mesh():
    return jax.make_mesh((S,), ("graph",), devices=jax.devices()[:S])


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def gather(ranks, pick):
    """The ranks' row shards of one result, concatenated in shard order."""
    return np.concatenate([pick(r) for r in ranks])


def jax_link_setup():
    """JAX's LinkPredModel parameters and its sharded step inputs."""
    cfg_t, x, e, n = link_case()
    cj = jlpm.LinkPredConfig(**{f: getattr(cfg_t, f) for f in (
        "encoder", "predictor", "dropout", "use_node_feats", "train_node_emb",
        "eval_metric", "batch_size", "num_neg", "gnn_hidden_channels",
        "mlp_hidden_channels")})
    msg = link_msg(e, n)
    g = jdg.build_dist_graph(msg, n, mesh(), rb=RB, eb=EB)
    xd = jdg.global_put(jdg.pad_rows_np(x, g.n_node_pad),
                        NamedSharding(mesh(), P("graph", None)))
    model = jlpm.LinkPredModel(cj, n, x.shape[1])
    z = jnp.zeros(2, jnp.int32)  # the parameters do not depend on the graph
    params = model.init(jax.random.PRNGKey(2), jcore.build_graph(msg, n),
                        jnp.asarray(x), z, z)["params"]
    # committed replicated, as JAX's sharded trainer commits them
    params = jax.device_put(params, NamedSharding(mesh(), P()))
    return cj, model, params, g, xd, msg, n


@pytest.fixture(scope="module")
def jax_link():
    return jax_link_setup()


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded-ckpt"))


@pytest.fixture(scope="module")
def ranks(jax_link, save_dir):
    """The port's 4 gloo ranks, spawned once: rank r's ``rank_program``."""
    cfg, _ = student_case("SEMLP")
    spec = {"teacher_init": teacher_init(cfg), "link_params": flat(jax_link[2]),
            "save_dir": save_dir}
    return launch.spawn(rank_program, S, "gloo", "cpu", spec, timeout=600)


# ---------------------------------------------------------------------------
# the collectives and the latent-neighbour op
# ---------------------------------------------------------------------------

def test_all_gather_stacks_the_shards_in_order(ranks):
    for r in ranks:
        for dt, got in r["all_gather"].items():
            want = np.stack([np.arange(6).reshape(2, 3) + 10 * k for k in range(S)])
            np.testing.assert_array_equal(got, want, err_msg=dt)
            assert str(got.dtype) in dt
    one = Comm(0, 1, "cpu", "gloo")
    t = torch.arange(4.0)
    assert torch.equal(one.all_gather(t), t[None]) and one.counts["all_gathers"] == 0


@pytest.mark.parametrize("name", REPLACE_CASES)
def test_dist_latent_replace_matches_jax_and_the_one_device_op(ranks, name):
    """Every rank returns JAX's result and the one-device op's on the real
    rows: the poisoned padding rows are never picked, and the K-th place
    tied across the shard cut goes to the lower global index."""
    q, se, k, n_valid = replace_case(name)
    rows = se.shape[0] // S
    fn = make_dist_latent_replace(mesh(), "graph", rows, n_valid)
    want = np.asarray(jax.jit(fn, static_argnums=2)(jnp.asarray(q), jnp.asarray(se), k))
    one = latent_neighbor_replace(torch.from_numpy(q), torch.from_numpy(se[:n_valid]),
                                  k).numpy()
    assert rel_err(one, want) <= 1e-6
    for r in ranks:
        got = r["replace"][name]
        assert rel_err(got, want) <= 1e-6, (name, r["rank"])
        np.testing.assert_array_equal(got, ranks[0]["replace"][name])
    if name == "tie":  # rows 10, 11 and 23 (not 24) for the first query
        sel = [10, 11, 23]
        w = torch.softmax(torch.from_numpy(se[sel] @ q[0]), 0).numpy()
        np.testing.assert_allclose(ranks[0]["replace"][name][0], w @ se[sel], rtol=1e-5)


# ---------------------------------------------------------------------------
# the students, sharded against the one-device run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device():
    """Each student case on one device, from the ranks' streams and start."""
    out = {}
    for name in STUDENTS:
        cfg, arrays = student_case(name)
        pd = tds.prepare(tds.NodeData(**arrays), cfg)
        out[name] = run_student(name, pd, cfg, teacher_init(cfg))
    return out


@pytest.mark.parametrize("name", STUDENTS)
def test_sharded_student_matches_the_one_device_run(ranks, one_device, name):
    want = one_device[name]
    for r in ranks:
        got = r["students"][name]
        assert got.keys() == want.keys()
        for phase, w in want.items():
            g = got[phase]
            if phase == "se":  # the rank's rows of the padded SE table
                continue
            if isinstance(w, dict):  # LP's accuracies
                assert g == w, (name, g, w)
                continue
            assert g["columns"] == w.columns, (name, phase)
            np.testing.assert_allclose(g["records"], w.records, **RECORDS,
                                       err_msg=f"{name} {phase}")
    if name == "SEMLP":
        n = want["se"].shape[0]
        se = gather(ranks, lambda r: r["students"][name]["se"])
        assert se.shape == (96, want["se"].shape[1])
        assert rel_err(se[:n], want["se"].numpy()) <= 1e-5


@pytest.mark.parametrize("name", STUDENTS[:-1])
def test_sharded_student_parameters_stay_equal_across_ranks(ranks, name):
    for phase, res in ranks[0]["students"][name].items():
        if not isinstance(res, dict) or "replicated" not in res:
            continue
        for r in ranks[1:]:
            other = r["students"][name][phase]["replicated"]
            for k, v in res["replicated"].items():
                assert np.array_equal(other[k], v), (name, phase, k)
            np.testing.assert_array_equal(r["students"][name][phase]["records"],
                                          res["records"])


def test_graphmlp_cases_take_the_dense_and_the_cropped_paths():
    for name, dense in (("GraphMLP", True), ("GraphMLP-sparse", False)):
        cfg, arrays = student_case(name)
        pd = tds.prepare_sharded(tds.NodeData(**arrays), cfg, Comm(1, S, "cpu", "gloo"),
                                 rb=RB)
        assert (tloops._n_global(pd) <= 8192) == dense
        assert pd.n_node == pd.graph.rows_per_shard  # a rank's rows only


# ---------------------------------------------------------------------------
# label propagation and C&S against JAX's sharded functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_propagation():
    e, y, mo, idx = lp_arrays()
    dad = jcorr.gen_normalized_dist_adj(e, N_SMALL, mesh(), "DAD", rb=RB, eb=EB)
    ad = jcorr.gen_normalized_dist_adj(e, N_SMALL, mesh(), "AD", rb=RB, eb=EB)
    y_p, mo_p, li = (jnp.asarray(pad_rows(y)), jnp.asarray(pad_rows(mo)),
                     jnp.asarray(idx))
    out = {}
    for m in METHODS:
        out[("lp", m)] = np.asarray(jax.jit(lambda yy, ii: jcorr.label_propagation(
            yy, ii, dad, 0.5, N_PROP, C, spmm_method=m))(y_p, li))
        for fn in (jcorr.double_correlation_autoscale, jcorr.double_correlation_fixed):
            res = jax.jit(lambda yy, mm, ii: fn(yy, mm, ii, ii, dad, 0.8, N_PROP, ad, 0.7,
                                                N_PROP, C, spmm_method=m))(y_p, mo_p, li)
            out[(fn.__name__, m)] = tuple(np.asarray(a) for a in res)
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("stage", ["lp", "double_correlation_autoscale",
                                   "double_correlation_fixed"])
def test_propagation_on_sharded_adjacencies_matches_jax(ranks, jax_propagation,
                                                        stage, method):
    want = jax_propagation[(stage, method)]
    if stage == "lp":
        got = gather(ranks, lambda r: r["propagation"][(stage, method)])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return
    for i, part in enumerate(("corrected", "smoothed")):
        got = gather(ranks, lambda r: r["propagation"][(stage, method)][i])
        np.testing.assert_allclose(got, want[i], rtol=1e-4, atol=1e-5, err_msg=part)


def test_sharded_lp_scores_acc_test_over_the_test_mask():
    """run_pure_lp's sharded branch scores over data.test_mask, the
    one-device branch over ~train_mask, as the JAX package does (here with
    validation nodes 45-69, where the two differ)."""
    from gnn_tail_generalization_tpu_torch.propagation import correlation as corr

    cfg, arrays = student_case("LP")
    arrays = dict(arrays, test_mask=np.arange(N_SMALL) >= 70)
    pd1 = tds.prepare(tds.NodeData(**arrays), cfg)
    one = tloops.run_pure_lp(cfg, pd1, device="cpu")
    pd = tds.prepare_sharded(tds.NodeData(**arrays), cfg, Comm(0, 1, "cpu", "gloo"),
                             rb=RB)
    sharded = tloops.run_pure_lp(cfg, pd, device="cpu")
    dad = corr.gen_normalized_adjs(pd1.edge_index, N_SMALL, which={"DAD"})[0]
    y = torch.from_numpy(pd1.y)
    hit = corr.label_propagation(y, torch.from_numpy(pd1.train_idx), dad, 0.5, 50,
                                 C).argmax(1) == y

    def acc(mask):
        return round(hit[torch.from_numpy(mask)].float().mean().item() * 100, 2)

    assert one == {"acc_train": acc(pd1.train_mask), "acc_test": acc(~pd1.train_mask)}
    assert sharded == {"acc_train": acc(pd1.train_mask), "acc_test": acc(pd1.test_mask)}


# ---------------------------------------------------------------------------
# sharded link prediction
# ---------------------------------------------------------------------------

def test_sharded_linkpred_matches_the_one_device_run(ranks):
    cfg, x, e, n = link_case()
    one = tlpm.train_linkpred(cfg, x, e, n, epochs=2, runs=1, seed=11, device="cpu")
    for r in ranks:
        for k, v in one["stats"].items():
            np.testing.assert_allclose(r["linkpred"]["stats"][k], v, rtol=1e-4, err_msg=k)
        for k, v in ranks[0]["linkpred"]["params"].items():
            assert np.array_equal(r["linkpred"]["params"][k], v), k


def test_sharded_linkpred_step_matches_jax(ranks, jax_link):
    """One step on fixed pairs: the loss every rank computes and the summed
    replicated gradients against JAX's sharded loss and its gradients."""
    cj, model, params, g, xd, msg, n = jax_link
    agg0 = jenc.hoisted_first_agg(cj.encoder, g, xd, cj.spmm_method)
    loss_fn = jlpm.make_loss_fn(cj, model, lambda h, i: jdg.dist_take_rows(g, h, i))
    pos, neg, valid = link_batch(n, msg)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, {"g": g, "x": xd, "agg0": agg0}, jnp.asarray(pos), jnp.asarray(neg),
        jax.random.PRNGKey(0), jnp.asarray(valid))
    from gnn_tail_generalization_tpu_torch.utils.convert import linkpred_params_from_jax

    cfg, x, _, _ = link_case()
    want = linkpred_params_from_jax(flat(grads), cfg, n, x.shape[1])
    scale = max(float(w.abs().max()) for w in want.values())
    for r in ranks:
        np.testing.assert_allclose(r["linkpred"]["step_loss"], float(loss), rtol=1e-5)
        got = r["linkpred"]["step_grads"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=k)


@pytest.mark.parametrize("kw", [dict(encoder="Transformer"), dict(encoder="MLP"),
                                dict(train_node_emb=True), dict(edge_lp_mode="logit")],
                         ids=["Transformer", "MLP", "train_node_emb", "edge_lp_mode"])
def test_sharded_linkpred_refuses_what_jax_refuses(kw):
    cfg, x, e, n = link_case()
    cfg = tlpm.LinkPredConfig(**{**cfg.__dict__, **kw})
    with pytest.raises(ValueError, match="sharded link prediction"):
        tlpm.train_linkpred(cfg, x, e, n, epochs=1, comm=Comm(0, 1, "cpu", "gloo"),
                            device="cpu")


# ---------------------------------------------------------------------------
# the sharded checkpoint pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [4, 2, 1])
def test_sharded_checkpoint_reads_back_at_any_shard_count(ranks, save_dir, n_shards):
    """Written by the 4 ranks, read with 4, 2 and 1 shards (1: the unpadded
    one-device rows): each row-sharded tensor is the written one recut, the
    replicated ones are rank 0's; the files load with weights_only=True."""
    path = os.path.join(save_dir, "teacherGNN.pt")
    written = [r["checkpoint"] for r in ranks]
    n_pad = 96 if n_shards > 1 else None
    for shard in range(n_shards):
        got = tckpt.load_train_state(path, shard=shard, n_shards=n_shards,
                                     n_node_pad=n_pad)
        assert got["epoch"] == 1
        for k, v in written[0].items():
            if tdg.is_row_sharded(k):
                full = np.concatenate([w[k] for w in written])
                rows = (96 if n_pad else N_SMALL) // n_shards
                want = full[shard * rows: (shard + 1) * rows]
            else:
                want = v
            np.testing.assert_array_equal(got["params"][k].numpy(), want, err_msg=k)
    names = os.listdir(tckpt.sharded_dir(path))
    assert sorted(names) == sorted([tckpt.MANIFEST, tckpt.REPLICATED]
                                   + [f"shard_{k}.pt" for k in range(S)])
    assert not os.path.exists(path)


def test_sharded_checkpoint_newest_wins(ranks, save_dir, tmp_path):
    """A file and a sharded directory at one path: the newer one is read."""
    src = os.path.join(save_dir, "teacherGNN.pt")
    path = str(tmp_path / "teacherGNN.pt")
    import shutil

    shutil.copytree(tckpt.sharded_dir(src), tckpt.sharded_dir(path))
    tckpt.save_train_state(path, params={"w": torch.ones(2)}, epoch=7)
    manifest = os.path.join(tckpt.sharded_dir(path), tckpt.MANIFEST)
    t = os.path.getmtime(path)
    os.utime(manifest, (t - 10, t - 10))
    assert tckpt.load_train_state(path)["epoch"] == 7
    os.utime(manifest, (t + 10, t + 10))
    assert tckpt.load_train_state(path, n_node_pad=96)["epoch"] == 1


# ---------------------------------------------------------------------------
# the collectives the ranks ran, and the CLI
# ---------------------------------------------------------------------------

def test_ranks_ran_the_same_collectives(ranks):
    counts = [{k: v for k, v in r["counts"].items() if k != "skipped_buckets"}
              for r in ranks]
    assert all(c == counts[0] for c in counts[1:])
    assert counts[0]["all_gathers"] > len(REPLACE_CASES) + 3  # and part 2's


@pytest.mark.parametrize("train_which", ["SEMLP", "StudentBaseMLP", "GraphMLP", "LP"])
def test_cli_sharded_students_print_the_one_device_labels(capfd, train_which):
    argv = ["--dataset=TEXAS", "--epochs=2", "--device=cpu", "--log_every=1",
            f"--train_which={train_which}"]
    one = tmain.main(argv)
    out_one = capfd.readouterr().out
    four = tmain.main(argv + [f"--n_devices={S}"])
    out_four = capfd.readouterr().out

    def labels(out):  # each line with its numbers masked
        return [re.sub(r"-?\d+\.\d+", "#", ln) for ln in out.splitlines()
                if ln.startswith(("Ep", "p1", "p2", "seed", "  ", "===", "{"))]

    assert labels(out_four) == labels(out_one)
    if train_which == "LP":
        assert four[0].keys() == one[0].keys() and out_four.count("{") == 1
    else:
        assert four[0].columns == one[0].columns
        assert np.isfinite(four[0].records).all()


def test_sharded_entry_points_default_to_the_card(monkeypatch):
    """A rank's student phases, sharded LP and sharded link prediction run
    on the card unless told otherwise, and raise here, where torch finds
    none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comm = Comm(0, 1, "cpu", "gloo")
    for name in ("StudentBaseMLP", "LP"):
        cfg, arrays = student_case(name)
        pd = tds.prepare_sharded(tds.NodeData(**arrays), cfg, comm, rb=RB)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloops.run_experiment(cfg, pd, SEED)
    cfg, x, e, n = link_case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlpm.train_linkpred(cfg, x, e, n, epochs=1, comm=comm)
