"""The port's run utilities: batch-grid records (``TensorRex``: grow, skip,
the merge of two writers; curve names), checkpoints (``torch.save`` trees
read back with ``weights_only=True``; the teacher's ``save_dir``), the NaN
guards, the throughput counter and profiler trace, the host helpers
``table1_stats`` and ``subgraph_edges`` against the JAX package's, the
multi-seed teacher against per-seed ``train_teacher`` runs, and the CLI's
``--N_exp``, ``--prog``, ``--records_path``, ``--epoch_block`` and
``--data_root``."""
import json
import os

import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu.graph import analysis as jan
from gnn_tail_generalization_tpu.graph import core as jcore

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch import main as tmain
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.data import synthetic as tsyn
from gnn_tail_generalization_tpu_torch.graph import analysis as tan
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.train import checkpoint
from gnn_tail_generalization_tpu_torch.train import loops
from gnn_tail_generalization_tpu_torch.train.multiseed import train_teacher_multiseed
from gnn_tail_generalization_tpu_torch.utils import debug
from gnn_tail_generalization_tpu_torch.utils.records import (
    TensorRex, load_curve, plot_curve, save_curve)

BASE = ["--dataset=TEXAS", "--epochs=2", "--device=cpu", "--log_every=1",
        "--force_set_to_best_config=0"]


def test_tensorrex_grows_skips_and_merges(tmp_path):
    path = str(tmp_path / "rex.npy")
    r1 = TensorRex(path, grid_shape=(1, 1), record_len=3, grow_to_fit=True)
    r1.record((0, 0), [1.0, 2.0, 3.0, 4.0])  # longer than record_len: cut
    r2 = TensorRex(path, grid_shape=(1, 2), record_len=3, grow_to_fit=True)
    assert r2.is_done((0, 0)) and not r2.is_done((0, 1))
    np.testing.assert_array_equal(r2.values((0, 0)), [1.0, 2.0, 3.0])
    # two writers that loaded the same grid before either recorded
    a = TensorRex(path, grid_shape=(2, 2), record_len=3, grow_to_fit=True)
    b = TensorRex(path, grid_shape=(2, 2), record_len=3, grow_to_fit=True)
    a.record((1, 1), [5.0])
    b.record((0, 1), [6.0, 7.0])
    c = TensorRex(path, grid_shape=(2, 2), record_len=3)
    assert all(c.is_done(x) for x in ((0, 0), (0, 1), (1, 1)))
    assert not c.is_done((1, 0))
    np.testing.assert_array_equal(c.values((1, 1)), [5.0, 0.0, 0.0])
    with pytest.raises(AssertionError, match="existing rex shape"):
        TensorRex(path, grid_shape=(3, 3), record_len=3)


def test_curves_save_load_and_plot(tmp_path):
    curve = np.sin(np.linspace(0, 6, 200))
    p = save_curve(curve, "acc_test@TeacherGNN", str(tmp_path))
    assert p == os.path.join(str(tmp_path), "acc_test@TeacherGNN.npy")
    np.testing.assert_array_equal(load_curve("acc_test@TeacherGNN", str(tmp_path)), curve)
    pytest.importorskip("matplotlib")
    png = plot_curve(curve, "loss_train", str(tmp_path), smooth_window=10)
    assert os.path.getsize(png) > 1000


def test_checkpoint_round_trip(tmp_path):
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    p = str(tmp_path / "sub" / "state.pt")
    checkpoint.save_train_state(p, params=model.state_dict(),
                                opt_state=opt.state_dict(), epoch=7,
                                extra={"se": np.arange(6.0).reshape(2, 3)})
    raw = torch.load(p, weights_only=True)  # tensors, numbers, dicts only
    assert raw["epoch"] == 7 and raw["extra"]["se"].dtype == torch.float64
    state = checkpoint.load_train_state(p, template=raw)
    fresh = torch.nn.Linear(4, 3)
    fresh.load_state_dict(state["params"])
    assert torch.equal(fresh.weight, model.weight)
    opt2 = torch.optim.Adam(fresh.parameters(), lr=0.01)
    opt2.load_state_dict(state["opt_state"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": [1, 2]}
    checkpoint.save_pytree(tree, str(tmp_path / "t.pt"))
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.load_pytree({"w": torch.zeros(3, 2), "n": [0, 0]},
                               str(tmp_path / "t.pt"))
    with pytest.raises(ValueError, match="keys"):
        checkpoint.load_pytree({"w": torch.zeros(2, 3)}, str(tmp_path / "t.pt"))


def small_prepared(n=120, **over):
    kw = dict(dataset="", train_which="TeacherGNN", N_nodes=n, num_feats=16,
              num_classes=3, dim_hidden=8, whetherHasSE="111")
    cfg = tcfg.build_config(**{**kw, **over})
    data = tsyn.synthetic_planetoid(n_node=n, n_feat=16, n_class=3, seed=1)
    return cfg, tds.prepare(data, cfg, spmm_dense_threshold=n // 2)


@pytest.mark.parametrize("train_which", ["TeacherGNN", "SEMLP"])
def test_train_teacher_save_dir_round_trip(tmp_path, train_which):
    cfg, pd = small_prepared(train_which=train_which)
    res = loops.train_teacher(cfg, pd, seed=3, epochs=3, save_dir=str(tmp_path),
                              device="cpu")
    best = tmp_path / "best-teacherGNN.pt"
    assert best.exists() == (train_which == "SEMLP")
    state = checkpoint.load_train_state(str(tmp_path / "teacherGNN.pt"))
    assert state["epoch"] == 3
    outs = []
    for sd in (res.state_dict, state["params"]):
        model = TeacherGNN(cfg)
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            outs.append(model(pd.graph, torch.from_numpy(pd.x))[1])
    assert torch.equal(*outs)  # the eval forward, bit for bit
    if best.exists():
        saved = checkpoint.load_train_state(str(best))["params"]
        assert all(torch.equal(saved[k], v) for k, v in res.best_state_dict.items())


def test_checked_and_assert_finite_catch_nan():
    err, out = debug.checked(torch.log)(torch.tensor([-1.0, 1.0]))
    assert err.get() is not None and torch.isnan(out[0])
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()
    err, _ = debug.checked(lambda a, b: {"q": a / b})(torch.ones(2), torch.zeros(2))
    assert "/q" in err.get()
    ok, _ = debug.checked(torch.exp)(torch.zeros(3))
    assert ok.get() is None
    ok.throw()
    debug.assert_finite({"a": torch.ones(3), "b": [np.ones(2), 3]})
    sd = {"w": torch.ones(2, 2), "bn": {"running_var": torch.tensor([1.0, np.inf])}}
    with pytest.raises(FloatingPointError, match="bn/running_var"):
        debug.assert_finite(sd, "state_dict")
    with pytest.raises(FloatingPointError):
        debug.assert_finite([np.array([np.nan])])


def test_spmm_edges_per_sec_and_profile_trace(rng, tmp_path):
    e = tcore.standard_pipeline(
        np.stack([rng.integers(0, 64, 200), rng.integers(0, 64, 200)]), 64)
    g = tcore.build_graph(e, 64, with_dense=False)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    with debug.profile_trace(str(tmp_path / "prof")):
        eps = debug.spmm_edges_per_sec(g, x, iters=2)
    assert eps > 0
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


def test_table1_stats_and_subgraph_edges_match_jax(rng):
    n = 200
    e = jcore.standard_pipeline(
        np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)]), n)
    degs = np.bincount(e[1], minlength=n + 5)
    assert tan.table1_stats(n, degs) == jan.table1_stats(n, degs)
    subset = np.sort(rng.choice(n, 80, replace=False))
    attr = rng.normal(size=e.shape[1])
    for relabel in (True, False):
        for a, b in zip(tcore.subgraph_edges(e, subset, n, relabel, attr),
                        jcore.subgraph_edges(e, subset, n, relabel, attr)):
            np.testing.assert_array_equal(a, b)
    et, at = tcore.subgraph_edges(e, subset, n)
    assert at is None and et.max() < len(subset)


@pytest.mark.parametrize("exp_mode", ["coldbrew", "I2_GTL"])
def test_multiseed_equals_train_teacher_per_seed(exp_mode, capsys):
    cfg, pd = small_prepared(exp_mode=exp_mode, samp_size_p=16,
                             samp_size_n_train=16, samp_size_n_test_times_p=2)
    seeds = [4, 9]
    results = train_teacher_multiseed(cfg, pd, seeds, epochs=3, log_every=2,
                                      device="cpu")
    assert len(results) == 2
    for s, r in zip(seeds, results):
        one = loops.train_teacher(cfg, pd, s, epochs=3, device="cpu")
        assert r.columns == one.columns
        np.testing.assert_array_equal(r.records, one.records)
    assert ("linkp_test" in results[0].columns) == (exp_mode == "I2_GTL")
    out = capsys.readouterr().out
    assert "[multiseed] ep 0: acc_test=" in out and "[multiseed] ep 2:" in out


def test_main_n_exp_goes_through_multiseed(monkeypatch, capsys):
    from gnn_tail_generalization_tpu_torch.train import multiseed

    called = []
    real = multiseed.train_teacher_multiseed

    def spy(*a, **kw):
        called.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(multiseed, "train_teacher_multiseed", spy)
    results = tmain.main(BASE + ["--N_exp=2", "--random_seed=5", "--epoch_block=7"])
    assert called == [[5, 6]] and len(results) == 2
    out = capsys.readouterr().out
    assert "seed 1: loss_train=" in out and "=== mean ± std over seeds" in out


def test_main_prog_skips_a_done_cell_and_saves_curves(tmp_path, capsys):
    argv = BASE + ["--prog=1-0", f"--records_path={tmp_path}", "--records_desc=run"]
    first = tmain.main(argv)
    assert len(first) == 1
    out = capsys.readouterr().out
    assert f"rex cell (1, 0) recorded to {tmp_path}/res.npy" in out
    rex = TensorRex(str(tmp_path / "res.npy"), grid_shape=(2, 1), record_len=8)
    assert rex.is_done((1, 0)) and not rex.is_done((0, 0))
    np.testing.assert_allclose(rex.values((1, 0))[:3], first[0].records[-1, :3])
    for c in first[0].columns:
        curve = load_curve(f"{c}@TeacherGNN", str(tmp_path / "run"))
        assert curve.shape == (1, 2)
    assert tmain.main(argv) == []
    assert "rex cell (1, 0) already done; skipping" in capsys.readouterr().out


def test_main_reads_fake_cora_through_data_root(tmp_path, capsys):
    tsyn.write_fake_planetoid_raw(str(tmp_path), "cora")
    results = tmain.main(["--dataset=Cora", "--epochs=2", "--device=cpu",
                          "--log_every=1", f"--data_root={tmp_path}"])
    out = capsys.readouterr().out
    assert "NOTE: no raw dataset files" not in out and "Ep001 loss_train=" in out
    assert np.isfinite(results[0].records).all()
