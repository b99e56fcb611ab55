"""The port's span and counter recorder (``utils/debug.py``) and the spans
and counters inside the trainers, the latent-neighbour replacement, the
link step and its evaluation, and the SpMM entry point.

Off (no profile recording) a span is one shared no-op and opens no
``record_function``; on, under ``torch.profiler``, spans nest, keep self
time under total time, show in the chrome trace, and each loop's spans
appear as often as it runs them. ``host_syncs`` counts where the program
waits for the card; the test marked ``card`` holds it to the synchronisations
torch itself reports on a CUDA card (``torch.cuda.set_sync_debug_mode``):

    python -m pytest tests/test_torch_trace.py -m card --noconftest -q

(``--noconftest``: the card's machine has no JAX, which ``tests/conftest.py``
imports; this file imports none of it.)
"""
import collections
import json
import warnings

import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
from gnn_tail_generalization_tpu_torch.linkpred import sampling
from gnn_tail_generalization_tpu_torch.ops import spmm as spmm_mod
from gnn_tail_generalization_tpu_torch.ops import _build, topk_attention
from gnn_tail_generalization_tpu_torch.train import loops
from gnn_tail_generalization_tpu_torch.utils import debug

N, F_, C = 300, 12, 4


@pytest.fixture(autouse=True)
def fresh_recorder():
    debug.reset()
    yield
    debug.reset()


@pytest.fixture
def card():
    """Skips the test where torch finds no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the synchronisations torch reports exist on a card only")
    return torch.device("cuda")


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (the recorder on); (its result,
    the recorder's summary of it)."""
    debug.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out = fn()
    return out, debug.recorded()


def calls(rec):
    return {name: s["calls"] for name, s in rec["spans"].items()}


def spmm_impl_calls(monkeypatch):
    """A list that grows by one at every ``ops/spmm.py:spmm_impl`` call."""
    seen = []
    impl = spmm_mod.spmm_impl

    def counted(*a, **kw):
        seen.append(1)
        return impl(*a, **kw)

    monkeypatch.setattr(spmm_mod, "spmm_impl", counted)
    return seen


def node_setup(n=N, batch_size=64, device="cpu"):
    """A small node-classification problem on the sparse SpMM path: the
    port's config (SE on every layer, head / tail / isolated subsets) and
    prepared data."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    arrays = dict(x=rng.normal(size=(n, F_)).astype(np.float32), y=rng.integers(0, C, n),
                  edge_index=np.stack([src, dst]), train_mask=np.arange(n) < n // 2,
                  val_mask=None, test_mask=np.arange(n) >= n // 2, name="trace")
    cfg = tcfg.build_config(dataset="", train_which="SEMLP", N_nodes=n, num_feats=F_,
                            num_classes=C, dim_hidden=8, dropout=0.1, dropout_MLP=0.1,
                            type_trick="InitialBatchNorm", whetherHasSE="111", se_reg=0.5,
                            lr=0.01, weight_decay=5e-4, batch_size=batch_size)
    return cfg, tds.prepare(tds.NodeData(**arrays), cfg, spmm_dense_threshold=n // 2)


def student_inputs(cfg, pd, device="cpu"):
    """The teacher's SE table and part 1's result, one epoch each."""
    teacher = loops.train_teacher(cfg, pd, seed=0, epochs=1, device=device)
    se = loops.collect_teacher_se(cfg, pd, teacher.best_state_dict, device=device)
    return se, loops.train_semlp_part1(cfg, pd, se, seed=0, epochs=1, device=device)


def link_setup(n=400, m=4000, batch_size=128, device="cpu"):
    """A small link problem with the default model and the OGB MRR on
    ``device``:
    (config, model, optimizer, step constants, membership keys, train
    positives, the split with its edges on ``device``)."""
    cfg = lpm.LinkPredConfig(batch_size=batch_size, emb_hidden_channels=16,
                             gnn_hidden_channels=16, mlp_hidden_channels=16,
                             eval_metric="mrr")
    split, msg = lpm.simple_split_edges(fast_powerlaw_graph(n, m, 0), n, seed=0,
                                        num_neg_eval=20)
    g = lpm.link_graph(cfg, msg, n).to(device)
    const = lpm.link_const(cfg, g, torch.zeros(n, 1, device=device))
    model = lpm.LinkPredModel(cfg, n, 1, generator=torch.Generator().manual_seed(0))
    model.to(device)
    opt = lpm.make_optimizer(cfg, model.parameters())
    keys = sampling.edge_keys(msg, n)  # as train_linkpred picks the membership test
    keys = (sampling.build_membership(keys) if n > 100_000 else torch.from_numpy(keys)).to(device)
    on_dev = {s: {k: torch.as_tensor(np.asarray(v), device=device) for k, v in d.items()}
              for s, d in split.items()}
    return cfg, model, opt, const, keys, on_dev["train"]["edge"].long(), on_dev


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_span_off_is_one_noop_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function opened with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    s1, s2 = debug.span("gnn.a"), debug.span("gnn.b")
    assert s1 is s2 and debug.host_read("gnn.a.read") is s1
    with debug.span("gnn.a"), debug.span("gnn.a.b"), debug.host_read("gnn.a.read"):
        debug.count("spmm.calls", 3)
    laps = debug.Laps("cpu")
    for _ in range(2):
        with debug.span("gnn.a", laps):
            pass
    assert len(laps.ms()) == 2 and all(v >= 0 for v in laps.ms())
    assert debug.recorded() == {"spans": {}, "counters": {}}


def test_spans_nest_under_the_profiler(tmp_path):
    def body():
        for _ in range(3):
            with debug.span("gnn.a"):
                with debug.span("gnn.a.b"):
                    torch.randn(200, 200) @ torch.randn(200, 200)
                    debug.count("spmm.calls")
                with debug.host_read("gnn.a.read"):
                    debug.count("spmm.calls", 2)
        with debug.span("gnn.c"):
            pass

    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        body()
    rec = debug.recorded()
    assert calls(rec) == {"gnn.a": 3, "gnn.a.b": 3, "gnn.a.read": 3, "gnn.c": 1}
    assert rec["counters"] == {"spmm.calls": 9, "host_syncs": 3}
    spans = rec["spans"]
    assert spans["gnn.a"]["parents"] == [] and spans["gnn.c"]["parents"] == []
    assert spans["gnn.a.b"]["parents"] == ["gnn.a"] == spans["gnn.a.read"]["parents"]
    for s in spans.values():
        assert 0 <= s["self_host_ms"] <= s["host_ms"]
        assert s["device_ms"] is None and s["self_device_ms"] is None  # no CUDA events
    kids = spans["gnn.a.b"]["host_ms"] + spans["gnn.a.read"]["host_ms"]
    assert spans["gnn.a"]["self_host_ms"] == pytest.approx(spans["gnn.a"]["host_ms"] - kids)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = collections.Counter(e["name"] for e in json.load(open(path))["traceEvents"]
                                if e.get("cat") == "user_annotation")
    assert {k: names[k] for k in calls(rec)} == calls(rec)


def test_recorded_folds_each_span_once_and_reset_forgets():
    def once():
        with debug.span("gnn.a"):
            debug.count("spmm.calls")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        once()
        assert calls(debug.recorded()) == {"gnn.a": 1}
        once()
    assert calls(debug.recorded()) == {"gnn.a": 2}
    assert calls(debug.recorded()) == {"gnn.a": 2}
    debug.reset()
    assert debug.recorded() == {"spans": {}, "counters": {}}


def test_profile_trace_writes_the_spans_beside_the_trace(tmp_path):
    with debug.span("gnn.before"):  # off: not recorded
        pass
    with debug.profile_trace(str(tmp_path)):
        with debug.span("gnn.inside"):
            debug.count("host_syncs")
    spans = json.load(open(tmp_path / "spans.json"))
    assert list(spans["spans"]) == ["gnn.inside"] and spans["counters"] == {"host_syncs": 1}
    assert (tmp_path / "trace.json").is_file()


# ---------------------------------------------------------------------------
# the spans and counters inside the port
# ---------------------------------------------------------------------------


def test_teacher_spans_and_counters(monkeypatch):
    cfg, pd = node_setup()
    seen = spmm_impl_calls(monkeypatch)
    epochs = 3
    res, rec = profiled(lambda: loops.train_teacher(cfg, pd, seed=0, epochs=epochs,
                                                    device="cpu"))
    per_epoch = {"gnn.teacher.step", "gnn.teacher.step.forward", "gnn.teacher.step.backward",
                 "gnn.teacher.step.optimizer", "gnn.teacher.eval", "gnn.teacher.read"}
    once = {"gnn.teacher.setup", "gnn.teacher.setup.model", "gnn.teacher.setup.inputs"}
    assert calls(rec) == {**{k: epochs for k in per_epoch}, **{k: 1 for k in once}}
    assert rec["counters"]["host_syncs"] == epochs  # the records' read, once an epoch
    assert rec["counters"]["spmm.calls"] == len(seen) and len(seen) % epochs == 0
    assert len(seen) // epochs == 3 * cfg.num_layers  # forward, backward, eval a layer
    assert rec["spans"]["gnn.teacher.step.optimizer"]["parents"] == ["gnn.teacher.step"]
    assert len(res.step_ms) == epochs


def test_student_spans_and_counters():
    cfg, pd = node_setup()
    se, p1 = student_inputs(cfg, pd)
    epochs = 2
    res, rec = profiled(lambda: loops.train_semlp_part2(cfg, pd, se, p1, seed=0,
                                                        epochs=epochs, device="cpu"))
    c = calls(rec)
    n_sub = len(res.columns) - 2  # head, tail, iso
    for name in ("gnn.student.step", "gnn.student.step.forward", "gnn.student.step.backward",
                 "gnn.student.step.optimizer", "gnn.student.eval", "gnn.student.eval.batch",
                 "gnn.student.eval.subsets", "gnn.student.read"):
        assert c[name] == epochs, name
    assert c["gnn.student.setup"] == 1
    # the train batch, the test batch and each subset, every one a chunk here
    assert c["gnn.replace"] == epochs * (2 + n_sub)
    assert c["gnn.replace.read"] >= c["gnn.replace"]
    assert rec["counters"]["host_syncs"] == c["gnn.student.read"] + c["gnn.replace.read"]
    assert "spmm.calls" not in rec["counters"]  # no graph in part 2
    assert set(rec["spans"]["gnn.replace"]["parents"]) == {
        "gnn.student.step.forward", "gnn.student.eval.batch", "gnn.student.eval.subsets"}
    assert len(res.step_ms) == len(res.eval_ms) == epochs


def test_replacement_counts_a_read_for_each_chunk_and_each_tie():
    """The tie check reads one flag a chunk; a chunk with tied rows reads
    their rows too."""
    se = torch.randn(50, 8)
    q = torch.randn(20, 8)
    _, rec = profiled(lambda: topk_attention.latent_neighbor_replace(q, se, 3, row_chunk=8))
    assert calls(rec) == {"gnn.replace": 1, "gnn.replace.read": 3}
    assert rec["counters"] == {"host_syncs": 3}
    tied = torch.zeros(50, 8)  # every score 0: every row tied
    _, rec = profiled(lambda: topk_attention.latent_neighbor_replace(q, tied, 3, row_chunk=8))
    assert rec["counters"] == {"host_syncs": 6}


def test_select_calls_count_only_kernel_launches():
    """``replace.select_calls`` counts launches of the top-K kernel, so the
    CPU route, which runs the plain version, counts none."""
    before = _build.launch_counts("topk")
    _, rec = profiled(lambda: topk_attention.latent_neighbor_replace(
        torch.randn(20, 8), torch.randn(50, 8), 3, row_chunk=8))
    assert calls(rec)["gnn.replace"] == 1
    assert rec["counters"].get("replace.select_calls", 0) == 0
    assert _build.launch_counts("topk") == before


def test_link_slice_spans_and_counters(monkeypatch):
    cfg, model, opt, const, keys, pos, _ = link_setup()
    steps = 3
    epoch_fn = lpm.make_epoch_fn(cfg, model, opt, 400, steps, cfg.batch_size,
                                 steps * cfg.batch_size)
    seen = spmm_impl_calls(monkeypatch)
    model.train()
    gen = torch.Generator().manual_seed(1)
    losses, rec = profiled(lambda: epoch_fn(const, pos[:steps * cfg.batch_size], keys, gen))
    # the loss copies its log(1e-15) to the card twice a step (positives and
    # negatives), which waits for the queue; nothing is read back
    assert calls(rec) == {"gnn.link.sample": 1, "gnn.link.step": steps,
                          "gnn.link.step.forward": steps, "gnn.link.step.backward": steps,
                          "gnn.link.step.optimizer": steps, "gnn.link.loss.read": 2 * steps}
    assert rec["counters"]["host_syncs"] == 2 * steps
    assert rec["counters"]["spmm.calls"] == len(seen) == 2 * cfg.gnn_num_layers * steps
    assert losses.shape == (steps,)


def test_link_evaluate_spans_and_counters(monkeypatch):
    cfg, model, _, const, _, _, split = link_setup()
    seen = spmm_impl_calls(monkeypatch)
    out, rec = profiled(lambda: lpm.evaluate(cfg, model, const, split))
    assert calls(rec) == {"gnn.link.encode": 1, "gnn.link.score": 4, "gnn.link.metric": 1,
                          "gnn.link.metric.read": 2}
    assert rec["counters"] == {"host_syncs": 2, "spmm.calls": len(seen)}
    assert len(seen) == cfg.gnn_num_layers
    assert all(np.isfinite(v) for v in out["MRR"])


def test_step_and_eval_times_without_the_profiler():
    """``step_ms`` (and part 2's ``eval_ms``) hold one time an epoch with
    the recorder off, and the recorder holds nothing."""
    cfg, pd = node_setup()
    se, p1 = student_inputs(cfg, pd)
    results = [loops.train_teacher(cfg, pd, seed=0, epochs=3, device="cpu"),
               loops.train_semlp_part1(cfg, pd, se, seed=0, epochs=3, device="cpu"),
               loops.train_semlp_part2(cfg, pd, se, p1, seed=0, epochs=3, device="cpu")]
    for res in results:
        assert len(res.step_ms) == 3 and all(np.isfinite(v) and v > 0 for v in res.step_ms)
    assert len(results[2].eval_ms) == 3 and all(v > 0 for v in results[2].eval_ms)
    assert debug.recorded() == {"spans": {}, "counters": {}}


def test_recording_leaves_the_outputs_as_they_were():
    cfg, pd = node_setup()
    off = loops.train_teacher(cfg, pd, seed=3, epochs=3, device="cpu")
    on, _ = profiled(lambda: loops.train_teacher(cfg, pd, seed=3, epochs=3, device="cpu"))
    np.testing.assert_array_equal(on.records, off.records)
    for k, v in off.state_dict.items():
        assert torch.equal(on.state_dict[k], v), k


# ---------------------------------------------------------------------------
# on the card: host_syncs against the synchronisations torch reports
# ---------------------------------------------------------------------------


def torch_syncs(fn):
    """(``fn()``, the synchronising CUDA operations torch reports while it
    runs, by the line of the program that made them)."""
    where = collections.Counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in seen:
        if "synchroniz" in str(w.message):
            where[f"{w.filename}:{w.lineno}"] += 1
    return out, where


def counted_unit(fn):
    """(torch's synchronisations by line, ``host_syncs``) of ``fn()`` run
    under the profiler; the recorder is read after the sync-debug mode
    is off."""
    debug.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        _, where = torch_syncs(fn)
    return where, debug.recorded()["counters"].get("host_syncs", 0)


@pytest.mark.card
def test_host_syncs_count_every_synchronisation_torch_reports(card):
    """One unit of each of the four benchmarked paths: torch's count of
    synchronising operations equals ``host_syncs``. A trainer call's
    set-up copies its inputs to the card (blocking host-to-device copies,
    not reads), so for the trainers the unit is the difference of a
    longer and a shorter call: their epochs. The trainers never call
    ``torch.cuda.synchronize``."""
    explicit = []
    cfg, pd = node_setup(n=20000, batch_size=12000, device=card)
    se, p1 = student_inputs(cfg, pd, device=card)
    report = {}

    def epochs_of(call):
        def run(epochs):
            with pytest.MonkeyPatch.context() as m:
                m.setattr(torch.cuda, "synchronize", lambda *a: explicit.append(a))
                return call(epochs)

        short, s_syncs = counted_unit(lambda: run(2))
        long, l_syncs = counted_unit(lambda: run(5))
        diff = long - short
        return +diff, sum(diff.values()), l_syncs - s_syncs

    teacher = epochs_of(lambda e: loops.train_teacher(cfg, pd, seed=0, epochs=e, device=card))
    student = epochs_of(lambda e: loops.train_semlp_part2(cfg, pd, se, p1, seed=0, epochs=e,
                                                          device=card))
    assert explicit == []

    n_link = 120_000  # above 100,000 nodes: the membership table, as at citation2
    lcfg, model, opt, const, keys, pos, split = link_setup(n=n_link, m=1_000_000,
                                                           batch_size=8192, device=card)
    steps = 4
    epoch_fn = lpm.make_epoch_fn(lcfg, model, opt, n_link, steps, lcfg.batch_size,
                                 steps * lcfg.batch_size)
    gen = torch.Generator(device=card).manual_seed(1)
    model.train()
    epoch_fn(const, pos[:steps * lcfg.batch_size], keys, gen)  # warm
    torch.cuda.synchronize()
    where, link_syncs = counted_unit(
        lambda: epoch_fn(const, pos[:steps * lcfg.batch_size], keys, gen))
    link = (where, sum(where.values()), link_syncs)
    lpm.evaluate(lcfg, model, const, split)
    where, eval_syncs = counted_unit(lambda: lpm.evaluate(lcfg, model, const, split))
    evaluation = (where, sum(where.values()), eval_syncs)
    for name, (where, by_torch, counted) in (("teacher", teacher), ("student", student),
                                             ("link slice", link), ("evaluate", evaluation)):
        report[name] = {"torch": by_torch, "host_syncs": counted, "where": dict(where)}
    print(json.dumps(report))
    assert teacher[2] == 3  # one read an epoch
    assert student[2] == 3  # the records' read an epoch: the top-K kernel reads nothing
    for name, r in report.items():
        assert r["torch"] == r["host_syncs"], (name, r)


@pytest.mark.card
def test_replacement_on_the_card_launches_the_kernel_and_reads_nothing(card):
    """On the card each row chunk of the replacement is one launch of the
    top-K kernel (``_build.LAUNCHES`` and ``replace.select_calls``), and the call
    makes no synchronisation: none counted, none reported by torch."""
    se = torch.randn(5000, 64, device=card)
    q = torch.randn(20000, 64, device=card)
    topk_attention.latent_neighbor_replace(q, se, 2)  # builds the kernels
    torch.cuda.synchronize()
    before = _build.LAUNCHES["topk_rows_f32"]
    debug.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        _, where = torch_syncs(lambda: topk_attention.latent_neighbor_replace(q, se, 2))
    rec = debug.recorded()
    chunks = 3  # 20,000 rows, 8,192 a chunk
    assert _build.LAUNCHES["topk_rows_f32"] - before == chunks
    assert rec["counters"].get("replace.select_calls") == chunks
    assert rec["counters"].get("host_syncs", 0) == 0 and sum(where.values()) == 0, where
