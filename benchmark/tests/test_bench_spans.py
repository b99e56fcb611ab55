"""The readers of the port's own spans and counters (``harness/spans.py``
and their files under ``benchmark/metrics/``): nothing without a traced
window or a recorder, and their arithmetic on a hand-built summary of
``utils/debug.py:recorded``."""
import pytest

import run
from harness import spec, trace

from gnn_tail_generalization_tpu_torch.utils import debug

NEW = ("call_setup_ms.epoch", "optimizer_ms.epoch", "optimizer_ms.link_step",
       "eval_ms.epoch", "replace_ms.epoch", "sample_ms.link_step", "score_ms.call",
       "host_wait_ms.epoch", "host_wait_ms.link_step", "host_wait_ms.call", "syncs.epoch",
       "syncs.link_step", "syncs.call", "spmm_calls.epoch", "spmm_calls.link_step",
       "spmm_calls.call")


def _span(calls, host_ms, device_ms):
    return {"calls": calls, "host_ms": host_ms, "self_host_ms": host_ms,
            "device_ms": device_ms, "self_device_ms": device_ms}


# two steps of a trainer, each span's totals over both
SUMMARY = {
    "spans": {
        "gnn.teacher.setup": _span(1, 30.0, 2.0),
        "gnn.teacher.setup.model": _span(1, 10.0, 1.0),
        "gnn.teacher.step": _span(2, 8.0, 40.0),
        "gnn.teacher.step.optimizer": _span(2, 1.0, 6.0),
        "gnn.teacher.eval": _span(2, 4.0, 12.0),
        "gnn.teacher.read": _span(2, 50.0, 0.2),
        "gnn.replace": _span(4, 3.0, 22.0),
        "gnn.replace.read": _span(8, 14.0, 0.1),
        "gnn.student.eval.batch": _span(2, 1.0, 100.0),
        "gnn.link.sample": _span(1, 0.5, 7.0),
        "gnn.link.step.optimizer": _span(2, 0.5, 5.0),
        "gnn.link.score": _span(4, 2.0, 60.0),
    },
    "counters": {"host_syncs": 10, "spmm.calls": 12},
}


def _readings(steps=2):
    return run.Readings(trace.Summary(steps, 1.0, {}, 0, 0.0, 0.0), {}, {})


def _read(name, r):
    return spec.load_module("metrics", name).read(r)


@pytest.mark.parametrize("name", NEW)
def test_span_readers_without_a_trace_find_nothing(name):
    assert _read(name, run.Readings(None, {}, {})) is None


@pytest.mark.parametrize("name", NEW)
def test_span_readers_without_a_recorder_find_nothing(name, monkeypatch):
    """A program without ``recorded`` (the parent of the recorder), or one
    whose recorder holds no span, gives no value."""
    monkeypatch.delattr(debug, "recorded")
    assert _read(name, _readings()) is None
    monkeypatch.setattr(debug, "recorded", lambda: {"spans": {}, "counters": {}},
                        raising=False)
    assert _read(name, _readings()) is None


def test_span_readers_on_a_hand_built_summary(monkeypatch):
    monkeypatch.setattr(debug, "recorded", lambda: SUMMARY)
    r = _readings(steps=2)
    want = {
        "call_setup_ms.epoch": 15.0,  # host ms of gnn.teacher.setup, not its child
        "optimizer_ms.epoch": 5.5,  # (6 + 5) / 2: every *.optimizer span
        "eval_ms.epoch": 6.0,  # gnn.teacher.eval, not gnn.student.eval.batch
        "replace_ms.epoch": 11.0,
        "sample_ms.link_step": 3.5,
        "score_ms.call": 30.0,
        "host_wait_ms.epoch": 32.0,  # host ms of the .read spans: (50 + 14) / 2
        "syncs.epoch": 5.0,
        "spmm_calls.epoch": 6.0,
    }
    for name, value in want.items():
        assert _read(name, r) == pytest.approx(value), name


def test_span_readers_count_zero_where_nothing_was_counted(monkeypatch):
    """A slice that reads nothing back counts no sync and waits 0 ms."""
    monkeypatch.setattr(debug, "recorded",
                        lambda: {"spans": SUMMARY["spans"], "counters": {}})
    assert _read("syncs.link_step", _readings()) == 0.0
    assert _read("spmm_calls.call", _readings()) == 0.0
    no_reads = {k: v for k, v in SUMMARY["spans"].items() if not k.endswith(".read")}
    monkeypatch.setattr(debug, "recorded", lambda: {"spans": no_reads, "counters": {}})
    assert _read("host_wait_ms.link_step", _readings()) == 0.0
    assert _read("sample_ms.link_step", _readings()) == pytest.approx(3.5)


def test_span_readers_give_nothing_without_device_times(monkeypatch):
    """A CPU recorder's spans have no device ms: the device readers give
    nothing, the host readers their host ms."""
    spans = {k: dict(v, device_ms=None, self_device_ms=None)
             for k, v in SUMMARY["spans"].items()}
    monkeypatch.setattr(debug, "recorded", lambda: {"spans": spans, "counters": {}})
    assert _read("eval_ms.epoch", _readings()) is None
    assert _read("call_setup_ms.epoch", _readings()) == pytest.approx(15.0)


def test_every_span_metric_is_in_the_benchmark_with_its_cells():
    b = spec.load_benchmark()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] and m["source"] in ("program_span", "program_counter")
