"""Observability: profiler traces, spans and counters, NaN guards, a
throughput counter.

The port of ``gnn_tail_generalization_tpu/utils/debug.py``:

- ``profile_trace``: ``torch.profiler`` (host and, where there is a card,
  CUDA activity) around any region, written as a Chrome trace, with the
  recorder's summary beside it;
- the recorder: ``span(name)`` around a layer's work, ``count(name, n)``,
  ``host_read(name)`` around an operation that waits for the card, and
  ``recorded()``, the summary (calls, host ms and device ms of each span
  name, its self time, and the counters). It records exactly while a
  ``torch.profiler`` profile records, and costs one flag check otherwise;
  ``Laps`` keeps the times of one span's calls whether or not it records
  (``TrainResult.step_ms``);
- ``checked``: wraps a function to return ``(err, out)``; ``err.throw()``
  raises on a NaN or Inf in the output (the JAX package's checkify wrapper);
- ``assert_finite``: finiteness of every floating tensor or array of a
  state_dict or a nested structure;
- ``spmm_edges_per_sec``: SpMM throughput in edges/s, synchronised on CUDA.

The JAX package's ``measure_gather_rate`` calibrates a TPU gather emitter
and has no counterpart here.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

#: its ``_is_profiler_enabled`` flag, true while a profile records, is the
#: recorder's switch: a module attribute, so a check costs one lookup
_PROFILER = torch.autograd.profiler


class _Noop:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Laps:
    """The times of one span's calls, kept whether or not the recorder is
    on: on a CUDA ``device`` two CUDA events a call on the current stream,
    read by ``ms()`` once the caller's own blocking read has passed them
    (nothing is synchronised for them); elsewhere the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: List[Tuple[Any, Any]] = []

    def ms(self) -> List[float]:
        """Each call's ms, in order."""
        if not self.cuda:
            return [(t1 - t0) / 1e6 for t0, t1 in self._marks]
        if self._marks and not self._marks[-1][1].query():
            self._marks[-1][1].synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self._marks]


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """One call of a span. Recording (``rec``): a ``record_function`` of the
    same name, the host clock, the parent from the recorder's stack, and
    on CUDA an event on the current stream at entry and exit. With
    ``laps`` alone: only what ``laps`` keeps."""

    __slots__ = ("name", "laps", "rec", "cuda", "parent", "rf", "t0", "t1", "e0", "e1",
                 "kids_host_ns", "kids", "dev_ms")

    def __init__(self, name: str, laps: Optional[Laps], rec: bool):
        self.name, self.laps, self.rec = name, laps, rec
        self.cuda = (laps is not None and laps.cuda) or (rec and torch.cuda.is_initialized())
        self.e0 = self.e1 = self.dev_ms = None
        self.kids_host_ns = 0
        self.kids: List["_Span"] = []

    def __enter__(self):
        if self.rec:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            stack = _RECORDER.stack
            self.parent = stack[-1] if stack else None
            stack.append(self)
        if self.cuda:
            self.e0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.e1 = _event()
        self.t1 = time.perf_counter_ns()
        if self.laps is not None:
            self.laps._marks.append(
                (self.e0, self.e1) if self.laps.cuda else (self.t0, self.t1))
        if self.rec:
            _RECORDER.close(self)
            self.rf.__exit__(*exc)
        return False

    def device_ms(self) -> Optional[float]:
        if self.dev_ms is None and self.e0 is not None:
            self.dev_ms = self.e0.elapsed_time(self.e1)
        return self.dev_ms


class _Recorder:
    """The spans and counters recorded while a profile records, in memory
    until ``recorded()`` reads them."""

    def __init__(self):
        self.stack: List[_Span] = []  # open spans, innermost last
        self.closed: List[_Span] = []  # closed, their events not yet read
        self.counters: Dict[str, int] = collections.Counter()
        # name -> [calls, host ns, self host ns, device ms, self device ms,
        # the names of its parents]
        self.totals: Dict[str, list] = {}

    def close(self, s: _Span) -> None:
        self.stack.pop()  # spans close innermost first
        if s.parent is not None:
            s.parent.kids_host_ns += s.t1 - s.t0
            s.parent.kids.append(s)
        self.closed.append(s)

    def resolve(self) -> None:
        """Folds the closed spans into the totals, after one synchronize
        where any of them holds CUDA events."""
        closed, self.closed = self.closed, []
        if any(s.e0 is not None for s in closed):
            torch.cuda.synchronize()
        for s in closed:
            t = self.totals.setdefault(s.name, [0, 0, 0, None, None, set()])
            host = s.t1 - s.t0
            t[0] += 1
            t[1] += host
            t[2] += host - s.kids_host_ns
            if s.parent is not None:
                t[5].add(s.parent.name)
            dev = s.device_ms()
            if dev is not None:
                kids = sum(k.device_ms() or 0.0 for k in s.kids)
                t[3] = (t[3] or 0.0) + dev
                t[4] = (t[4] or 0.0) + dev - kids
            s.kids = []  # a span's children are read once, with it


_RECORDER = _Recorder()


def span(name: str, laps: Optional[Laps] = None):
    """A context manager around one layer's work. Off (no profile
    recording) it is one shared no-op, or only ``laps``'s timer where
    ``laps`` is given. On, it records the span (``_Span``) for
    ``recorded()`` and shows in the profile under ``name``. Names start
    with ``gnn.``, and a span's phases extend its name
    (``gnn.teacher.step.forward``)."""
    if not _PROFILER._is_profiler_enabled:
        return _NOOP if laps is None else _Span(name, laps, False)
    return _Span(name, laps, True)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while the recorder is on."""
    if _PROFILER._is_profiler_enabled:
        _RECORDER.counters[name] += n


def host_read(name: str):
    """``span(name)`` around one operation that makes the host wait for the
    card's queue (a copy to the host, a branch or a shape on a device
    value, a blocking copy to the card), counted in ``host_syncs``. Names
    end in ``.read``: their host time is time the host waited."""
    if not _PROFILER._is_profiler_enabled:
        return _NOOP
    _RECORDER.counters["host_syncs"] += 1
    return _Span(name, None, True)


def recorded() -> Dict[str, Any]:
    """The summary of what the recorder holds: ``{"spans": {name: {"calls",
    "host_ms", "self_host_ms", "device_ms", "self_device_ms", "parents"}},
    "counters": {name: n}}``. Device ms is the current stream's interval
    from a span's start event to its end event, idle included (None
    without CUDA events); self ms leaves out what its child spans cover.
    Reading synchronizes once where there are events to read."""
    _RECORDER.resolve()
    spans = {name: {"calls": t[0], "host_ms": t[1] / 1e6, "self_host_ms": t[2] / 1e6,
                    "device_ms": t[3], "self_device_ms": t[4], "parents": sorted(t[5])}
             for name, t in _RECORDER.totals.items()}
    return {"spans": spans, "counters": dict(_RECORDER.counters)}


def reset() -> None:
    """Forgets every recorded span and counter."""
    _RECORDER.closed, _RECORDER.totals = [], {}
    _RECORDER.counters = collections.Counter()


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the ``with`` body; on exit write ``<logdir>/trace.json``
    (chrome://tracing, Perfetto) and ``<logdir>/spans.json``, the
    recorder's summary (``recorded()``) of the body alone."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(recorded(), f, indent=1)


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path or "/", tree


def _nonfinite(tree: Any) -> List[str]:
    """Paths of the floating tensors and arrays of ``tree`` that hold a NaN
    or an Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                bad.append(path)
        elif isinstance(leaf, (np.ndarray, np.floating, float)):
            a = np.asarray(leaf)
            if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
                bad.append(path)
    return bad


@dataclasses.dataclass(frozen=True)
class CheckError:
    """What ``checked`` found: ``get()`` is None or a message."""

    message: Optional[str] = None

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked(fn):
    """``fn`` wrapped to return ``(err, out)``; ``err`` names the outputs
    that hold a NaN or an Inf (a division by zero shows as one of those)."""
    def g(*args, **kw):
        out = fn(*args, **kw)
        bad = _nonfinite(out)
        msg = f"non-finite values in the output of {getattr(fn, '__name__', fn)}: {bad}"
        return CheckError(msg if bad else None), out

    return g


def assert_finite(tree: Any, name: str = "pytree") -> None:
    bad = _nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def spmm_edges_per_sec(g, x: torch.Tensor, method: str = "auto",
                       iters: int = 10) -> float:
    """Measured SpMM throughput in edges/s on ``x``'s device: one warm-up
    call, then ``iters`` calls between two synchronisations."""
    from ..ops.spmm import spmm

    def sync():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    with torch.no_grad():
        spmm(g, x, method)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            spmm(g, x, method)
        sync()
    return g.n_edge / ((time.perf_counter() - t0) / iters)
