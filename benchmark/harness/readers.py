"""The arithmetic of the per-layer metrics, over a traced window's
``harness.trace.Summary`` and the cell's work a step (``work()``). Each
metric's file under ``benchmark/metrics/`` calls one of these. A reader
that finds nothing to read returns None, and the metric is left out.

A metric of one kernel is a new file that calls ``kernel_ms`` or
``kernel_roofline`` with a pattern of the kernel's name, and the least
time of its work a step under a key of ``work()``: the arithmetic of that
least time lives in the entry's ``work()`` or in a new ``harness/`` file."""
from __future__ import annotations

import re
from typing import Iterable, Optional

from harness import roofline

#: the op classes of the passes around the dense layers
PASSES = ("elementwise", "cast/copy", "reduction", "index")


def class_ms(r, classes: Iterable[str]) -> Optional[float]:
    """Device ms a step of the op ``classes``."""
    s = r.summary
    if s is None or s.steps == 0:
        return None
    return sum(s.class_s.get(c, 0.0) for c in classes) / s.steps * 1e3


def launches(r) -> Optional[float]:
    s = r.summary
    return None if s is None or s.steps == 0 else s.kernels / s.steps


def idle_share(r) -> Optional[float]:
    """Idle share of the window from its first kernel, in %."""
    s = r.summary
    if s is None or s.span_s <= 0:
        return None
    return (1.0 - s.busy_s / s.span_s) * 100.0


def mfu(r) -> Optional[float]:
    """The step's model FLOPs over its host time in the traced window times
    the f32 peak, in %."""
    s = r.summary
    if s is None or s.steps == 0 or not r.work.get("flops"):
        return None
    return r.work["flops"] / (s.window_s / s.steps * roofline.F32_FLOPS) * 100.0


def spmm_roofline(r) -> Optional[float]:
    """The least time of the SpMM work a step needs over the SpMM kernels'
    device time a step, in %."""
    s = r.summary
    spmm_s = None if s is None else s.class_s.get("spmm", 0.0)
    if not spmm_s or not r.work.get("spmm_least_s"):
        return None
    return r.work["spmm_least_s"] / (spmm_s / s.steps) * 100.0


def kernel_ms(r, pattern: str) -> Optional[float]:
    """Device ms a step of the kernels whose full names ``pattern`` (a
    regular expression) finds; None where no such kernel ran."""
    s = r.summary
    if s is None or s.steps == 0:
        return None
    find = re.compile(pattern).search
    times = [t for name, t in s.kernel_s.items() if find(name)]
    return sum(times) / s.steps * 1e3 if times else None


def kernel_roofline(r, pattern: str, key: str) -> Optional[float]:
    """``work()[key]``, the least seconds a step of the work those kernels
    do, over their device seconds a step, in %."""
    ms = kernel_ms(r, pattern)
    if not ms or not r.work.get(key):
        return None
    return r.work[key] / (ms / 1e3) * 100.0
