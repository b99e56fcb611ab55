"""The arithmetic of the per-layer metrics that read the port's own
recorder (``utils/debug.py:recorded``): the spans and counters the program
records while the traced window's profile records, a step at a time. A
reader returns None without a traced window (a CPU run), and where the
program records nothing it could read: a program without the recorder, or
without the spans the reader asks for."""
from __future__ import annotations

from typing import Callable, Optional


def recorded(r) -> Optional[dict]:
    """The recorder's summary of the traced window, or None."""
    s = r.summary
    if s is None or s.steps == 0:
        return None
    from gnn_tail_generalization_tpu_torch.utils import debug

    read = getattr(debug, "recorded", None)
    if read is None:
        return None
    rec = read()
    return rec if rec["spans"] else None


def span_ms(r, match: Callable[[str], bool], field: str = "device_ms",
            none: Optional[float] = None) -> Optional[float]:
    """The sum of ``field`` (``device_ms`` or ``host_ms``) over the spans
    whose names ``match`` accepts, a step; ``none`` where the program
    recorded spans but none of these."""
    rec = recorded(r)
    if rec is None:
        return None
    values = [v[field] for name, v in rec["spans"].items() if match(name)]
    if not values:
        return none
    if any(v is None for v in values):
        return None
    return sum(values) / r.summary.steps


def counter(r, name: str) -> Optional[float]:
    """The counter ``name`` a step (0 where the program recorded spans but
    never counted it)."""
    rec = recorded(r)
    return None if rec is None else rec["counters"].get(name, 0) / r.summary.steps


def phase(name: str, suffix: str) -> bool:
    """Whether ``name`` is a trainer's top-level phase span
    ``gnn.<trainer>.<suffix>`` (``gnn.teacher.eval``, not
    ``gnn.student.eval.batch``)."""
    parts = name.split(".")
    return len(parts) == 3 and parts[0] == "gnn" and parts[2] == suffix
