"""The traced window: device events by op class, busy and idle time, and the
breakdown of the longest device operations and idle gaps.

``KERNEL_CLASSES``, ``op_class`` and ``merged`` are frozen copies of
``profile_step.py``'s op-class table and ``busy_ms``'s interval union. The window runs
under ``torch.profiler`` (CPU and CUDA activities); its chrome trace is
read back and deleted. An idle gap is labelled by what the host was doing
when it began: the innermost span that the harness or the program opened
(``record_function``) and the outermost torch operation running then, or
"python" where none ran. ``kernel_s`` keeps every kernel's device time by
its full name, so that a reader can take one kernel's time by a pattern.
"""
from __future__ import annotations

import bisect
import collections
import heapq
import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the prefixes of the spans that label idle gaps: the harness's (``run.py``)
#: and the program's (``utils/debug.py``); torch's own ``record_function``
#: spans (e.g. one an optimizer step) label no gap
HARNESS_SPANS = ("setup.", "window.", "gnn.")
SPMM_KERNEL = re.compile(r"\bspmm_\w+_kernel\b")
#: (class, pattern) of device kernels, tried in order: the first match names
#: the class. A cast runs as an elementwise kernel over
#: ``direct_copy_kernel_cuda`` and a random draw as
#: ``distribution_elementwise_grid_stride_kernel``, so the specific classes
#: come before ``elementwise``
KERNEL_CLASSES = (
    ("spmm", SPMM_KERNEL),
    ("gemm", re.compile(r"gemm|gemv|cutlass|cublas|nvjet|splitKreduce", re.I)),
    ("optimizer", re.compile(r"multi_tensor_apply|foreach", re.I)),
    ("rng", re.compile(r"philox|distribution_elementwise|fused_dropout", re.I)),
    ("cast/copy", re.compile(r"copy_kernel|CatArrayBatchedCopy|roll_cuda_kernel")),
    ("sort/top-k", re.compile(r"sort|radix|topk|bitonic|cub::|fill_reverse_indices", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("index", re.compile(r"index_elementwise|indexing_|index_select|indexSelect|indexFunc"
                         r"|index_put|gather|scatter|embedding|\bcompute_cuda_kernel\b", re.I)),
    ("reduction", re.compile(r"reduce_kernel|_norm_|norm_kernel|GammaBeta|moments|welford"
                             r"|nll_loss", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel")),
)
TOP = 10  # entries of each breakdown list


def op_class(cat: str, name: str) -> str:
    """``copies`` and ``memset`` for the memcpy and memset categories, else
    the first of ``KERNEL_CLASSES`` whose pattern the kernel's name
    matches, else ``other``."""
    if cat != "kernel":
        return "copies" if cat == "gpu_memcpy" else "memset"
    for cls, pattern in KERNEL_CLASSES:
        if pattern.search(name):
            return cls
    return "other"


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Summary:
    """What the readers take from a traced window of ``steps`` steps."""

    steps: int
    window_s: float  # host clock around the traced window
    class_s: Dict[str, float]  # device seconds by op class
    kernels: int  # device kernels launched
    busy_s: float  # union of device activity
    span_s: float  # from the first kernel to the last device event's end
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    kernel_s: Dict[str, float] = field(default_factory=dict)  # every kernel, by full name


def _host_labels(times, cpu_ops, spans) -> List[str]:
    """The label of each of the ascending host ``times`` (us): the innermost
    span (the one that began last of those still open) and the outermost
    torch op on the host then. One sweep over the spans, so that no number
    of spans opened inside another hides the outer one."""
    spans = sorted(spans)  # (ts, end, name)
    tops = []  # outermost ops: not inside the op before them
    for s, e, name in sorted(cpu_ops):
        if tops and s < tops[-1][1]:
            continue
        tops.append((s, e, name))
    top_starts = [s for s, _, _ in tops]
    open_spans: List[Tuple[float, float, str]] = []  # heap of (-ts, end, name)
    i, out = 0, []
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(open_spans, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while open_spans and open_spans[0][1] <= t:
            heapq.heappop(open_spans)
        span = open_spans[0][2] if open_spans else "outside spans"
        op = "python"
        k = bisect.bisect_right(top_starts, t) - 1
        if k >= 0 and tops[k][0] <= t < tops[k][1]:
            op = tops[k][2]
        out.append(f"{span} | {op}")
    return out


def summarize_events(events: List[dict], steps: int, window_s: float) -> Summary:
    """The ``Summary`` of chrome-trace events ("X" phase)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    class_s: Dict[str, float] = collections.Counter()
    by_name: Dict[str, float] = collections.Counter()
    kernel_s: Dict[str, float] = collections.Counter()
    for e in dev:
        class_s[op_class(e["cat"], e["name"])] += e["dur"] / 1e6
        by_name[e["name"]] += e["dur"] / 1e6
        if e["cat"] == "kernel":
            kernel_s[e["name"]] += e["dur"] / 1e6
    if not kernels:
        return Summary(steps, window_s, dict(class_s), 0, 0.0, 0.0)
    t0 = min(e["ts"] for e in kernels)
    busy = merged((e["ts"], e["ts"] + e["dur"]) for e in dev if e["ts"] >= t0)
    end = busy[-1][1]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy[:-1], busy[1:])]
    labels = _host_labels(
        [s for s, _ in gaps],
        [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events if e.get("cat") == "cpu_op"],
        [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
         if e.get("cat") == "user_annotation" and e["name"].startswith(HARNESS_SPANS)])
    gap_s: Dict[str, float] = collections.Counter()
    for label, (s, e) in zip(labels, gaps):
        gap_s[label] += (e - s) / 1e6
    return Summary(
        steps=steps, window_s=window_s, class_s=dict(class_s), kernels=len(kernels),
        busy_s=sum(e - s for s, e in busy) / 1e6, span_s=(end - t0) / 1e6,
        device_ops=[(n[:120], s) for n, s in by_name.most_common(TOP)],
        idle_gaps=[(n[:120], s) for n, s in gap_s.most_common(TOP)], kernel_s=dict(kernel_s))


def traced(run_window, trace_path: Path) -> Summary:
    """Runs ``run_window()`` (which returns (steps, host seconds)) under
    ``torch.profiler`` and summarizes its trace, which is written to
    ``trace_path`` and deleted."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        steps, window_s = run_window()
        torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    try:
        with open(trace_path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(trace_path)
    return summarize_events(events, steps, window_s)
