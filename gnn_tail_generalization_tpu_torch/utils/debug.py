"""Observability: profiler traces, NaN guards, a throughput counter.

The port of ``gnn_tail_generalization_tpu/utils/debug.py``:

- ``profile_trace``: ``torch.profiler`` (host and, where there is a card,
  CUDA activity) around any region, written as a Chrome trace;
- ``checked``: wraps a function to return ``(err, out)``; ``err.throw()``
  raises on a NaN or Inf in the output (the JAX package's checkify wrapper);
- ``assert_finite``: finiteness of every floating tensor or array of a
  state_dict or a nested structure;
- ``spmm_edges_per_sec``: SpMM throughput in edges/s, synchronised on CUDA.

The JAX package's ``measure_gather_rate`` calibrates a TPU gather emitter
and has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the ``with`` body; on exit write ``<logdir>/trace.json``
    (chrome://tracing, Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
