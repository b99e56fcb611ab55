"""Batch-run records: grid resumption tensor + per-curve npy persistence.

A host copy of ``gnn_tail_generalization_tpu/utils/records.py`` (importing
the original runs the JAX package's ``__init__``); the tests hold its code
equal to the original's. Reference parity:
- tensorRex (the reference's ``main.py:54-124``): an N-D numpy record with a
  done-flag channel; first call checks whether the grid cell is complete
  (skip), second call persists results; tolerant to result-length drift
  (fills to the stored epoch dim).
- wzRec (the reference's ``utils.py:1005-1051``): persists 1-D training
  curves to ``<dir>/<title>.npy``; ``plot_curve`` draws one with matplotlib,
  imported only when it is called.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


class TensorRex:
    """N-D grid record with done flags, resumable across processes.

    File layout: ``<path>`` stores an array of shape [*grid_shape,
    record_len + 1]; the trailing channel is the done flag.
    """

    def __init__(self, path: str, grid_shape: Sequence[int],
                 record_len: int, grow_to_fit: bool = False):
        """``grow_to_fit``: when the requested shape and an existing file
        disagree, expand to the elementwise max instead of asserting —
        lets per-cell callers (main.py --prog i-j-k without an explicit
        grid shape) fill one shared grid across processes."""
        self.path = path
        self.grid_shape = tuple(grid_shape)
        self.record_len = record_len
        if os.path.exists(path):
            self.arr = np.load(path)
            old = self.arr.shape[:-1]
            if old != self.grid_shape:
                if not grow_to_fit:
                    raise AssertionError(
                        f"existing rex shape {self.arr.shape} vs "
                        f"{self.grid_shape}")
                if len(old) != len(self.grid_shape):
                    raise AssertionError(
                        f"rex rank mismatch: {old} vs {self.grid_shape}")
                new_shape = tuple(max(a, b)
                                  for a, b in zip(old, self.grid_shape))
                grown = np.zeros(new_shape + (self.arr.shape[-1],))
                grown[tuple(slice(0, s) for s in old)] = self.arr
                self.arr = grown
                self.grid_shape = new_shape
            else:
                self.grid_shape = old
        else:
            self.arr = np.zeros(self.grid_shape + (record_len + 1,))

    def is_done(self, cell: Sequence[int]) -> bool:
        return bool(self.arr[tuple(cell)][-1] != 0)

    def record(self, cell: Sequence[int], values: np.ndarray) -> None:
        """Persist a finished cell. Values longer than record_len are
        truncated, shorter ones zero-filled (main.py:100-116 tolerance).

        Concurrent-writer safe: the on-disk grid is re-read and merged
        (done cells from disk win over our stale in-memory zeros) under an
        exclusive lock, then replaced atomically — two ``--prog`` processes
        filling different cells of one shared rex cannot lose each other's
        finished cells."""
        v = np.asarray(values, dtype=float).reshape(-1)
        out = np.zeros(self.record_len + 1)
        n = min(len(v), self.record_len)
        out[:n] = v[:n]
        out[-1] = 1.0
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        import fcntl
        import tempfile

        with open(self.path + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if os.path.exists(self.path):
                    on_disk = np.load(self.path)
                    if on_disk.shape == self.arr.shape:
                        done = on_disk[..., -1] != 0
                        self.arr[done] = on_disk[done]
                self.arr[tuple(cell)] = out
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(self.path) or ".", suffix=".npy")
                try:
                    with os.fdopen(fd, "wb") as f:
                        np.save(f, self.arr)
                    os.replace(tmp, self.path)
                except BaseException:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def values(self, cell: Sequence[int]) -> np.ndarray:
        return self.arr[tuple(cell)][:-1]


def save_curve(curve: np.ndarray, title: str, npy_dir: str) -> str:
    """wzRec npy persistence (utils.py:1005-1051)."""
    os.makedirs(npy_dir, exist_ok=True)
    path = os.path.join(npy_dir, f"{title}.npy")
    np.save(path, np.asarray(curve))
    return path


def load_curve(title: str, npy_dir: str) -> np.ndarray:
    return np.load(os.path.join(npy_dir, f"{title}.npy"))


def plot_curve(curve: np.ndarray, title: str, fig_dir: str,
               smooth_window: int = 0) -> str:
    """wzRec figure persistence (utils.py:1005-1069 plot_many/wzRec): one
    PNG per curve, optional moving-average smoothing like the reference's
    ``smoothen`` option. Headless (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = np.asarray(curve, dtype=float)
    os.makedirs(fig_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(c, lw=1.0, label=title)
    if smooth_window > 1 and len(c) >= smooth_window:
        kernel = np.ones(smooth_window) / smooth_window
        sm = np.convolve(c, kernel, mode="valid")
        ax.plot(np.arange(smooth_window - 1, len(c)), sm, lw=2.0,
                label=f"{title} (ma{smooth_window})")
    ax.set_xlabel("epoch")
    ax.set_title(title)
    ax.legend(fontsize=8)
    path = os.path.join(fig_dir, f"{title}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
