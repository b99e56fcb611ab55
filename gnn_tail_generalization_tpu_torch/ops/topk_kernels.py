"""The single-pass top-K kernel and its plain PyTorch version.

``(values, indices)`` of the K largest scores of each row of an f32
``[n_rows, n_cols]`` matrix, ordered as ``jax.lax.top_k`` orders them:
score descending, and among exactly equal scores the lower index first.

- ``topk_rows_f32`` launches the CUDA kernel of ``csrc/topk_select.cu``
  (1 <= K <= ``MAX_K``); that file's header says what bounds it on the
  card and how the design answers it. It replaces no TPU kernel: the JAX
  package selects with ``jax.lax.top_k`` in plain XLA.
- ``top_k_plain`` is the plain version: ``torch.topk``, then the rows whose
  K-th score is tied with one outside the selection re-selected by a stable
  sort (``torch.topk`` promises no order on ties; finding those rows reads
  one flag a call back to the host, ``gnn.replace.read``, counted in
  ``host_syncs``), and the K put in the order above.

``ops/topk_attention.py:top_k_lowest_index`` takes the plain version for a
CPU tensor and the kernel for a CUDA one, which launches or raises.
``ops/_build.py:LAUNCHES`` counts the kernel's launches, and each launch
also counts in the recorder's ``replace.select_calls`` (``utils/debug.py``).
"""
from __future__ import annotations

import torch

from ..utils import debug
from . import _build

MAX_K = 32  # the kernel is instantiated for 1 <= K <= 32


def top_k_plain(scores: torch.Tensor, k: int):
    """The plain version, on any device and for any K."""
    vals, idx = torch.topk(scores, k, dim=1)
    # rows whose K-th value also occurs outside the selection: the set of
    # indices torch picked among the tied ones is unspecified
    tied = (scores >= vals[:, -1:]).sum(dim=1) > k
    with debug.host_read("gnn.replace.read"):
        any_tied = bool(tied.any())
    if any_tied:
        with debug.host_read("gnn.replace.read"):
            rows = tied.nonzero()[:, 0]
        order = torch.sort(scores[rows], dim=1, descending=True, stable=True)[1]
        idx[rows] = order[:, :k]
        vals[rows] = scores[rows[:, None], idx[rows]]
    # canonical order of the K: index ascending, then a stable sort by value
    idx, perm = torch.sort(idx, dim=1)
    vals = vals.gather(1, perm)
    vals, perm = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, idx.gather(1, perm)


def check_rows(scores: torch.Tensor, k: int) -> None:
    """Raises unless the kernel takes ``scores`` and ``k``: a contiguous 2-D
    float32 matrix of at least ``k`` columns, 1 <= k <= ``MAX_K``, and both
    sizes within int32 indexing. Needs no card."""
    if scores.dtype != torch.float32:
        raise TypeError(f"topk_rows_f32 takes float32 scores, got {scores.dtype}")
    if scores.dim() != 2:
        raise ValueError(f"scores must be 2-D, got shape {tuple(scores.shape)}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= k <= {MAX_K}, got k={k}")
    n_rows, n_cols = scores.shape
    if n_cols < k:
        raise ValueError(f"k={k} exceeds the {n_cols} columns")
    if n_rows >= 2**31 or n_cols >= 2**31:
        raise ValueError("sizes outside the kernel's int32 indexing")


def topk_rows_f32(scores: torch.Tensor, k: int):
    """The kernel on a CUDA tensor: (values [n_rows, k] f32, indices
    [n_rows, k] int64). Raises for any other device and for what
    ``check_rows`` refuses."""
    if not _build.on_cuda(scores, "top-K"):
        raise ValueError(f"no top-K kernel for device {scores.device}")
    check_rows(scores, k)
    n_rows, n_cols = scores.shape
    vals = torch.empty(n_rows, k, dtype=torch.float32, device=scores.device)
    idx = torch.empty(n_rows, k, dtype=torch.int64, device=scores.device)
    if n_rows == 0:
        return vals, idx
    _build.launch("topk_rows_f32", scores.device, scores.data_ptr(), n_rows, n_cols, n_cols,
                  k, vals.data_ptr(), idx.data_ptr(), counter="replace.select_calls")
    return vals, idx
