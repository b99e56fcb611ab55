"""The pair-scoring kernel and its plain PyTorch version.

``pair_dot(h, pairs)`` gives ``out[p] = h[pairs[p, 0]] . h[pairs[p, 1]]``
for an f32 table ``h`` [N, d] and int64 ``pairs`` [m, 2], in one call for a
whole split:

- on a CUDA tensor, one launch of the kernel of ``csrc/pair_score.cu``
  (``pair_dot_f32``; that file's header says what bounds it on the card, the
  destination rows' bytes, and how the design answers it). It replaces no
  TPU kernel: the JAX package scores in plain XLA
  (``gnn_tail_generalization_tpu/linkpred/model.py:508-522``).
- on a CPU tensor, the plain version ``pair_dot_plain``: the rows of
  ``PLAIN_CHUNK`` pairs at a time gathered, multiplied and summed, as
  ``linkpred/predictors.py:DotPredictor`` scores gathered rows.

Both refuse what the kernel does not take (``check_pairs``): there is no
fallback. ``ops/_build.py:LAUNCHES`` counts the kernel's launches, and each
launch also counts in the recorder's ``score.kernel_calls``
(``utils/debug.py``).
"""
from __future__ import annotations

import torch

from . import _build

PLAIN_CHUNK = 64 * 1024  # pairs a gather of the plain version


def pair_dot_plain(h: torch.Tensor, pairs: torch.Tensor,
                   chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """The plain version, on any device: ``chunk`` pairs' rows at a time, so
    that no [m, d] gather is made at once."""
    outs = [torch.sum(h[e[:, 0]] * h[e[:, 1]], dim=-1) for e in torch.split(pairs, chunk)]
    return torch.cat(outs) if outs else h.new_zeros(0)


def check_pairs(h: torch.Tensor, pairs: torch.Tensor) -> None:
    """Raises unless the kernel takes ``h`` and ``pairs``: a contiguous 2-D
    float32 table, contiguous int64 pairs [m, 2] on its device, and no
    gradient asked of the table (the kernel has no backward). Needs no
    card."""
    if h.dtype != torch.float32:
        raise TypeError(f"pair_dot takes a float32 table, got {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"the table must be a contiguous [N, d], got shape "
                         f"{tuple(h.shape)} with strides {h.stride()}")
    if pairs.dtype != torch.int64:
        raise TypeError(f"pair_dot takes int64 pairs, got {pairs.dtype}")
    if pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"pairs must be [m, 2], got {tuple(pairs.shape)}")
    if not pairs.is_contiguous():
        raise ValueError("pairs must be contiguous")
    if pairs.device != h.device:
        raise ValueError(f"pairs are on {pairs.device}, the table on {h.device}")
    if torch.is_grad_enabled() and h.requires_grad:
        raise RuntimeError("pair_dot has no backward: call it under torch.no_grad() "
                           "or on a table that needs no gradient")


def pair_dot(h: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """The scores [m] f32 of ``pairs``: the kernel on a CUDA tensor, the plain
    version on a CPU one; raises for any other device and for what
    ``check_pairs`` refuses."""
    check_pairs(h, pairs)
    if not _build.on_cuda(h, "pair-scoring"):
        return pair_dot_plain(h, pairs)
    if pairs.data_ptr() % 16:
        raise ValueError("the kernel reads a pair with one 16-byte load: pairs must "
                         "start 16-byte aligned")
    m = pairs.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=h.device)
    if m == 0:
        return out
    _build.launch("pair_dot_f32", h.device, h.data_ptr(), pairs.data_ptr(), out.data_ptr(),
                  h.shape[0], m, h.shape[1], counter="score.kernel_calls")
    return out
