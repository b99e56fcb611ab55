"""Accuracy evaluators incl. the head/tail/isolation breakdown.

The port of ``gnn_tail_generalization_tpu/train/evalutil.py`` (the
reference's ``trainer_node_classification.py:672-693`` and ``226-235``).
With ``comm`` the rows are one rank's shard (``parallel/distgraph.py``): the
correct count and the total are summed over the ranks before the ratio.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel.comm import Comm


def masked_accuracy(logits: torch.Tensor, y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    comm: Optional[Comm] = None) -> torch.Tensor:
    """argmax accuracy, optionally over a boolean mask; 0 over no rows."""
    correct = (logits.argmax(dim=1) == y).float()
    if mask is None and comm is None:
        return correct.sum() / max(correct.numel(), 1)
    m = torch.ones_like(correct) if mask is None else mask.float()
    counts = torch.stack([(correct * m).sum(), m.sum()])
    if comm is not None:
        comm.all_reduce_sum_(counts)
    return counts[0] / counts[1].clamp(min=1.0)


def headtail_accuracies(logits_full: torch.Tensor, y: torch.Tensor,
                        train_mask: torch.Tensor, large_mask: torch.Tensor,
                        small_mask: torch.Tensor,
                        zero_mask: Optional[torch.Tensor] = None,
                        comm: Optional[Comm] = None) -> Dict[str, torch.Tensor]:
    """Test accuracies (x100) over the head, tail and isolation subsets:
    each subset's nodes outside the train mask."""
    test = ~train_mask
    out = {"head": masked_accuracy(logits_full, y, large_mask & test, comm) * 100.0,
           "tail": masked_accuracy(logits_full, y, small_mask & test, comm) * 100.0}
    if zero_mask is not None:
        out["iso"] = masked_accuracy(logits_full, y, zero_mask & test, comm) * 100.0
    return out
