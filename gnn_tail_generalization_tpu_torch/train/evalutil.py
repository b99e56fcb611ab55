"""Accuracy evaluators incl. the head/tail/isolation breakdown.

The port of ``gnn_tail_generalization_tpu/train/evalutil.py`` (the
reference's ``trainer_node_classification.py:672-693`` and ``226-235``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def masked_accuracy(logits: torch.Tensor, y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax accuracy, optionally over a boolean mask; 0 over no rows."""
    correct = (logits.argmax(dim=1) == y).float()
    if mask is None:
        return correct.sum() / max(correct.numel(), 1)
    m = mask.float()
    return (correct * m).sum() / m.sum().clamp(min=1.0)


def headtail_accuracies(logits_full: torch.Tensor, y: torch.Tensor,
                        train_mask: torch.Tensor, large_mask: torch.Tensor,
                        small_mask: torch.Tensor,
                        zero_mask: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """Test accuracies (x100) over the head, tail and isolation subsets:
    each subset's nodes outside the train mask."""
    test = ~train_mask
    out = {"head": masked_accuracy(logits_full, y, large_mask & test) * 100.0,
           "tail": masked_accuracy(logits_full, y, small_mask & test) * 100.0}
    if zero_mask is not None:
        out["iso"] = masked_accuracy(logits_full, y, zero_mask & test) * 100.0
    return out
