"""Mutual-information estimation measures (f-divergence expectations).

The port of ``gnn_tail_generalization_tpu/baselines/mi.py`` (the reference's
``Link_prediction_baseline/models/utils.py:12-156``: the Deep-InfoMax
measure zoo of the EGI/SubGI loss, and the MINE statistic network).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.mlp import dense_layer

_LOG2 = math.log(2.0)
MEASURES = ("GAN", "JSD", "X2", "KL", "RKL", "DV", "H2", "W1")


def positive_expectation(p_samples: torch.Tensor, measure: str,
                         average: bool = True) -> torch.Tensor:
    if measure == "GAN":
        ep = -F.softplus(-p_samples)
    elif measure == "JSD":
        ep = _LOG2 - F.softplus(-p_samples)
    elif measure == "X2":
        ep = p_samples**2
    elif measure == "KL":
        ep = p_samples + 1.0
    elif measure == "RKL":
        ep = -torch.exp(-p_samples)
    elif measure in ("DV", "W1"):
        ep = p_samples
    elif measure == "H2":
        ep = 1.0 - torch.exp(-p_samples)
    else:
        raise ValueError(measure)
    return ep.mean() if average else ep


def negative_expectation(q_samples: torch.Tensor, measure: str,
                         average: bool = True) -> torch.Tensor:
    """'DV' reduces to a scalar logsumexp whatever ``average`` is (the
    reference's formula, models/utils.py:144-145): it is not per-sample
    decomposable, so it does not combine with masked sums."""
    if measure == "GAN":
        eq = F.softplus(-q_samples) + q_samples
    elif measure == "JSD":
        eq = F.softplus(-q_samples) + q_samples - _LOG2
    elif measure == "X2":
        eq = -0.5 * ((torch.sqrt(q_samples**2) + 1.0) ** 2)
    elif measure == "KL":
        eq = torch.exp(q_samples)
    elif measure == "RKL":
        eq = q_samples - 1.0
    elif measure == "DV":
        return (torch.logsumexp(q_samples.reshape(-1), 0)
                - math.log(q_samples.numel()))
    elif measure == "H2":
        eq = torch.exp(q_samples) - 1.0
    elif measure == "W1":
        eq = q_samples
    else:
        raise ValueError(measure)
    return eq.mean() if average else eq


def fenchel_dual_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                      measure: str = "JSD") -> torch.Tensor:
    """E_neg - E_pos (minimize => maximize the MI lower bound)."""
    return (negative_expectation(neg_scores, measure)
            - positive_expectation(pos_scores, measure))


class Mine(nn.Module):
    """MINE statistic network (models/utils.py:12-30): relu(Dense) twice,
    then Dense(1), on ``[x; y]``. ``in_dim`` is the width of ``[x; y]``
    (flax infers it)."""

    def __init__(self, in_dim: int, hidden: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList(dense_layer(a, b, generator) for a, b in
                                   ((in_dim, hidden), (hidden, hidden), (hidden, 1)))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, y], dim=-1)
        h = F.relu(self.dense[0](h))
        h = F.relu(self.dense[1](h))
        return self.dense[2](h)[..., 0]
