"""Residual and initial connection tricks.

The port of ``initial_connection`` and ``residual_connection`` of
``gnn_tail_generalization_tpu/nn/residual.py`` (the reference's
``GNN_model/res_tricks.py:7-23``):
- residual: (1-a) X_l + a X_{l-1}
- initial:  (1-a) X_l + a X_0
``DenseConnection`` (the Dense and Jumping tricks) is not ported yet
(ROADMAP A3).
"""
from __future__ import annotations

from typing import List

import torch


def residual_connection(xs: List[torch.Tensor], alpha: float) -> torch.Tensor:
    if len(xs) == 1:
        return xs[-1]
    return (1 - alpha) * xs[-1] + alpha * xs[-2]


def initial_connection(xs: List[torch.Tensor], alpha: float) -> torch.Tensor:
    if len(xs) == 1:
        return xs[-1]
    return (1 - alpha) * xs[-1] + alpha * xs[0]
