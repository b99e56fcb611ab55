"""Residual, initial, dense and jumping connection tricks.

The port of ``gnn_tail_generalization_tpu/nn/residual.py`` (the reference's
``GNN_model/res_tricks.py:7-55``):
- residual: (1-a) X_l + a X_{l-1}
- initial:  (1-a) X_l + a X_0
- DenseConnection: concat + Linear | maxpool | sigmoid attention over the
  whole collected layer list (also the Jumping aggregation, GCN.py:73-79).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .mlp import dense_layer


def residual_connection(xs: List[torch.Tensor], alpha: float) -> torch.Tensor:
    if len(xs) == 1:
        return xs[-1]
    return (1 - alpha) * xs[-1] + alpha * xs[-2]


def initial_connection(xs: List[torch.Tensor], alpha: float) -> torch.Tensor:
    if len(xs) == 1:
        return xs[-1]
    return (1 - alpha) * xs[-1] + alpha * xs[0]


class DenseConnection(nn.Module):
    """Aggregates ``n_inputs`` layer outputs, each ``[N, in_dim]``. concat:
    one Linear from the concatenation to ``out_dim``; maxpool: the
    elementwise max (``[N, in_dim]``); attention: each input weighted by
    sigmoid(Dense(1)) of itself and summed (``[N, in_dim]``). flax infers
    the Linear's input width; torch takes it here. ``model_comm``: the model
    axis of a 2-D mesh (``dense_layer``)."""

    def __init__(self, in_dim: int, out_dim: int, n_inputs: int,
                 aggregation: str = "concat",
                 generator: Optional[torch.Generator] = None,
                 model_comm=None):
        super().__init__()
        self.aggregation = aggregation
        if aggregation == "concat":
            self.lin = dense_layer(in_dim * n_inputs, out_dim, generator,
                                   model_comm=model_comm)
        elif aggregation == "attention":
            self.lin = dense_layer(in_dim, 1, generator, model_comm=model_comm)
        elif aggregation == "maxpool":
            self.lin = None
        else:
            raise ValueError(aggregation)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        if self.aggregation == "concat":
            return self.lin(torch.cat(xs, dim=-1))
        if self.aggregation == "maxpool":
            return torch.stack(xs, dim=-1).amax(dim=-1)
        pps = torch.stack(xs, dim=1)  # [N, L, C]
        retain = torch.sigmoid(self.lin(pps)[..., 0])[:, None, :]  # [N, 1, L]
        return torch.matmul(retain, pps)[:, 0, :]
