"""Shared encoders of the self-supervised baselines: GIN and SAGE stacks.

The port of ``gnn_tail_generalization_tpu/baselines/encoders.py`` (the
reference's DGL GIN encoder of DGI/EGI, ``models/dgi.py``, and the SAGE
towers of its VGAE, ``models/vgae.py:37-80``). Every aggregation runs through
``ops/spmm.py:spmm``: on the card, on a graph without ``dense_adj``, the f32
CUDA CSR kernel. flax infers input widths; here each layer takes ``in_dim``.
Batch norms run in train mode while the module is in ``train()`` mode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.core import Graph
from ..nn.mlp import dense_layer
from ..nn.norms import BatchNorm
from ..ops.spmm import spmm

#: flax ``nn.BatchNorm``'s default momentum, which ``GINLayer`` keeps
GIN_BN_DECAY = 0.99


class GINLayer(nn.Module):
    """h' = relu(BN(Dense_1(relu(Dense_0((1 + eps) h + sum_{j in N(i)} h_j)))))
    with a learnable scalar ``eps`` (init 0) and flax's default batch norm
    (momentum 0.99)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hid = hidden_dim or out_dim
        self.eps = nn.Parameter(torch.zeros(()))
        self.dense = nn.ModuleList([dense_layer(in_dim, hid, generator),
                                    dense_layer(hid, out_dim, generator)])
        self.bn = BatchNorm(out_dim, decay=GIN_BN_DECAY)

    def forward(self, g: Graph, h: torch.Tensor) -> torch.Tensor:
        z = (1.0 + self.eps) * h + spmm(g, h)
        z = self.dense[1](F.relu(self.dense[0](z)))
        return F.relu(self.bn(z))


class GINEncoder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            GINLayer(in_dim if i == 0 else hidden_dim, hidden_dim, generator=generator)
            for i in range(num_layers))

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(g, h)
        return h


class MeanSAGELayer(nn.Module):
    """Dense([h; mean_{j in N(i)} h_j]), in-degree clamped to >= 1, then
    relu unless ``activation`` is off."""

    def __init__(self, in_dim: int, out_dim: int, activation: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.lin = dense_layer(2 * in_dim, out_dim, generator)

    def forward(self, g: Graph, h: torch.Tensor) -> torch.Tensor:
        agg = spmm(g, h) / torch.clamp(g.deg_in, min=1.0)[:, None]
        z = self.lin(torch.cat([h, agg], dim=-1))
        return F.relu(z) if self.activation else z


class GCNSAGELayer(nn.Module):
    """dgl SAGEConv(aggregator_type='gcn'): W((sum_neighbours + h_self) /
    (deg_in + 1)), one weight, no self-concat (the reference VGAE's tower,
    vgae.py:45-47); ``deg_in`` counts the pipeline's self loops."""

    def __init__(self, in_dim: int, out_dim: int, activation: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.lin = dense_layer(in_dim, out_dim, generator)

    def forward(self, g: Graph, h: torch.Tensor) -> torch.Tensor:
        agg = (spmm(g, h) + h) / (g.deg_in + 1.0)[:, None]
        z = self.lin(agg)
        return F.relu(z) if self.activation else z
