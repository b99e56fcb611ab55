"""The trick-combination GCN backbone (TricksComb equivalent).

The port of ``gnn_tail_generalization_tpu/nn/backbone.py`` (the reference's
``GNN_model/GCN.py:18-150``).

Layer plan:
- no residual trick: conv0 feats->hidden (SE flag [0]); middle convs
  hidden->hidden (SE [1]); last conv hidden->num_classes (SE [2]); relu after
  every layer except the last. With one layer the single conv is the first
  one (feats->hidden).
- with an 'Initial' or 'Residual' trick: input Dense feats->hidden + relu
  first, ALL convs hidden->hidden with SE flag [1], relu every layer, the
  connection after each, and a final hidden->num_classes Dense (``out_mlp``).

Per layer: feature dropout -> conv -> (collect SE target) -> relu ->
residual aggregation.

Not ported yet, and raising ``NotImplementedError``: trick strings that apply a
norm layer (``nn/norms.py:norm_applies``), graph dropout
(``apply_graph_dropout``), and the Dense and Jumping tricks (ROADMAP A3).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..graph.core import Graph
from .dropout import dropout
from .gcn import GCNConv
from .mlp import dense_layer
from .norms import norm_applies
from .residual import initial_connection, residual_connection

class TricksCombBackbone(nn.Module):
    def __init__(self, num_feats: int, num_classes: int, dim_hidden: int,
                 num_layers: int, n_node: int, *, type_trick: str = "",
                 res_alpha: float = 0.1, dropout: float = 0.5,
                 whetherHasSE: Tuple[int, int, int] = (0, 0, 0),
                 spmm_method: str = "auto", apply_graph_dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm_applies(type_trick):
            raise NotImplementedError(
                f"type_trick={type_trick!r} applies a norm layer; the norm "
                "layers are not ported yet (ROADMAP A3, norms)")
        if apply_graph_dropout:
            raise NotImplementedError(
                "apply_graph_dropout: graph dropout is not ported yet "
                "(ROADMAP A3, graph dropout)")
        if "Dense" in type_trick or "Jumping" in type_trick:
            raise NotImplementedError(
                f"type_trick={type_trick!r}: DenseConnection is not ported "
                "yet (ROADMAP A3, DenseConnection)")
        self.type_trick = type_trick
        self.res_alpha = res_alpha
        self.dropout = dropout
        self.num_layers = num_layers
        self.has_residual_mlp = "Initial" in type_trick or "Residual" in type_trick

        res = self.has_residual_mlp
        if res:
            self.input_dense = dense_layer(num_feats, dim_hidden, generator)
        convs = []
        for i in range(num_layers):
            if res:
                d_out, has_se = dim_hidden, whetherHasSE[1]
            elif i == 0:
                d_out, has_se = dim_hidden, whetherHasSE[0]
            elif i < num_layers - 1:
                d_out, has_se = dim_hidden, whetherHasSE[1]
            else:
                d_out, has_se = num_classes, whetherHasSE[2]
            d_in = dim_hidden if (res or i > 0) else num_feats
            convs.append(GCNConv(d_in, d_out, n_node, has_se=bool(has_se),
                                 spmm_method=spmm_method, generator=generator))
        self.convs = nn.ModuleList(convs)
        if res:
            self.out_mlp = dense_layer(dim_hidden, num_classes, generator)

    def forward(self, g: Graph, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                want_les: bool = False, g_last: Optional[Graph] = None):
        """Returns (out, se_reg_all, les). Train mode (``self.training``)
        draws dropout from ``generator``. ``g_last``: the loss-masked
        final-layer view (graph/core.loss_masked_view), used in train mode
        only; the caller guarantees nothing row-coupling consumes the
        masked-out rows. ``want_les``: also return the concatenation of every
        layer's pre-relu activations, detached (the SEMLP part-1 target)."""
        train = self.training
        res = self.has_residual_mlp
        graphs = [g] * self.num_layers
        if g_last is not None and train and not want_les:
            graphs[-1] = g_last

        def drop(t):
            return dropout(t, self.dropout, train=train, generator=generator)

        x_list: List[torch.Tensor] = []
        les: List[torch.Tensor] = []
        se_reg_all = None

        if res:
            x = torch.relu(self.input_dense(drop(x)))
            x_list.append(x)

        for i, conv in enumerate(self.convs):
            x, se_reg = conv(graphs[i], drop(x))
            if se_reg is not None:
                se_reg_all = se_reg if se_reg_all is None else se_reg_all + se_reg
            if want_les:
                les.append(x.detach())
            if res or i < self.num_layers - 1:
                x = torch.relu(x)
            x_list.append(x)
            if "Residual" in self.type_trick:
                x = residual_connection(x_list, self.res_alpha)
            elif "Initial" in self.type_trick:
                x = initial_connection(x_list, self.res_alpha)

        x = drop(x)
        if res:
            x = self.out_mlp(x)
        les_cat = torch.cat(les, dim=-1) if want_les else None
        return x, se_reg_all, les_cat
