"""The trick-combination GCN backbone (TricksComb equivalent).

The port of ``gnn_tail_generalization_tpu/nn/backbone.py`` (the reference's
``GNN_model/GCN.py:18-150``).

Layer plan:
- no residual trick: conv0 feats->hidden (SE flag [0]); middle convs
  hidden->hidden (SE [1]); last conv hidden->num_classes (SE [2]); relu after
  every layer except the last. With one layer the single conv is the first
  one (feats->hidden).
- with a residual trick ('Jumping', 'Initial', 'Residual' or 'Dense'
  substring): input Dense feats->hidden + relu first, ALL convs
  hidden->hidden with SE flag [1], relu every layer, the connection after
  each (initial, residual or a ``DenseConnection``), and after the loop a
  hidden->num_classes Dense (``out_mlp``) or, under 'Jumping', the jumping
  aggregation over every layer's output.

Per layer: feature dropout -> conv -> norm (only when the trick string is
exactly a norm name, ``norm_applies``) -> (collect SE target) -> relu ->
connection.

With ``apply_graph_dropout`` a train-mode forward draws per-layer edge masks
(nn/graph_dropout.py) from its ``graph_generator`` and runs each conv on its
masked graph; eval mode keeps the full graph.

On a sharded graph (``parallel/distgraph.py:ShardedGraph``: a ``DistGraph``
or ``parallel/hier.py:HierGraph``) the forward runs on the rank's rows: the
convs ring, the norms reduce over every rank, and the graph-dropout masks
are drawn over the canonical edge list, the same on every rank. Built with
the model axis of a 2-D mesh (``model_comm``), the convs, the input Dense,
``out_mlp`` and the dense and jumping aggregations are column-parallel
where that axis splits their output width (``nn/gcn.py``, ``nn/mlp.py:
ColumnLinear``); activations stay whole, and the norms reduce over the
graph axis (``comm_of(g)``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..graph.core import Graph
from ..parallel.distgraph import comm_of
from . import graph_dropout as gd
from .dropout import dropout
from .gcn import GCNConv
from .mlp import dense_layer
from .norms import NormLayer, groupnorm_presets, norm_applies, norm_kind_of
from .residual import DenseConnection, initial_connection, residual_connection


def _contains_any(s: str, subs) -> bool:
    return any(t in s for t in subs)


class TricksCombBackbone(nn.Module):
    def __init__(self, num_feats: int, num_classes: int, dim_hidden: int,
                 num_layers: int, n_node: int, *, type_trick: str = "",
                 res_alpha: float = 0.1, dropout: float = 0.5,
                 layer_agg: str = "concat",
                 whetherHasSE: Tuple[int, int, int] = (0, 0, 0),
                 node_norm_type: str = "n", skip_weight: Optional[float] = None,
                 num_groups: Optional[int] = None, dataset: str = "",
                 type_model: str = "GCN", spmm_method: str = "auto",
                 apply_graph_dropout: bool = False, graph_dropout: float = 0.2,
                 layerwise_dropout: bool = False,
                 generator: Optional[torch.Generator] = None,
                 model_comm=None):
        super().__init__()
        self.type_trick = type_trick
        self.res_alpha = res_alpha
        self.dropout = dropout
        self.num_layers = num_layers
        self.apply_graph_dropout = apply_graph_dropout
        self.graph_dropout = graph_dropout
        self.layerwise_dropout = layerwise_dropout
        self.has_residual_mlp = _contains_any(
            type_trick, ["Jumping", "Initial", "Residual", "Dense"])
        kind = norm_kind_of(type_trick)
        if kind in ("GroupNorm", "CombNorm") and (skip_weight is None
                                                  or num_groups is None):
            skip_weight, num_groups = groupnorm_presets(dataset, type_model,
                                                        num_layers)

        res = self.has_residual_mlp
        if res:
            self.input_dense = dense_layer(num_feats, dim_hidden, generator,
                                           model_comm=model_comm)
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
                                 spmm_method=spmm_method, generator=generator,
                                 model_comm=model_comm))
        self.convs = nn.ModuleList(convs)
        # each norm is as wide as the conv before it (flax infers the width)
        self.norms = (nn.ModuleList(
            NormLayer(kind, c.out_feats, node_norm_type, skip_weight,
                      num_groups, generator) for c in convs)
            if norm_applies(type_trick) else None)
        # layer i aggregates the input Dense's output and i + 1 conv outputs
        self.dense_aggs = (nn.ModuleList(
            DenseConnection(dim_hidden, dim_hidden, i + 2, layer_agg, generator,
                            model_comm)
            for i in range(num_layers))
            if res and self._connection() == "Dense" else None)
        self.jumping_agg = self.out_mlp = None
        if res and "Jumping" in type_trick:
            self.jumping_agg = DenseConnection(dim_hidden, num_classes,
                                               num_layers + 1, layer_agg,
                                               generator, model_comm)
        elif res:
            self.out_mlp = dense_layer(dim_hidden, num_classes, generator,
                                       model_comm=model_comm)

    def _connection(self) -> Optional[str]:
        """The connection after each layer: Residual, Initial or Dense (in
        that order of precedence), or None."""
        for k in ("Residual", "Initial", "Dense"):
            if k in self.type_trick:
                return k
        return None

    def forward(self, g: Graph, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                graph_generator: Optional[torch.Generator] = None,
                want_les: bool = False, g_last: Optional[Graph] = None):
        """Returns (out, se_reg_all, les). Train mode (``self.training``)
        draws dropout from ``generator`` and graph-dropout masks from
        ``graph_generator``. ``g_last``: the loss-masked final-layer view
        (graph/core.loss_masked_view), used in train mode only; the caller
        guarantees nothing row-coupling consumes the masked-out rows.
        ``want_les``: also return the concatenation of every layer's
        post-norm pre-relu activations, detached (the SEMLP part-1 target)."""
        train = self.training
        res = self.has_residual_mlp
        graphs = [g] * self.num_layers
        if g_last is not None and train and not want_les:
            graphs[-1] = g_last
        if self.apply_graph_dropout and train:
            masks = gd.per_layer_edge_masks(
                graph_generator, gd.mask_view(g), self.type_trick,
                self.graph_dropout, self.num_layers, self.layerwise_dropout, train)
            if masks is not None:
                graphs = [gd.apply_edge_mask(g, m) for m in masks]
        comm = comm_of(g)

        def drop(t):
            return dropout(t, self.dropout, train=train, generator=generator)

        x_list: List[torch.Tensor] = []
        les: List[torch.Tensor] = []
        se_reg_all = None

        if res:
            x = torch.relu(self.input_dense(drop(x)))
            x_list.append(x)

        connection = self._connection()
        for i, conv in enumerate(self.convs):
            x, se_reg = conv(graphs[i], drop(x))
            if se_reg is not None:
                se_reg_all = se_reg if se_reg_all is None else se_reg_all + se_reg
            if self.norms is not None:
                x = self.norms[i](x, comm)
            if want_les:
                les.append(x.detach())
            if res or i < self.num_layers - 1:
                x = torch.relu(x)
            x_list.append(x)
            if connection == "Residual":
                x = residual_connection(x_list, self.res_alpha)
            elif connection == "Initial":
                x = initial_connection(x_list, self.res_alpha)
            elif connection == "Dense":
                x = self.dense_aggs[i](x_list)

        x = drop(x)
        if self.jumping_agg is not None:
            x = self.jumping_agg(x_list)
        elif res:
            x = self.out_mlp(x)
        les_cat = torch.cat(les, dim=-1) if want_les else None
        return x, se_reg_all, les_cat
