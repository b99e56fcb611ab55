"""GCN convolution with Cold Brew Structural Embeddings (SE).

The port of ``gnn_tail_generalization_tpu/nn/gcn.py``. Math (the reference's
``GNN_model/GCN.py:228-229``):
    X^{l+1} = sigma( A_tilde ( X^l W^l + E^l ) )
with A_tilde the degree-normalized adjacency applied in DGL's split form
(``GCN.py:205-250``): scale sources by out_deg^-1/2 BEFORE the dense matmul,
aggregate, scale destinations by in_deg^-1/2 AFTER — degrees clamped >= 1.
E^l in R^{N x d_out} is the learnable structural embedding, added AFTER the
weight matmul / source scaling, and its Frobenius norm (not squared) is
returned for the se_reg loss term.

On a sharded graph (``parallel/distgraph.py:ShardedGraph``) the conv runs
on the rank's rows: its degrees are the rank's rows of the degree vectors,
the SE table holds the rank's rows (``parallel/distgraph.py:ROW_SHARDED``)
and its norm sums the squares over the ranks. Built with the model axis of a
2-D mesh (``model_comm``) that splits ``out_feats``, the kernel and the SE
table hold this model shard's columns (JAX ``shard_params :708-716``): the
input enters through ``copy_to`` (its gradient summed over the model axis),
the slice rings through ``dist_spmm_cols`` and comes back whole, and the
SE norm sums the squares over both axes.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..graph.core import Graph
from ..ops.spmm import round_bf16, spmm
from ..parallel.comm import Comm, copy_to, own_cols, reduce_from
from ..parallel.distgraph import ShardedGraph, comm_of, dist_spmm_cols, model_cols


def frobenius_norm(t: torch.Tensor, comm: Optional[Comm] = None,
                   model_comm: Optional[Comm] = None) -> torch.Tensor:
    """||t||_F (not squared); with ``comm``, of the table whose rows the
    ranks hold between them (one differentiable sum of the squares); with
    ``model_comm`` too, whose columns the model axis holds between them (a
    sum whose gradient is not summed: every model rank computes the loss
    whole)."""
    if comm is None and model_comm is None:
        return torch.linalg.vector_norm(t)
    sq = t.square().sum()
    if comm is not None:
        sq = comm.all_reduce_sum(sq)
    if model_comm is not None:
        sq = reduce_from(sq, model_comm)
    return torch.sqrt(sq)


class GCNConv(nn.Module):
    """``weight`` keeps the JAX layout ``[in, out]``; init xavier-uniform,
    SE normal with std 1, bias zero. ``model_comm``: the model axis of a 2-D
    mesh; where it splits ``out_feats``, the kernel and the SE table hold
    this model shard's columns of the whole ones the generator draws."""

    def __init__(self, in_feats: int, out_feats: int, n_node: int, *,
                 has_se: bool = False, spmm_method: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 model_comm: Optional[Comm] = None):
        super().__init__()
        self.spmm_method = spmm_method
        self.out_feats = out_feats
        self.model_comm = mc = model_cols(out_feats, model_comm)

        def cols(t):
            return t if mc is None else own_cols(t, mc)

        weight = torch.empty(in_feats, out_feats)
        nn.init.xavier_uniform_(weight, generator=generator)
        self.weight = nn.Parameter(cols(weight))
        if has_se:
            se = torch.empty(n_node, out_feats)
            nn.init.normal_(se, std=1.0, generator=generator)
            self.se = nn.Parameter(cols(se))
        else:
            self.register_parameter("se", None)
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, g: Union[Graph, ShardedGraph], x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        mc = self.model_comm
        h = x * g.deg_out.clamp(min=1.0).pow(-0.5)[:, None]
        w = self.weight
        if self.spmm_method == "pallas_bf16":
            # the aggregation rounds its operands to bf16, so the dense
            # matmul takes bf16 operands too; product and result stay f32.
            # Rounded before copy_to: the backward sums the model shards'
            # partial products in f32 and rounds the sum once, as one
            # device does, not each shard's part
            h, w = round_bf16(h), round_bf16(w)
        if mc is not None:
            h = copy_to(h, mc)
        h = h @ w

        se_reg = None
        if self.se is not None:
            h = h + self.se
            se_reg = frobenius_norm(self.se, comm_of(g), mc)

        y = (spmm(g, h, self.spmm_method) if mc is None
             else dist_spmm_cols(g, h, self.spmm_method))
        y = y * g.deg_in.clamp(min=1.0).pow(-0.5)[:, None]
        return y + self.bias, se_reg
