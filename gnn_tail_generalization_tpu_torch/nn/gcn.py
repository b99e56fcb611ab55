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

On a ``DistGraph`` the conv runs on the rank's rows: its degrees are the
rank's rows of the degree vectors, the SE table holds the rank's rows
(``parallel/distgraph.py:ROW_SHARDED``) and its norm sums the squares over
the ranks.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..graph.core import Graph
from ..ops.spmm import round_bf16, spmm
from ..parallel.comm import Comm
from ..parallel.distgraph import DistGraph, comm_of


def frobenius_norm(t: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
    """||t||_F (not squared); with ``comm``, of the table whose rows the
    ranks hold between them (one differentiable sum of the squares)."""
    if comm is None:
        return torch.linalg.vector_norm(t)
    return torch.sqrt(comm.all_reduce_sum(t.square().sum()))


class GCNConv(nn.Module):
    """``weight`` keeps the JAX layout ``[in, out]``; init xavier-uniform,
    SE normal with std 1, bias zero."""

    def __init__(self, in_feats: int, out_feats: int, n_node: int, *,
                 has_se: bool = False, spmm_method: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spmm_method = spmm_method
        self.weight = nn.Parameter(torch.empty(in_feats, out_feats))
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if has_se:
            self.se = nn.Parameter(torch.empty(n_node, out_feats))
            nn.init.normal_(self.se, std=1.0, generator=generator)
        else:
            self.register_parameter("se", None)
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, g: Union[Graph, DistGraph], x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = x * g.deg_out.clamp(min=1.0).pow(-0.5)[:, None]
        if self.spmm_method == "pallas_bf16":
            # the aggregation rounds its operands to bf16, so the dense
            # matmul takes bf16 operands too; product and result stay f32
            h = round_bf16(h) @ round_bf16(self.weight)
        else:
            h = h @ self.weight

        se_reg = None
        if self.se is not None:
            h = h + self.se
            se_reg = frobenius_norm(self.se, comm_of(g))

        y = spmm(g, h, self.spmm_method)
        y = y * g.deg_in.clamp(min=1.0).pow(-0.5)[:, None]
        return y + self.bias, se_reg
