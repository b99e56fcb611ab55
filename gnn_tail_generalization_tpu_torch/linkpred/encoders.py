"""Link-prediction encoders: MLP / SAGE / GCN / WSAGE / Transformer.

The port of ``gnn_tail_generalization_tpu/linkpred/encoders.py`` (the
reference's ``Link_prediction_model/layer.py:19-83``: PyG conv stacks,
relu+dropout between layers, no activation after the last).

Conv semantics (the PyG layers the reference instantiates):
- SAGEConv:   h = W_l x + W_r mean_{j in N(i)} x_j         (mean aggr, root)
- GCNConv(normalize=False): h = W (A @ x) + b              (A as given; the
  trainer pre-normalizes with ``gcn_norm_weights``)
- GraphConv (WSAGE): h = W_1 x + W_2 sum_{j in N(i)} x_j   (sum aggr)
- TransformerConv: single-head dot-product attention over in-edges

Every aggregation runs through ``ops/spmm.py:spmm``, so the CUDA CSR
kernels on the card. The attention is ``ops/edge_attention.py``'s op on the
forward CSR (the edges of row r are its in-edges, their sources
``indices``): the edge-softmax kernel and B1 on the card, with no ``[E, d]``
tensor. flax infers input widths; here each layer takes ``in_channels``.

Under ``pallas_bf16`` the SAGE, WSAGE and GCN Dense layers compute in bf16,
as the JAX package's ``dtype=bfloat16`` Dense does: operands and parameters
rounded to bf16, the product and then the bias add each rounded to bf16,
and the SAGE/WSAGE sum of the two Dense outputs taken in bf16 before the
cast to f32. These are ``torch.matmul`` products; the JAX package computes
them outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.core import Graph
from ..nn.dropout import dropout as _dropout
from ..nn.mlp import dense_layer
from ..ops.edge_attention import edge_attention
from ..ops.spmm import spmm


def _mean_agg(g: Graph, x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    s = spmm(g, x, method)
    deg = torch.clamp(g.deg_in, min=1.0)
    return s / deg[:, None].to(s.dtype)


def _dense_dtype(spmm_method: str) -> Optional[torch.dtype]:
    """bf16 Dense layers where the aggregation already runs on bf16
    operands."""
    return torch.bfloat16 if spmm_method == "pallas_bf16" else None


def _dense(lin: nn.Linear, x: torch.Tensor, dt: Optional[torch.dtype]
           ) -> torch.Tensor:
    """``lin(x)``; with ``dt``, flax's ``nn.Dense(dtype=dt)``: x, kernel and
    bias cast to ``dt``, the output of the product and of the bias add each
    in ``dt``."""
    if dt is None:
        return lin(x)
    y = torch.matmul(x.to(dt), lin.weight.to(dt).t())
    return y if lin.bias is None else y + lin.bias.to(dt)


class SAGEConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 spmm_method: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spmm_method = spmm_method
        self.root = dense_layer(in_channels, out_channels, generator)
        self.neigh = dense_layer(in_channels, out_channels, generator, bias=False)

    def forward(self, g: Graph, x: torch.Tensor,
                agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        if agg is None:
            agg = self.aggregate(g, x)
        dt = _dense_dtype(self.spmm_method)
        return (_dense(self.root, x, dt) + _dense(self.neigh, agg, dt)).float()

    def aggregate(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return _mean_agg(g, x, self.spmm_method)


class WSAGEConv(SAGEConv):
    """PyG GraphConv: root Dense + sum-aggregated Dense."""

    def aggregate(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return spmm(g, x, self.spmm_method)


class GCNConvRaw(nn.Module):
    """PyG GCNConv(normalize=False): aggregate with the (pre-normalized)
    adjacency weights baked into the graph.

    ``agg``: optional precomputed ``spmm(g, x)`` over the RAW input
    (A @ (x W) == (A @ x) W), see :func:`hoisted_first_agg`."""

    def __init__(self, in_channels: int, out_channels: int,
                 spmm_method: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spmm_method = spmm_method
        self.lin = dense_layer(in_channels, out_channels, generator, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, g: Graph, x: torch.Tensor,
                agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = _dense_dtype(self.spmm_method)
        if agg is None:
            y = spmm(g, _dense(self.lin, x, dt), self.spmm_method)
        else:
            y = _dense(self.lin, agg, dt)
        return (y + self.bias).float()


class TransformerConv(nn.Module):
    """Single-head TransformerConv (layer.py:77-83): per-edge attention
    alpha_e = softmax_{e into dst}(q[dst] . k[src] / sqrt(d)), and the skip
    connection of PyG's ``root_weight=True``. A row with no in-edge
    aggregates to 0 before the skip. The Dense layers stay f32 under every
    method, as in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int,
                 spmm_method: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spmm_method = spmm_method  # accepted for factory uniformity
        self.query = dense_layer(in_channels, out_channels, generator)
        self.key = dense_layer(in_channels, out_channels, generator)
        self.value = dense_layer(in_channels, out_channels, generator)
        self.skip = dense_layer(in_channels, out_channels, generator)

    def forward(self, g: Graph, x: torch.Tensor, agg=None) -> torch.Tensor:
        return edge_attention(g, self.query(x), self.key(x), self.value(x)) + self.skip(x)


_CONVS = {
    "SAGE": SAGEConv,
    "GCN": GCNConvRaw,
    "WSAGE": WSAGEConv,
    "Transformer": TransformerConv,
}


def hoistable(kind: str) -> bool:
    """Conv kinds whose FIRST layer aggregation is a pure function of the
    input features (no parameters before the SpMM): SAGE/WSAGE aggregate
    raw x; GCN's ``A @ (x W) == (A @ x) W``. Transformer's attention
    weights depend on params; MLP has no aggregation."""
    return kind in ("SAGE", "WSAGE", "GCN")


def hoisted_first_agg(kind: str, g: Graph, x: torch.Tensor,
                      spmm_method: str = "auto") -> torch.Tensor:
    """The layer-1 aggregation as a constant, for encoders whose input
    features are static across training steps (use_node_feats without a
    trainable embedding). The reference re-aggregates the SAME input every
    minibatch; hoisting this loop invariant removes one of the three SpMMs
    from every train step with the same aggregation output (same kernel,
    same operands)."""
    if not hoistable(kind):
        raise ValueError(f"the {kind} encoder has no hoistable aggregation")
    if kind == "SAGE":
        return _mean_agg(g, x, spmm_method)
    return spmm(g, x, spmm_method)  # WSAGE sum / GCN pre-normalized A @ x


class GNNEncoder(nn.Module):
    """BaseGNN stack (layer.py:19-35): conv -> relu -> dropout between
    layers, bare conv at the end; ``layers`` numbered as flax numbers its
    convs. kind='MLP' uses Dense layers and ignores g.

    ``agg0``: optional precomputed layer-1 aggregation (hoisted_first_agg),
    only valid when the input features are constant under training."""

    def __init__(self, kind: str, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, dropout: float = 0.0,
                 spmm_method: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind != "MLP" and kind not in _CONVS:
            raise ValueError(f"unknown encoder {kind!r}")
        self.kind = kind
        self.dropout = dropout
        widths = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        self.layers = nn.ModuleList(
            dense_layer(a, b, generator) if kind == "MLP"
            else _CONVS[kind](a, b, spmm_method=spmm_method, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, g: Graph, x: torch.Tensor, *,
                agg0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if agg0 is not None and not hoistable(self.kind):
            raise ValueError(f"the {self.kind} encoder takes no agg0")
        for i, layer in enumerate(self.layers):
            if self.kind == "MLP":
                x = layer(x)
            else:
                x = layer(g, x, agg0 if i == 0 else None)
            if i < len(self.layers) - 1:
                x = _dropout(F.relu(x), self.dropout, train=self.training,
                             generator=generator)
        return x
