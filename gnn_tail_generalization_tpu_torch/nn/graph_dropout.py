"""Graph-dropout tricks as per-edge weight masks.

The port of ``gnn_tail_generalization_tpu/nn/graph_dropout.py`` (the
reference's ``GNN_model/drop_tricks.py``):
- DropEdge (13-24): uniform Bernoulli edge drop;
- DropNode (26-45): Bernoulli node subset, keep the edges inside it;
- FastGCN (47-69): importance-sample nodes, q(u) ∝ sum of w_e^2 over the
  edges into u, without replacement (Gumbel top-k);
- LADIES (71-111): layer-dependent importance sampling, chained row masks;
- per_layer_edge_masks: the DropoutTrick facade (127-172).

A mask is ``[E]`` float32 over the forward CSR's edge order (1 keeps the
edge, 0 drops it), drawn on the graph's device from the caller's
``torch.Generator``. ``masked_graph`` applies one: the weights of both CSRs
are multiplied, the degrees recounted from the surviving edges, and the
result has no dense adjacency and no plans, so every SpMM on it runs the f32
kernel (ops/spmm.py). On a ``DistGraph`` the masks are drawn over its
canonical edge list (``mask_view``), every rank drawing the same mask from a
generator seeded alike, and ``apply_edge_mask`` scales every bucket's weights
through ``parallel/distgraph.py:masked_dist_graph``; the buckets keep their
kernel, so ``pallas_bf16`` stays bf16 there, as the JAX package's plans do.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from ..graph.core import Graph, edge_rows
from ..parallel.distgraph import DistGraph, EdgeView, global_edge_view, masked_dist_graph


def _senders_receivers(g: Graph):
    return g.indices.long(), edge_rows(g.indptr, g.n_edge)


def _rand(n: int, g: Graph, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=g.weight.device)


def drop_edge(generator: torch.Generator, g: Graph, drop_rate: float
              ) -> torch.Tensor:
    return (_rand(g.n_edge, g, generator) < 1.0 - drop_rate).float()


def drop_node(generator: torch.Generator, g: Graph, drop_rate: float
              ) -> torch.Tensor:
    keep_node = _rand(g.n_node, g, generator) < 1.0 - drop_rate
    src, dst = _senders_receivers(g)
    return (keep_node[src] & keep_node[dst]).float()


def _keep_topk_nodes(generator: torch.Generator, weights: torch.Tensor,
                     k: int) -> torch.Tensor:
    """A bool node mask of ``k`` nodes drawn without replacement ∝
    ``weights`` (Gumbel top-k). Zero-weight nodes are never selected, even
    where fewer than ``k`` have weight (torch.multinomial's semantics)."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    logw = torch.where(weights > 0, torch.log(weights),
                       torch.full_like(weights, -torch.inf))
    idx = torch.topk(logw + gumbel, k).indices
    mask = torch.zeros(weights.shape, dtype=torch.bool, device=weights.device)
    return mask.index_fill_(0, idx, True) & (weights > 0)


def _in_weight_sq(g: Graph, w: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per node, the sum of w_e^2 over the edges into it."""
    return torch.zeros(g.n_node, device=w.device).index_add_(0, dst, w * w)


def fastgcn(generator: torch.Generator, g: Graph, drop_rate: float
            ) -> torch.Tensor:
    src, dst = _senders_receivers(g)
    k = int(g.n_node * (1.0 - drop_rate))
    keep_node = _keep_topk_nodes(generator, _in_weight_sq(g, g.weight, dst), k)
    return (keep_node[src] & keep_node[dst]).float()


def ladies(generator: torch.Generator, g: Graph, drop_rate: float,
           num_layers: int) -> List[torch.Tensor]:
    """Per-layer masks, each layer's importance restricted to the edges out
    of the previous layer's sampled nodes; returned in layer order, the
    reverse of the sampling order (the reference's ``.reverse()``)."""
    src, dst = _senders_receivers(g)
    k = int(g.n_node * (1.0 - drop_rate))
    row_mask = torch.ones(g.n_edge, dtype=torch.bool, device=g.weight.device)
    masks = []
    for _ in range(num_layers):
        w = torch.where(row_mask, g.weight, torch.zeros_like(g.weight))
        keep_node = _keep_topk_nodes(generator, _in_weight_sq(g, w, dst), k)
        row_mask = keep_node[src]
        masks.append((keep_node[src] & keep_node[dst]).float())
    masks.reverse()
    return masks


def per_layer_edge_masks(generator: Optional[torch.Generator], g: Graph,
                         type_trick: str, drop_rate: float, num_layers: int,
                         layerwise: bool, train: bool
                         ) -> Optional[List[torch.Tensor]]:
    """The DropoutTrick facade (drop_tricks.py:127-172): one mask per layer,
    or None when no drop trick is configured or not training (eval keeps the
    full graph). ``layerwise`` draws each layer's mask anew; otherwise one
    mask serves every layer. LADIES is layer-wise by construction."""
    if not train:
        return None
    if "DropEdge" in type_trick:
        fn = drop_edge
    elif "DropNode" in type_trick:
        fn = drop_node
    elif "FastGCN" in type_trick:
        fn = fastgcn
    elif "LADIES" in type_trick:
        if not layerwise:
            raise ValueError("LADIES requires the layer-wise dropout flag "
                             "(--layerwise_dropout=1)")
        fn = None
    else:
        return None
    if generator is None:
        raise ValueError("graph dropout needs a torch.Generator")
    if fn is None:
        return ladies(generator, g, drop_rate, num_layers)
    if layerwise:
        return [fn(generator, g, drop_rate) for _ in range(num_layers)]
    return [fn(generator, g, drop_rate)] * num_layers


def masked_graph(g: Graph, mask: torch.Tensor) -> Graph:
    """``g`` with its edges weighted by ``mask`` ([E], forward CSR order),
    the degrees recounted from the edges of nonzero weight, no dense
    adjacency and no plans. No gradient flows into the mask or the
    degrees."""
    with torch.no_grad():
        w = g.weight * mask
        w_t = g.weight_t * mask[g.t_from_fwd]
        deg_in = torch.zeros(g.n_node, device=w.device).index_add_(
            0, edge_rows(g.indptr, g.n_edge), (w != 0).float())
        deg_out = torch.zeros(g.n_node, device=w.device).index_add_(
            0, edge_rows(g.indptr_t, g.n_edge), (w_t != 0).float())
    return dataclasses.replace(g, weight=w, weight_t=w_t, deg_in=deg_in,
                               deg_out=deg_out, dense_adj=None, has_plans=False)


def mask_view(g: Union[Graph, DistGraph]) -> Union[Graph, EdgeView]:
    """The edge list the mask samplers draw over: the graph itself on one
    device, the canonical global edge list of a ``DistGraph``."""
    return g if isinstance(g, Graph) else global_edge_view(g)


def apply_edge_mask(g: Union[Graph, DistGraph], mask: torch.Tensor
                    ) -> Union[Graph, DistGraph]:
    """``g`` with the edge mask drawn over ``mask_view(g)`` applied."""
    return masked_graph(g, mask) if isinstance(g, Graph) else masked_dist_graph(g, mask)
