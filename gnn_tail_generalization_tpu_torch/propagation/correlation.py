"""Outcome/residual correlation: the label-propagation loop.

The port of ``gnn_tail_generalization_tpu/propagation/correlation.py`` (the
reference's ``Label_propagation_model/outcome_correlation.py``):
- gen_normalized_adjs (39-55): symmetric adjacency, D^-1/2, and the DAD /
  DA / AD normalizations;
- general_outcome_correlation (128-145): result <- a * A @ result + (1-a) * y
  (or + y when alpha_term=False), post-step clamp, num_propagations times;
- label_propagation (147-156): one-hot train labels, DAD, clamp [0, 1];
- double_correlation_{autoscale,fixed} / only_outcome_correlation (158-213):
  the Correct & Smooth stages.

The loop is a Python loop over ``ops/spmm.spmm`` under ``torch.no_grad``, at
d = num_classes. The adjacencies carry no plans, so on the card every
propagation runs the f32 CSR kernel, also under ``pallas_bf16``: the JAX
package keeps label probabilities in f32. Graphs of at most
``dense_threshold`` nodes carry a dense adjacency instead.

Convention: torch_sparse ``SparseTensor(row=e0, col=e1) @ x`` sums over
columns, out[e0] += x[e1], so the Graphs here take receivers = e[0] and
senders = e[1]. DA and AD are not symmetric: a flipped edge list is a wrong
answer, not a transposed one.

Sharded: ``gen_normalized_dist_adj`` builds one normalisation as a
``DistGraph`` (the same weights and flipped edges), and every function here
then takes the rank's rows of ``y``, ``model_out`` and the results, with
the global label and residual indices: ``_idx_mask`` maps them onto the
rank's rows (padded rows have no edges and stay 0), and the one reduction
over nodes, the autoscale's mean residual, sums over the ranks. The ring
runs the f32 kernel under ``auto`` and the bf16 one under ``pallas_bf16``,
as the JAX package's sharded path always takes its Pallas plans
(``ops/spmm.py:72-77``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.core import Graph, build_graph, symmetrize
from ..ops.spmm import spmm
from ..parallel.comm import Comm
from ..parallel.distgraph import DistGraph, ShardedGraph, build_dist_graph

Adj = Union[Graph, ShardedGraph]


def _normalized_edges(edge_index: np.ndarray, n_node: int):
    """(the flipped symmetric edge list, {name: its weights}): receivers =
    e[0], senders = e[1]; degrees are row sums with 0^-0.5 -> 0."""
    e = symmetrize(edge_index, n_node)
    deg = np.bincount(e[0], minlength=n_node).astype(np.float64)
    dis = np.power(deg, -0.5, out=np.zeros_like(deg), where=deg > 0)
    ws = {"DAD": (dis[e[0]] * dis[e[1]]).astype(np.float32),
          "DA": (dis[e[0]] * dis[e[0]]).astype(np.float32),
          "AD": (dis[e[1]] * dis[e[1]]).astype(np.float32)}
    return np.stack([e[1], e[0]]), ws


def gen_normalized_adjs(edge_index: np.ndarray, n_node: int,
                        dense_threshold: int = 8192, which=None
                        ) -> Tuple[Optional[Graph], ...]:
    """(DAD, DA, AD) CPU Graphs (outcome_correlation.py:39-55).
    ``edge_index`` is symmetrized first (process_adj's to_undirected).
    ``which`` (a set of names) builds only those; the others are None."""
    flipped, ws = _normalized_edges(edge_index, n_node)
    return tuple(
        build_graph(flipped, n_node, ws[name], dense_threshold=dense_threshold)
        if which is None or name in which else None
        for name in ("DAD", "DA", "AD"))


def gen_normalized_dist_adj(edge_index: np.ndarray, n_node: int, comm: Comm,
                            which: str = "DAD", *, rb: int = 128) -> DistGraph:
    """One normalised adjacency (``which``: DAD, DA or AD) as rank
    ``comm.shard``'s ``DistGraph`` (on the CPU; ``.to(device)``): the
    weights and flipped edges of ``gen_normalized_adjs`` (JAX
    ``correlation.py:69-89``)."""
    flipped, ws = _normalized_edges(edge_index, n_node)
    return build_dist_graph(flipped, n_node, comm, edge_weight=ws[which], rb=rb)


def _rows(adj: Adj) -> int:
    """The rows of ``adj`` that this process holds."""
    return adj.rows_per_shard if isinstance(adj, ShardedGraph) else adj.n_node


def general_outcome_correlation(
    adj: Adj, y: torch.Tensor, alpha: float, num_propagations: int,
    post_step: Callable[[torch.Tensor], torch.Tensor],
    alpha_term: bool = True, spmm_method: str = "auto",
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """outcome_correlation.py:128-145. ``start``: the first ``result``
    where it is not ``y`` (the edge-LP YAG loop starts from the sigmoid
    scores and pulls toward its guidance)."""
    result = y if start is None else start
    with torch.no_grad():
        for _ in range(num_propagations):
            result = alpha * spmm(adj, result, spmm_method)
            result = result + ((1 - alpha) * y if alpha_term else y)
            result = post_step(result)
    return result


def _idx_mask(idx: torch.Tensor, n: int, adj: Optional[Adj] = None
              ) -> torch.Tensor:
    """[n, 1] float 0/1 mask of the rows ``idx``; on a ``DistGraph``
    ``adj``, of the global rows ``idx`` that are this rank's n rows."""
    if isinstance(adj, ShardedGraph):
        idx = idx.long() - adj.row0
        idx = idx[(idx >= 0) & (idx < n)]
    return torch.zeros(n, 1, device=idx.device).index_fill_(0, idx, 1.0)


def _one_hot(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(y, num_classes).float()


def one_hot_labels(y: torch.Tensor, label_idx: torch.Tensor, num_classes: int,
                   n_node: int, adj: Optional[Adj] = None) -> torch.Tensor:
    """Zero matrix with one-hot labels at label_idx
    (outcome_correlation.py:147-153); ``adj`` as in ``_idx_mask``."""
    return _idx_mask(label_idx, n_node, adj) * _one_hot(y, num_classes)


def label_propagation(y: torch.Tensor, label_idx: torch.Tensor, adj: Adj,
                      alpha: float, num_propagations: int, num_classes: int,
                      spmm_method: str = "auto") -> torch.Tensor:
    """Pure LP (outcome_correlation.py:147-156): propagate one-hot train
    labels, clamp [0, 1]. On a ``DistGraph``, the rank's rows."""
    y0 = one_hot_labels(y, label_idx, num_classes, _rows(adj), adj)
    return general_outcome_correlation(
        adj, y0, alpha, num_propagations, post_step=lambda x: x.clamp(0.0, 1.0),
        alpha_term=True, spmm_method=spmm_method)


def pre_residual_correlation(y, model_out, label_idx, num_classes, adj=None):
    """(labels - model_out) at labeled rows, 0 elsewhere
    (outcome_correlation.py:95-110); ``adj`` as in ``_idx_mask``."""
    m = _idx_mask(label_idx, model_out.shape[0], adj)
    return m * (_one_hot(y, num_classes) - model_out)


def pre_outcome_correlation(y, model_out, label_idx, num_classes, adj=None):
    """model_out with labels snapped in at labeled rows
    (outcome_correlation.py:112-126); ``adj`` as in ``_idx_mask``."""
    m = _idx_mask(label_idx, model_out.shape[0], adj)
    return torch.where(m > 0, _one_hot(y, num_classes), model_out)


def _smooth(y, res_result, label_idx, A2, alpha2, num_prop2, num_classes,
            spmm_method):
    y1 = pre_outcome_correlation(y, res_result, label_idx, num_classes, A2)
    return general_outcome_correlation(
        A2, y1, alpha2, num_prop2, post_step=lambda x: x.clamp(0.0, 1.0),
        spmm_method=spmm_method)


def double_correlation_autoscale(
    y, model_out, label_idx, residual_idx,
    A1: Adj, alpha1: float, num_prop1: int,
    A2: Adj, alpha2: float, num_prop2: int,
    num_classes: int, spmm_method: str = "auto",
):
    """Correct (autoscaled residual) & Smooth (outcome_correlation.py:158-180).
    A row whose scale is inf or above 1000 takes scale 1; a NaN row of the
    corrected output falls back to ``model_out``. On ``DistGraph``
    adjacencies the mean residual sums over the ranks."""
    y0 = pre_residual_correlation(y, model_out, residual_idx, num_classes, A1)
    resid = general_outcome_correlation(
        A1, y0, alpha1, num_prop1, post_step=lambda x: x.clamp(-1.0, 1.0),
        spmm_method=spmm_method)
    m_r = _idx_mask(residual_idx, y0.shape[0], A1)
    total = (m_r * y0.abs()).sum()
    if isinstance(A1, ShardedGraph):
        A1.comm.all_reduce_sum_(total)
    orig_diff = total / residual_idx.shape[0]
    scale = orig_diff / resid.abs().sum(dim=1, keepdim=True)
    one = torch.ones_like(scale)
    scale = torch.where(torch.isinf(scale), one, scale)
    scale = torch.where(scale > 1000.0, one, scale)
    res_result = model_out + scale * resid
    res_result = torch.where(torch.isnan(res_result), model_out, res_result)
    return res_result, _smooth(y, res_result, label_idx, A2, alpha2,
                               num_prop2, num_classes, spmm_method)


def double_correlation_fixed(
    y, model_out, label_idx, residual_idx,
    A1: Adj, alpha1: float, num_prop1: int,
    A2: Adj, alpha2: float, num_prop2: int,
    num_classes: int, scale: float = 1.0, spmm_method: str = "auto",
):
    """Correct (residual rows re-pinned each step) & Smooth
    (outcome_correlation.py:182-206)."""
    y0 = pre_residual_correlation(y, model_out, residual_idx, num_classes, A1)
    m_r = _idx_mask(residual_idx, y0.shape[0], A1)
    resid = general_outcome_correlation(
        A1, y0, alpha1, num_prop1,
        post_step=lambda x: torch.where(m_r > 0, y0, x),
        spmm_method=spmm_method)
    res_result = model_out + scale * resid
    return res_result, _smooth(y, res_result, label_idx, A2, alpha2,
                               num_prop2, num_classes, spmm_method)


def only_outcome_correlation(
    y, model_out, label_idx, A: Adj, alpha: float, num_prop: int,
    num_classes: int, spmm_method: str = "auto",
):
    """outcome_correlation.py:208-213."""
    return model_out, _smooth(y, model_out, label_idx, A, alpha, num_prop,
                              num_classes, spmm_method)
