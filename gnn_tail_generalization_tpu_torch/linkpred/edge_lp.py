"""Edge-level label propagation: propagate scores over the edge-graph.

The port of ``gnn_tail_generalization_tpu/linkpred/edge_lp.py`` (the
reference's ``Link_prediction_model/edge_LP.py``), with the JAX package's
intended semantics: the edge-graph is over the scored edges themselves,
two edges adjacent iff they share an endpoint, plus self loops.
- run_logitLP (52-76): Y0 = sigmoid(logits), guidance G = 1 for train
  positives / 0.5 for valid+test positives, YAG propagation, inverse
  sigmoid back to logits;
- run_embLP (78-103): propagate concatenated endpoint embeddings, score by
  split dot product;
- run_xmcLP (105-171): the sigmoid logits as an [N, N] matrix propagated
  over D^-1 A of the node graph, in dense column blocks;
- the YAG loop (Label_propagation_model/outcome_correlation.py:11-37):
  result <- clip(alpha * A @ result + (1-alpha) G), then the blend
  Y * 0.998 + result * 2e-3.

The propagations run on ``propagation/correlation.py:
general_outcome_correlation``, so on the card through the f32 CSR kernel
(the edge graphs carry no dense adjacency). ``build_edge_graph`` expands
the edge graph in ``native/graph_prep.cpp``, as the JAX package does
wherever g++ builds its library: the same pairs in the same order, and the
same subsample of a node over ``max_degree``. (The JAX package's numpy
fallback draws another subsample.)
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..graph.core import Graph, build_graph
from ..propagation.correlation import general_outcome_correlation


def build_edge_graph(scored_edges: np.ndarray,
                     max_degree: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Edge-index of the edge-graph over ``scored_edges`` [M, 2]: the self
    loops, then the ordered pairs of distinct scored edges sharing an
    endpoint.

    ``max_degree`` caps the number of incident scored edges considered per
    node (a uniform subsample, drawn per (``seed``, node)) to bound the
    O(sum k^2) blowup on hubs. The expansion is ``native.edge_graph``, the
    JAX package's C++ path to the bit.
    """
    edges = np.asarray(scored_edges, np.int64).reshape(-1, 2)
    return native.edge_graph(edges[:, 0], edges[:, 1], max_degree, seed)


def _dad_edge_graph(edge_adj: np.ndarray, m: int) -> Graph:
    """DAD normalization of the edge-graph (normalize_adj_v2,
    edge_LP.py:11-19); propagation convention out[e0] += x[e1]."""
    deg = np.bincount(edge_adj[0], minlength=m).astype(np.float64)
    dis = np.where(deg > 0, deg**-0.5, 0.0)
    w = (dis[edge_adj[0]] * dis[edge_adj[1]]).astype(np.float32)
    flipped = np.stack([edge_adj[1], edge_adj[0]])
    return build_graph(flipped, m, edge_weight=w, with_dense=False,
                       with_plans=m > 8192)


def yag_propagate(adj: Graph, y0: torch.Tensor, guidance: torch.Tensor,
                  alpha: float, num_propagations: int) -> torch.Tensor:
    """general_outcome_correlation_YAG (outcome_correlation.py:11-37)."""
    result = general_outcome_correlation(
        adj, guidance, alpha, num_propagations,
        post_step=lambda r: r.clamp(1e-9, 1 - 1e-9), start=y0)
    return y0 * 0.998 + result * 2e-3


def invsigmoid(y: torch.Tensor) -> torch.Tensor:
    """edge_LP.py:189-191."""
    eps = 1e-9
    return -torch.log(1.0 / (y + eps) - 1.0)


def run_logit_lp(scored_edges: np.ndarray, logits: torch.Tensor,
                 n_pos_train: int, n_pos_total: int,
                 alpha: float = 0.995, num_propagations: int = 5,
                 max_degree: Optional[int] = 256) -> torch.Tensor:
    """run_logitLP (edge_LP.py:52-76): logits ordered [pos_train, pos_valid,
    pos_test, negs...]; returns propagated logits in the same order."""
    m = len(logits)
    y0 = torch.sigmoid(logits.reshape(-1, 1))
    g_vec = torch.zeros(m, 1, device=logits.device)
    g_vec[:n_pos_train] += 1.0
    g_vec[n_pos_train:n_pos_total] += 0.5

    edge_adj = build_edge_graph(scored_edges, max_degree=max_degree)
    adj = _dad_edge_graph(edge_adj, m).to(logits.device)
    out = yag_propagate(adj, y0, g_vec, alpha, num_propagations)
    return invsigmoid(out.reshape(-1))


def run_xmc_lp(edge_index_graph: np.ndarray, n_node: int,
               scored_edges: np.ndarray, logits: torch.Tensor,
               n_pos_train: int, n_pos_total: int,
               alpha: float = 0.995, num_propagations: int = 5,
               col_chunk: int = 128) -> torch.Tensor:
    """run_xmcLP (edge_LP.py:105-171): propagate the sigmoid logits laid out
    as a sparse [N, N] matrix over the row-normalized NODE adjacency
    (normalize_adj_v3: D^-1 A), guidance 1 at positive entries, then read
    the entries back at the scored edges (invsigmoid to logits).

    The matrix is processed as dense [N, col_chunk] column blocks over the
    UNIQUE destination set; duplicate (src, dst) pairs are deduped before
    (keeping the first logit) and re-fanned after (the reference's
    remove_duplicate/add_duplicate bookkeeping, edge_LP.py:116-169)."""
    dev = logits.device
    edges = np.asarray(scored_edges, np.int64)
    m = edges.shape[0]
    key = edges[:, 0] * n_node + edges[:, 1]
    _, first_idx, inv = np.unique(key, return_index=True, return_inverse=True)
    ue = edges[first_idx]  # [mu, 2]

    y0_vals = torch.sigmoid(logits[torch.from_numpy(first_idx).to(dev)])
    g_host = np.zeros(m, np.float32)
    g_host[:n_pos_train] = 1.0
    g_host[n_pos_train:n_pos_total] = 1.0  # valid+test positives (edge_LP:148)
    g_vals = torch.from_numpy(g_host[first_idx]).to(dev)

    # node adjacency, row-normalized D^-1 A (normalize_adj_v3)
    eg = np.asarray(edge_index_graph)
    deg = np.bincount(eg[0], minlength=n_node).astype(np.float64)
    dinv = np.where(deg > 0, 1.0 / deg, 0.0)
    w = dinv[eg[0]].astype(np.float32)
    adj = build_graph(np.stack([eg[1], eg[0]]), n_node, edge_weight=w,
                      with_dense=False).to(dev)

    # unique destination columns
    uniq_dst, dst_col = np.unique(ue[:, 1], return_inverse=True)
    n_cols = len(uniq_dst)
    src_u = torch.from_numpy(ue[:, 0]).to(dev)
    col_u = torch.from_numpy(dst_col.reshape(-1)).to(dev)
    y0_cols = torch.zeros(n_node, n_cols, device=dev)
    y0_cols[src_u, col_u] = y0_vals
    g_cols = torch.zeros(n_node, n_cols, device=dev)
    g_cols[src_u, col_u] = g_vals

    outs = []
    for lo in range(0, n_cols, col_chunk):
        yb = y0_cols[:, lo:lo + col_chunk].contiguous()
        gb = g_cols[:, lo:lo + col_chunk].contiguous()
        outs.append(yag_propagate(adj, yb, gb, alpha, num_propagations))
    result = torch.cat(outs, dim=1)  # [N, n_cols]
    vals_u = result[src_u, col_u]
    return invsigmoid(vals_u)[torch.from_numpy(inv.reshape(-1)).to(dev)]


def run_emb_lp(scored_edges: np.ndarray, h: torch.Tensor,
               alpha: float = 0.995, num_propagations: int = 5,
               max_degree: Optional[int] = 256) -> torch.Tensor:
    """run_embLP (edge_LP.py:78-103): propagate [h_src ++ h_dst] over the
    edge-graph, score by the dot product of the two halves."""
    edges = torch.from_numpy(np.asarray(scored_edges, np.int64)).to(h.device)
    m = edges.shape[0]
    d = h.shape[1]
    edge_embs = torch.cat([h[edges[:, 0]], h[edges[:, 1]]], dim=-1)
    edge_adj = build_edge_graph(np.asarray(scored_edges), max_degree=max_degree)
    adj = _dad_edge_graph(edge_adj, m).to(h.device)
    out = yag_propagate(adj, edge_embs, edge_embs, alpha, num_propagations)
    out = out.reshape(m, 2, d)
    return torch.sum(out[:, 0, :] * out[:, 1, :], dim=1)
