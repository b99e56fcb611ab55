"""Heuristic link scorers: Common Neighbors, Adamic-Adar, Personalized PageRank.

A numpy/scipy copy of ``gnn_tail_generalization_tpu/linkpred/heuristics.py``
(the reference's ``Link_prediction_baseline/heuristics.py``): importing the
original runs the JAX package's ``__init__``. The tests hold the code after
this docstring equal to the original's.
- CN:  score(u,v) = sum_w A[u,w] * A[v,w]
- AA:  score(u,v) = sum_w A[u,w] * A[v,w] / log(deg(w))  (inf -> 0)
- PPR: blocked power-iteration personalized PageRank from each unique
  source, scored at the destinations

Host-side scipy batch computation (one-shot evaluators in the reference
too); scores return in the edge order given.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as ssp


def adjacency(edge_index: np.ndarray, n_node: int,
              edge_weight: Optional[np.ndarray] = None) -> ssp.csr_matrix:
    e = np.asarray(edge_index)
    w = np.ones(e.shape[1]) if edge_weight is None else np.asarray(edge_weight)
    return ssp.csr_matrix((w, (e[0], e[1])), shape=(n_node, n_node))


def common_neighbors(a: ssp.csr_matrix, edge_index: np.ndarray,
                     batch_size: int = 100_000) -> np.ndarray:
    e = np.asarray(edge_index)
    out = []
    for lo in range(0, e.shape[1], batch_size):
        src = e[0, lo:lo + batch_size]
        dst = e[1, lo:lo + batch_size]
        out.append(np.asarray(a[src].multiply(a[dst]).sum(axis=1)).ravel())
    return np.concatenate(out) if out else np.zeros(0)


def adamic_adar(a: ssp.csr_matrix, edge_index: np.ndarray,
                batch_size: int = 100_000) -> np.ndarray:
    with np.errstate(divide="ignore"):
        mult = 1.0 / np.log(np.asarray(a.sum(axis=0)).ravel())
    mult[np.isinf(mult)] = 0
    a_w = a.multiply(mult).tocsr()
    e = np.asarray(edge_index)
    out = []
    for lo in range(0, e.shape[1], batch_size):
        src = e[0, lo:lo + batch_size]
        dst = e[1, lo:lo + batch_size]
        out.append(np.asarray(a[src].multiply(a_w[dst]).sum(axis=1)).ravel())
    return np.concatenate(out) if out else np.zeros(0)


def _pagerank_power(a: ssp.csr_matrix, personalize: np.ndarray,
                    p: float = 0.85, tol: float = 1e-7,
                    max_iter: int = 200) -> np.ndarray:
    """Power iteration PPR on the column-stochastic transition of A."""
    n = a.shape[0]
    deg = np.asarray(a.sum(axis=1)).ravel()
    dinv = np.where(deg > 0, 1.0 / deg, 0.0)
    w = ssp.diags(dinv) @ a  # row-stochastic
    s = personalize / personalize.sum()
    x = s.copy()
    dangling = deg == 0
    for _ in range(max_iter):
        x_new = p * (w.T @ x + (x[dangling]).sum() * s) + (1 - p) * s
        if np.abs(x_new - x).sum() < tol:
            x = x_new
            break
        x = x_new
    return x


def ppr_scores(a: ssp.csr_matrix, edge_index: np.ndarray,
               p: float = 0.85, tol: float = 1e-7,
               src_block: int = 256, max_iter: int = 200) -> np.ndarray:
    """PPR from each unique source, scored at its destinations
    (heuristics.py:131-163); returns scores in the ORIGINAL edge order
    (the reference returns them src-sorted — callers there re-zip with the
    returned reordered edge list; here the re-zip is internal).

    Blocked power iteration (round 4): ``src_block`` independent
    personalization columns iterate simultaneously as ONE sparse x dense
    product per step — W^T is built once as CSR, each column carries its
    own one-hot restart and dangling-mass redistribution, and the block
    stops when every column's l1 delta clears ``tol``. Same math as the
    reference's per-source fast_pagerank loop (a column converged earlier
    only keeps iterating a converged fixpoint); the per-source variant at
    ogbl-collab scale would pay ~235k full-graph iterations PER SOURCE
    GROUP sequentially."""
    e = np.asarray(edge_index)
    n = a.shape[0]
    uniq = np.unique(e[0])
    src_pos = np.searchsorted(uniq, e[0])
    deg = np.asarray(a.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, 1.0 / deg, 0.0)
    w_t = (ssp.diags(dinv) @ a).T.tocsr()
    dangling = deg == 0
    scores = np.zeros(e.shape[1])
    for lo in range(0, len(uniq), src_block):
        srcs = uniq[lo:lo + src_block]
        b = len(srcs)
        s = np.zeros((n, b))
        s[srcs, np.arange(b)] = 1.0
        x = s.copy()
        for _ in range(max_iter):
            dang = x[dangling].sum(axis=0)  # [b] lost mass per column
            x_new = p * (w_t @ x + s * dang) + (1 - p) * s
            delta = np.abs(x_new - x).sum(axis=0).max()
            x = x_new
            if delta < tol:
                break
        m = (src_pos >= lo) & (src_pos < lo + b)
        scores[m] = x[e[1][m], src_pos[m] - lo]
    return scores


_HEURISTICS = {"CN": common_neighbors, "AA": adamic_adar, "PPR": ppr_scores}


def heuristic_scores(name: str, edge_index_graph: np.ndarray, n_node: int,
                     edges_to_score: np.ndarray,
                     edge_weight: Optional[np.ndarray] = None) -> np.ndarray:
    """eva_heuristics_v2_dec25 (heuristics.py:10-29)."""
    a = adjacency(edge_index_graph, n_node, edge_weight)
    return _HEURISTICS[name](a, np.asarray(edges_to_score))
