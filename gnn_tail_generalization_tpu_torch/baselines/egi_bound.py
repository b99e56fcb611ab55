"""EGI transferability bound between two graphs.

A copy of ``gnn_tail_generalization_tpu/baselines/egi_bound.py`` (pure numpy
and scipy; the JAX package's module cannot be imported without JAX), held
equal to it by ``tests/test_torch_port_baselines.py``. The reference's
``Link_prediction_baseline/compute_bound_filepath.py:81-222``: for sampled
pairs of ego graphs (one from each graph), pad their k-hop ego adjacencies
to a common size, build normalized Laplacians L = I - D^-1/2 A D^-1/2, and
average ``lambda_max((L_l - L_r)^T (L_l - L_r))^(1/2)`` over the pairs, an
upper-bound proxy for the EGI transfer-loss difference.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as ssp


def ego_adjacency(a: ssp.csr_matrix, center: int, hops: int = 2,
                  max_nodes: int = 64) -> np.ndarray:
    """Dense adjacency of the k-hop ego graph around ``center`` (BFS,
    truncated to max_nodes)."""
    frontier = {center}
    seen = {center}
    order = [center]
    for _ in range(hops):
        nxt = set()
        for u in frontier:
            row = a.indices[a.indptr[u]:a.indptr[u + 1]]
            for v in row:
                if v not in seen:
                    seen.add(v)
                    order.append(int(v))
                    nxt.add(int(v))
                if len(order) >= max_nodes:
                    break
            if len(order) >= max_nodes:
                break
        frontier = nxt
        if len(order) >= max_nodes:
            break
    idx = np.asarray(order[:max_nodes])
    sub = a[idx][:, idx].toarray()
    return np.minimum(sub, 1.0)


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """L = I - D^-1/2 A D^-1/2 (constructL)."""
    d = adj.sum(axis=1)
    dis = np.where(d > 0, d**-0.5, 0.0)
    return np.eye(len(adj)) - dis[:, None] * adj * dis[None, :]


def _pad(m: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, n))
    out[: m.shape[0], : m.shape[1]] = m
    return out


def egi_bound(edge_index_a: np.ndarray, n_a: int,
              edge_index_b: np.ndarray, n_b: int,
              n_pairs: int = 64, hops: int = 2, max_nodes: int = 64,
              seed: int = 0) -> float:
    """Average spectral distance between paired ego-graph Laplacians
    (compute_term, compute_bound_filepath.py:81-222)."""
    rng = np.random.default_rng(seed)
    ea = np.asarray(edge_index_a)
    eb = np.asarray(edge_index_b)
    a = ssp.csr_matrix((np.ones(ea.shape[1]), (ea[0], ea[1])),
                       shape=(n_a, n_a))
    b = ssp.csr_matrix((np.ones(eb.shape[1]), (eb[0], eb[1])),
                       shape=(n_b, n_b))
    a = ((a + a.T) > 0).astype(float).tocsr()
    b = ((b + b.T) > 0).astype(float).tocsr()

    total = 0.0
    for _ in range(n_pairs):
        ca = int(rng.integers(0, n_a))
        cb = int(rng.integers(0, n_b))
        la = normalized_laplacian(ego_adjacency(a, ca, hops, max_nodes))
        lb = normalized_laplacian(ego_adjacency(b, cb, hops, max_nodes))
        n = max(la.shape[0], lb.shape[0])
        diff = _pad(la, n) - _pad(lb, n)
        eig_max = np.linalg.eigvalsh(diff.T @ diff)[-1]
        total += float(np.sqrt(max(eig_max, 0.0)))
    return total / n_pairs
