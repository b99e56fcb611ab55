"""Diffusion / SGC / LP feature preprocessing + spectral embedding.

A copy of ``gnn_tail_generalization_tpu/propagation/diffusion.py`` (numpy
and scipy only): importing it from the JAX package runs that package's
``__init__``, which imports JAX. The tests hold the copy equal to the
original.

Reference parity: the reference's ``Label_propagation_model/diffusion_feature.py``
- DAD adjacency with self loops (147-157)
- sgc (64-67):       x <- A^k x
- lp (69-82):        result <- clip(y + alpha * A @ result^p, 0, 1)
- diffusion (84-94): x <- (x - alpha * (I - A) x)^p
- spectral (115-130 + norm_spec.jl:39-64): top-k eigenvectors of the
  normalized regularized Laplacian I + D (A + tau/N 11^T) D with the SCDM
  QR rotation — the Julia/Arpack solver is replaced by scipy's Lanczos
  (eigsh on a LinearOperator); one-time host-side preprocessing.
- community (96-113): Louvain one-hot. The reference calls
  community_louvain without importing it (broken as shipped); here a real
  multi-level numpy Louvain (greedy modularity moving + graph
  aggregation) with the same one-hot output contract.

These run once at preprocessing time on the host (numpy/scipy); the
per-epoch propagation loops live in propagation/correlation.py on device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as ssp
import scipy.sparse.linalg as sla

from ..graph.core import symmetrize


def dad_adjacency(edge_index: np.ndarray, n_node: int) -> ssp.csr_matrix:
    """to_undirected + set_diag + sym-normalize (diffusion_feature.py:147-157)."""
    e = symmetrize(edge_index, n_node)
    a = ssp.csr_matrix(
        (np.ones(e.shape[1]), (e[0], e[1])), shape=(n_node, n_node)
    )
    a = a + ssp.eye(n_node) - ssp.diags(a.diagonal())  # set_diag -> 1
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    dis = np.where(deg > 0, deg**-0.5, 0.0)
    return ssp.diags(dis) @ a @ ssp.diags(dis)


def sgc_features(x: np.ndarray, adj: ssp.spmatrix,
                 num_propagations: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    for _ in range(num_propagations):
        x = adj @ x
    return x.astype(np.float32)


def lp_features(adj: ssp.spmatrix, train_idx: np.ndarray, labels: np.ndarray,
                num_propagations: int, p: Optional[float] = None,
                alpha: Optional[float] = None) -> np.ndarray:
    p = 0.6 if p is None else p
    alpha = 0.4 if alpha is None else alpha
    c = int(labels.max()) + 1
    y = np.zeros((labels.shape[0], c))
    y[train_idx, labels[train_idx]] = 1.0
    result = y.copy()
    for _ in range(num_propagations):
        result = y + alpha * (adj @ np.power(result, p))
        result = np.clip(result, 0, 1)
    return result.astype(np.float32)


def diffusion_features(x: np.ndarray, adj: ssp.spmatrix,
                       num_propagations: int, p: Optional[float] = None,
                       alpha: Optional[float] = None) -> np.ndarray:
    p = 1.0 if p is None else p
    alpha = 0.5 if alpha is None else alpha
    x = np.power(np.asarray(x, np.float64), p)
    eye = ssp.eye(adj.shape[0])
    for _ in range(num_propagations):
        x = x - alpha * ((eye - adj) @ x)
        x = np.power(x, p)
    return x.astype(np.float32)


def spectral_embedding(edge_index: np.ndarray, n_node: int,
                       k: int = 128) -> np.ndarray:
    """norm_spec.jl:39-64 in scipy: Lanczos top-k of the normalized
    regularized Laplacian, then SCDM rotation."""
    e = symmetrize(edge_index, n_node)
    a = ssp.csr_matrix(
        (np.ones(e.shape[1]), (e[0], e[1])), shape=(n_node, n_node)
    )
    d = np.asarray(a.sum(axis=1)).reshape(-1)
    tau = d.sum() / len(d)
    dvec = 1.0 / np.sqrt(d + tau)

    def matvec(v):
        # NRL v = v + D (A + tau/N 11^T) D v
        dv = dvec * v
        return v + dvec * ((a @ dv) + (tau / n_node) * dv.sum())

    op = sla.LinearOperator((n_node, n_node), matvec=matvec, dtype=np.float64)
    k_eff = min(k, n_node - 2)
    vals, vecs = sla.eigsh(op, k=k_eff, which="LM", tol=1e-6,
                           ncv=min(2 * k_eff + 1, n_node))

    # SCDM rotation: column-pivoted QR of V^T, SVD of the pivot block
    import scipy.linalg

    _, _, piv = scipy.linalg.qr(vecs.T, pivoting=True)
    piv = piv[:k_eff]
    u, _, vt = np.linalg.svd(vecs[piv, :].T, full_matrices=False)
    out = vecs @ (u @ vt)
    if k_eff < k:
        out = np.concatenate(
            [out, np.zeros((n_node, k - k_eff))], axis=1
        )
    return out.astype(np.float32)


def _louvain_local_moving(src, dst, w, n, labels, resolution, rng,
                          max_sweeps=20):
    """Greedy modularity phase 1: move nodes to the neighbor community with
    the best gain dQ ~ k_{v,c} - resolution * k_v * Sigma_tot(c) / 2m."""
    order = np.argsort(src, kind="stable")
    s, d, ww = src[order], dst[order], w[order]
    ptr = np.searchsorted(s, np.arange(n + 1))
    k = np.zeros(n)
    np.add.at(k, src, w)  # weighted degree (symmetric edge list)
    two_m = max(k.sum(), 1e-12)
    comm_tot = np.bincount(labels, weights=k, minlength=n).astype(float)

    moved_any = False
    for _ in range(max_sweeps):
        moved = 0
        for v in rng.permutation(n):
            lo, hi = ptr[v], ptr[v + 1]
            nb, wv = d[lo:hi], ww[lo:hi]
            keep = nb != v
            nb, wv = nb[keep], wv[keep]
            if len(nb) == 0:
                continue
            cv = labels[v]
            comm_tot[cv] -= k[v]
            nbc = labels[nb]
            cand, inv = np.unique(nbc, return_inverse=True)
            links = np.bincount(inv, weights=wv)
            gain = links - resolution * k[v] * comm_tot[cand] / two_m
            # staying put has gain k_{v,cv} - res*k_v*tot(cv)/2m (v
            # removed); with no edges into cv the link term is zero but
            # the degree penalty still applies
            where_cv = np.where(cand == cv)[0]
            if len(where_cv):
                stay = gain[where_cv[0]]
            else:
                stay = -resolution * k[v] * comm_tot[cv] / two_m
            best_i = int(np.argmax(gain))
            if gain[best_i] > stay + 1e-12:
                labels[v] = int(cand[best_i])
                moved += 1
            comm_tot[labels[v]] += k[v]
        if moved == 0:
            break
        moved_any = True
    return labels, moved_any


def louvain_communities(edge_index: np.ndarray, n_node: int, seed: int = 0,
                        resolution: float = 1.0, max_levels: int = 10
                        ) -> np.ndarray:
    """Multi-level Louvain modularity communities (numpy; replaces the
    reference's python-louvain call, diffusion_feature.py:96-113, which is
    broken as shipped — community_louvain is referenced without import).
    Returns [N] compact community labels."""
    e = symmetrize(edge_index, n_node)
    e = e[:, e[0] != e[1]]
    src = np.concatenate([e[0], e[1]])  # both directions for degrees
    dst = np.concatenate([e[1], e[0]])
    w = np.ones(len(src), float) * 0.5  # each undirected edge weight 1
    rng = np.random.default_rng(seed)

    assign = np.arange(n_node)  # original node -> current-level community
    n = n_node
    for _ in range(max_levels):
        labels = np.arange(n)
        labels, moved = _louvain_local_moving(
            src, dst, w, n, labels, resolution, rng)
        uniq, compact = np.unique(labels, return_inverse=True)
        if not moved or len(uniq) == n:
            break
        assign = compact[assign]
        # aggregate: communities become nodes, parallel edges summed
        key = compact[src] * len(uniq) + compact[dst]
        uk, inv = np.unique(key, return_inverse=True)
        w = np.bincount(inv, weights=w)
        src = (uk // len(uniq)).astype(np.int64)
        dst = (uk % len(uniq)).astype(np.int64)
        n = len(uniq)
        if n <= 1:
            break
    _, out = np.unique(assign, return_inverse=True)
    return out


def community_features(edge_index: np.ndarray, n_node: int,
                       seed: int = 0, resolution: float = 1.0
                       ) -> np.ndarray:
    """One-hot Louvain community assignment
    (diffusion_feature.py:96-113 intent; see louvain_communities)."""
    labels = louvain_communities(edge_index, n_node, seed=seed,
                                 resolution=resolution)
    one_hot = np.zeros((n_node, int(labels.max()) + 1), np.float32)
    one_hot[np.arange(n_node), labels] = 1.0
    return one_hot


def preprocess(method: str, x: Optional[np.ndarray],
               edge_index: np.ndarray, n_node: int,
               labels: Optional[np.ndarray] = None,
               train_idx: Optional[np.ndarray] = None,
               num_propagations: int = 10, p: Optional[float] = None,
               alpha: Optional[float] = None, k_spectral: int = 128
               ) -> np.ndarray:
    """Dispatcher (diffusion_feature.py:132-169, minus the .pt cache)."""
    if method == "community":
        return community_features(edge_index, n_node)
    if method == "spectral":
        return spectral_embedding(edge_index, n_node, k_spectral)
    adj = dad_adjacency(edge_index, n_node)
    if method == "sgc":
        return sgc_features(x, adj, num_propagations)
    if method == "diffusion":
        return diffusion_features(x, adj, num_propagations, p, alpha)
    if method == "lp":
        return lp_features(adj, train_idx, labels, num_propagations, p, alpha)
    raise ValueError(method)
