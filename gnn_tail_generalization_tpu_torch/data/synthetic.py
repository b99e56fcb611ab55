"""Deterministic synthetic citation-style graphs.

A numpy copy of the generators of ``gnn_tail_generalization_tpu/data/
synthetic.py`` that the port needs; the tests hold their outputs equal to the
originals'. Used when the real Planetoid/OGB files are not on disk. The
generator produces the statistical shape the reference datasets have:
power-law-ish degrees, label homophily (so a GCN beats an MLP), and
bag-of-words-like sparse nonneg features correlated with the label.
"""
from __future__ import annotations

import numpy as np

from .datasets import NodeData, normalize_features


def fast_powerlaw_graph(n_node: int, n_edge: int, seed: int = 0,
                        exponent: float = 0.5) -> np.ndarray:
    """Vectorized power-law-degree random graph for benchmark-scale sizes
    (the per-node preferential-attachment generator below is O(N^2) and only
    meant for small test graphs). dst popularity ~ u^(1/(1-exponent))."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_node, n_edge)
    u = rng.random(n_edge)
    dst = np.minimum((n_node * u ** (1.0 / (1.0 - exponent))).astype(np.int64),
                     n_node - 1)
    perm = rng.permutation(n_node)
    return np.stack([src, perm[dst]])


def synthetic_features_labels(n_node: int, n_feat: int, n_class: int,
                              seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_class, n_node).astype(np.int64)
    x = rng.normal(size=(n_node, n_feat)).astype(np.float32) * 0.1
    x[np.arange(n_node), y % n_feat] += 1.0
    return x, y


def synthetic_planetoid(
    n_node: int = 2708,
    n_feat: int = 1433,
    n_class: int = 7,
    avg_degree: float = 2.0,
    homophily: float = 0.85,
    feat_signal: float = 3.0,
    train_per_class: int = 20,
    n_val: int = 500,
    n_test: int = 1000,
    seed: int = 0,
    name: str = "synthetic",
) -> NodeData:
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_class, n_node)

    if n_node > 20_000:
        # the per-node preferential-attachment loop below is O(N^2); at
        # benchmark scale use the vectorized power-law generator with a
        # homophily rewire instead
        e = fast_powerlaw_graph(n_node, int(n_node * avg_degree * 2), seed)
        same = rng.random(e.shape[1]) < homophily
        dst = np.where(same & (y[e[0]] != y[e[1]]),
                       _same_class_target(rng, y, y[e[0]]),
                       e[1])
        edge_index = np.stack([e[0], dst])
        x = _bow_features(rng, n_node, n_feat, n_class, y, feat_signal)
        return _finish(rng, n_node, x, y, edge_index, train_per_class,
                       n_val, n_test, name)

    # preferential attachment with homophily: node i links to ~avg_degree
    # earlier nodes, biased to same-class and to high-degree targets
    deg = np.ones(n_node)
    src_list, dst_list = [], []
    n_links = rng.poisson(avg_degree, n_node).clip(1)
    for i in range(1, n_node):
        k = min(n_links[i], i)
        p = deg[:i].copy()
        same = y[:i] == y[i]
        p *= np.where(same, homophily, 1 - homophily)
        p /= p.sum()
        targets = rng.choice(i, size=k, replace=False, p=p)
        for t in targets:
            src_list.append(i)
            dst_list.append(t)
            deg[i] += 1
            deg[t] += 1
    edge_index = np.stack(
        [np.asarray(src_list, np.int64), np.asarray(dst_list, np.int64)]
    )

    x = _bow_features(rng, n_node, n_feat, n_class, y, feat_signal)

    # decorrelate node index from degree (preferential attachment favors
    # early ids; Cora-style first-K train splits must not hit only hubs)
    perm = rng.permutation(n_node)
    inv = np.empty(n_node, np.int64)
    inv[perm] = np.arange(n_node)
    x, y = x[perm], y[perm]
    edge_index = inv[edge_index]

    return _finish(rng, n_node, x, y, edge_index, train_per_class, n_val,
                   n_test, name)


def _same_class_target(rng, y, cls):
    """Random node with the given class per entry (vectorized)."""
    order = np.argsort(y, kind="stable")
    bounds = np.searchsorted(y[order], np.arange(int(y.max()) + 2))
    lo, hi = bounds[cls], bounds[cls + 1]
    pick = lo + (rng.random(len(cls)) * np.maximum(hi - lo, 1)).astype(np.int64)
    return order[np.minimum(pick, len(order) - 1)]


def _bow_features(rng, n_node, n_feat, n_class, y, feat_signal):
    """Sparse nonneg bag-of-words features: ~1% active words, class-specific
    words upweighted; every node gets at least one active word."""
    words_per_class = n_feat // n_class
    x = (rng.random((n_node, n_feat)) < 0.01).astype(np.float32)
    x[np.arange(n_node), rng.integers(0, n_feat, n_node)] = 1.0
    for c in range(n_class):
        lo, hi = c * words_per_class, (c + 1) * words_per_class
        boost = (rng.random((int((y == c).sum()), hi - lo)) < 0.02).astype(
            np.float32
        )
        x[y == c, lo:hi] += feat_signal * boost
    return normalize_features(x)


def _finish(rng, n_node, x, y, edge_index, train_per_class, n_val, n_test,
            name):
    # planetoid-style public split: train_per_class per class, then val/test
    train_mask = np.zeros(n_node, dtype=bool)
    for c in range(int(y.max()) + 1):
        idx = np.where(y == c)[0][:train_per_class]
        train_mask[idx] = True
    rest = np.where(~train_mask)[0]
    val_mask = np.zeros(n_node, dtype=bool)
    test_mask = np.zeros(n_node, dtype=bool)
    val_mask[rest[:n_val]] = True
    test_mask[rest[n_val : n_val + n_test]] = True

    return NodeData(
        x=x,
        y=y.astype(np.int64),
        edge_index=edge_index,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name=name,
    )
