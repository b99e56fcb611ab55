"""Deterministic synthetic citation-style graphs.

A numpy copy of ``gnn_tail_generalization_tpu/data/synthetic.py``; the tests
hold its code and outputs equal to the original's. Used when the real
Planetoid/OGB files are not on disk. The generator produces the statistical
shape the reference datasets have: power-law-ish degrees, label homophily
(so a GCN beats an MLP), and bag-of-words-like sparse nonneg features
correlated with the label. The ``write_fake_*_raw`` writers put full-size
fake raw sets on disk for the dataset readers.
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


def write_fake_planetoid_raw(root: str, name: str = "cora",
                             n_node: int = 2708, n_feat: int = 1433,
                             n_class: int = 7, n_allx: int = 1708,
                             n_train: int = 140, n_edge_und: int = 5278,
                             density: float = 0.0127, seed: int = 0) -> str:
    """Write a FULL-SIZE fake Planetoid raw set (ind.<name>.{x,tx,allx,y,
    ty,ally,graph,test.index}) — real Cora dimensions by default — so the
    real reader (data/planetoid.py) and the exact golden-protocol configs
    can be exercised end-to-end without the real files. Features are
    sparse bag-of-words at Cora's density; labels are class-clustered so
    training is non-degenerate; the graph is a symmetric power-law
    adjacency dict in the canonical pickle format.

    Returns the directory holding the files (``<root>/<Name>/raw``)."""
    import os
    import pickle

    import scipy.sparse as ssp

    rng = np.random.default_rng(seed)
    lname = name.lower()
    d = os.path.join(root, name.capitalize(), "raw")
    os.makedirs(d, exist_ok=True)

    y_full = rng.integers(0, n_class, n_node)
    feats = (rng.random((n_node, n_feat)) < density).astype(np.float32)
    # class-dependent signal columns so the fake task is learnable
    for c in range(n_class):
        cols = slice(c * 8, c * 8 + 8)
        feats[y_full == c, cols] += (
            rng.random(((y_full == c).sum(), 8)) < 0.3)

    e = fast_powerlaw_graph(n_node, n_edge_und, seed)
    graph = {i: [] for i in range(n_node)}
    for a, b in zip(*e):
        graph[int(a)].append(int(b))
        graph[int(b)].append(int(a))

    n_test = n_node - n_allx
    test_idx = rng.permutation(np.arange(n_allx, n_node))
    onehot = np.eye(n_class, dtype=np.int32)[y_full]

    def sp(arr):
        return ssp.csr_matrix(arr)

    files = {
        "x": sp(feats[:n_train]),
        "y": onehot[:n_train],
        "allx": sp(feats[:n_allx]),
        "ally": onehot[:n_allx],
        # tx/ty rows follow the SORTED test id order (the loader permutes
        # them back through test.index)
        "tx": sp(feats[n_allx:]),
        "ty": onehot[n_allx:],
        "graph": graph,
    }
    for suffix, obj in files.items():
        with open(os.path.join(d, f"ind.{lname}.{suffix}"), "wb") as f:
            pickle.dump(obj, f)
    np.savetxt(os.path.join(d, f"ind.{lname}.test.index"), test_idx,
               fmt="%d")
    assert n_test == len(test_idx)
    return d


def write_fake_ogbn_arxiv_raw(root: str, n_node: int = 169343,
                              n_feat: int = 128, n_class: int = 40,
                              n_edge: int = 1_166_243,
                              seed: int = 0) -> str:
    """Write a FULL-SIZE fake ogbn-arxiv raw CSV set (edge.csv.gz,
    node-feat.csv.gz, node-label.csv.gz, split/time/{train,valid,test})
    so the best-config arxiv teacher protocol (the reference's
    base_options.py:412, 71.54) can be dry-run through the real loader
    (data/ogb.py:load_ogbn_arxiv) at real dimensions without the real
    files. Labels are class-clustered into the features so
    the fake task is learnable. Returns the dataset dir.

    The files are compressed at gzip level 1, where the JAX package's
    writer uses level 9: they hold the same text, so the readers return the
    same arrays, and level 9 spends nearly all of a full-size write
    compressing the 21.7M feature values."""
    import gzip
    import os

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "ogbn_arxiv")
    raw = os.path.join(d, "raw")
    split = os.path.join(d, "split", "time")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(split, exist_ok=True)

    y = rng.integers(0, n_class, n_node)
    x = (rng.standard_normal((n_node, n_feat)) * 0.1).astype(np.float32)
    x[np.arange(n_node), y % n_feat] += 1.0
    e = fast_powerlaw_graph(n_node, n_edge, seed)

    def _save(path, arr, fmt):
        with gzip.open(path, "wt", compresslevel=1) as f:
            np.savetxt(f, arr, fmt=fmt, delimiter=",")

    _save(os.path.join(raw, "edge.csv.gz"), e.T, "%d")
    _save(os.path.join(raw, "node-feat.csv.gz"), x, "%.3f")
    _save(os.path.join(raw, "node-label.csv.gz"), y[:, None], "%d")
    _save(os.path.join(raw, "node_year.csv.gz"),
          rng.integers(2005, 2021, (n_node, 1)), "%d")
    perm = rng.permutation(n_node)
    # arxiv's real split sizes: 90941 / 29799 / 48603
    bounds = (90941, 90941 + 29799)
    _save(os.path.join(split, "train.csv.gz"), perm[:bounds[0], None], "%d")
    _save(os.path.join(split, "valid.csv.gz"),
          perm[bounds[0]:bounds[1], None], "%d")
    _save(os.path.join(split, "test.csv.gz"), perm[bounds[1]:, None], "%d")
    return d
