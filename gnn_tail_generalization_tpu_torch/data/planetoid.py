"""Raw Planetoid reader (ind.{name}.{x,tx,allx,y,ty,ally,graph,test.index}).

A host copy of ``gnn_tail_generalization_tpu/data/planetoid.py``; the tests
hold its code and its arrays equal to the original's. Reads the standard
Planetoid pickle files (Yang et al. 2016 format, the raw files
torch_geometric's Planetoid dataset processes) directly: no downloads.
Looks for files under ``<root>/<Name>/raw/``, ``<root>/<Name>/``,
``<root>/<name>/raw/`` or ``<root>``.

Assembly follows the canonical public-split recipe: features = vstack(allx,
tx) with the test rows permuted to their true node ids from test.index;
Citeseer's missing (isolated) test nodes are re-inserted as zero rows.
Split: train = first len(y) nodes, val = next 500, test = test.index, as the
reference's Planetoid(split='public') + NormalizeFeatures
(``trainer_node_classification.py:630-636``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .datasets import NodeData, normalize_features


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _find_raw_dir(root: str, name: str) -> str:
    cand = [
        os.path.join(root, name, "raw"),
        os.path.join(root, name),
        os.path.join(root, name.lower(), "raw"),
        root,
    ]
    for c in cand:
        if os.path.exists(os.path.join(c, f"ind.{name.lower()}.x")):
            return c
    raise FileNotFoundError(f"no raw planetoid files for {name} under {root}")


def load_planetoid(root: str, name: str) -> NodeData:
    lname = name.lower()
    d = _find_raw_dir(root, name)

    def rd(suffix):
        return _load_pickle(os.path.join(d, f"ind.{lname}.{suffix}"))

    tx, allx = rd("tx"), rd("allx")
    y, ty, ally = rd("y"), rd("ty"), rd("ally")
    graph = rd("graph")
    test_idx_reorder = np.loadtxt(
        os.path.join(d, f"ind.{lname}.test.index"), dtype=np.int64
    )
    test_idx_range = np.sort(test_idx_reorder)

    allx = np.asarray(allx.todense(), np.float32)
    tx = np.asarray(tx.todense(), np.float32)
    ally = np.asarray(ally)
    ty = np.asarray(ty)

    if lname == "citeseer":
        # isolated test nodes are missing from tx/ty: extend with zero rows.
        # NOTE: test_idx_range stays the SORTED real test ids — the permute
        # below reads rows at those positions; the extended rows cover the
        # full id range so the vstack positions line up.
        full = np.arange(test_idx_range.min(), test_idx_range.max() + 1)
        tx_ext = np.zeros((len(full), tx.shape[1]), np.float32)
        ty_ext = np.zeros((len(full), ty.shape[1]), ty.dtype)
        tx_ext[test_idx_range - test_idx_range.min()] = tx
        ty_ext[test_idx_range - test_idx_range.min()] = ty
        tx, ty = tx_ext, ty_ext

    feats = np.vstack([allx, tx])
    labels = np.vstack([ally, ty])
    feats[test_idx_reorder] = feats[test_idx_range]
    labels[test_idx_reorder] = labels[test_idx_range]

    n = feats.shape[0]
    yfull = labels.argmax(axis=1).astype(np.int64)

    src, dst = [], []
    for a, nbrs in graph.items():
        for b in nbrs:
            src.append(a)
            dst.append(b)
    edge_index = np.stack(
        [np.asarray(src, np.int64), np.asarray(dst, np.int64)]
    )

    n_train = np.asarray(y).shape[0]
    train_mask = np.zeros(n, bool)
    train_mask[:n_train] = True
    val_mask = np.zeros(n, bool)
    val_mask[n_train : n_train + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx_reorder] = True

    return NodeData(
        x=normalize_features(feats),
        y=yfull,
        edge_index=edge_index,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name=name,
    )
