"""WebKB (TEXAS/WISCONSIN/CORNELL), Actor, Wikipedia (chameleon/squirrel)
raw readers + the geom-gcn manual splits.

A host copy of ``gnn_tail_generalization_tpu/data/webkb.py``; the tests hold
its code and its arrays equal to the original's. Raw format (the files
torch_geometric's WebKB/Actor/WikipediaNetwork process):
``out1_node_feature_label.txt`` (id <tab> feature-csv <tab> label; Actor's
features are sparse index lists) and ``out1_graph_edges.txt`` (src <tab>
dst). Splits are the geom-gcn ``*_split_0.6_0.2_<k>.npz`` files with
train/val/test masks; without them, a seeded 0.6/0.2/0.2 split.

Parity: the reference's ``trainer_node_classification.py:643-651`` (loaders
+ change_split with which_split = which_run // 10, 579-594); features
row-normalized like T.NormalizeFeatures.
"""
from __future__ import annotations

import glob
import os
import numpy as np

from .datasets import NodeData, normalize_features

_DIRNAMES = {
    "TEXAS": ["TEXAS", "texas"],
    "WISCONSIN": ["WISCONSIN", "wisconsin"],
    "CORNELL": ["CORNELL", "cornell"],
    "ACTOR": ["ACTOR", "actor", "film"],
    "chameleon": ["chameleon"],
    "squirrel": ["squirrel"],
}


def _find_dir(root: str, name: str) -> str:
    for cand in _DIRNAMES.get(name, [name]):
        for sub in (os.path.join(root, cand, "raw"), os.path.join(root, cand)):
            if os.path.exists(os.path.join(sub, "out1_graph_edges.txt")):
                return sub
    raise FileNotFoundError(f"no raw files for {name} under {root}")


def _parse_features(lines, sparse_feats: bool):
    ids, feats, labels = [], [], []
    for ln in lines[1:]:  # skip header
        parts = ln.strip().split("\t")
        if len(parts) != 3:
            continue
        ids.append(int(parts[0]))
        feats.append(parts[1])
        labels.append(int(parts[2]))
    n = max(ids) + 1
    y = np.zeros(n, np.int64)
    y[ids] = labels
    if sparse_feats:
        dim = 932  # actor vocabulary (base_options.py:298)
        x = np.zeros((n, dim), np.float32)
        for i, f in zip(ids, feats):
            idx = np.asarray([int(v) for v in f.split(",")])
            x[i, idx[idx < dim]] = 1.0
    else:
        rows = [np.asarray([float(v) for v in f.split(",")], np.float32)
                for f in feats]
        x = np.zeros((n, len(rows[0])), np.float32)
        for i, r in zip(ids, rows):
            x[i] = r
    return x, y


def load_webkb_like(root: str, name: str,
                    which_split: int = 0) -> NodeData:
    d = _find_dir(root, name)
    with open(os.path.join(d, "out1_node_feature_label.txt")) as f:
        lines = f.readlines()
    x, y = _parse_features(lines, sparse_feats=(name == "ACTOR"))

    edges = np.loadtxt(os.path.join(d, "out1_graph_edges.txt"),
                       dtype=np.int64, skiprows=1)
    edge_index = edges.T

    train = val = test = None
    splits = sorted(glob.glob(os.path.join(d, "*_split_0.6_0.2_*.npz")))
    if splits:
        k = which_split % len(splits)
        z = np.load(splits[k])
        train = z["train_mask"].astype(bool)
        val = z["val_mask"].astype(bool)
        test = z["test_mask"].astype(bool)
    else:
        n = x.shape[0]
        rng = np.random.default_rng(which_split)
        r = rng.random(n)
        train, val, test = r < 0.6, (r >= 0.6) & (r < 0.8), r >= 0.8

    return NodeData(x=normalize_features(x), y=y, edge_index=edge_index,
                    train_mask=train, val_mask=val, test_mask=test,
                    name=name)
