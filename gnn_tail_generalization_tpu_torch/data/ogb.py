"""OGB raw-file readers (no ogb package, no downloads).

A host copy of ``gnn_tail_generalization_tpu/data/ogb.py``; the tests hold
its code and its arrays equal to the original's. Reads the standard OGB raw
CSV layout if present on disk:

  <root>/ogbn_arxiv/raw/edge.csv.gz              (src,dst per line)
  <root>/ogbn_arxiv/raw/node-feat.csv.gz
  <root>/ogbn_arxiv/raw/node-label.csv.gz
  <root>/ogbn_arxiv/raw/node_year.csv.gz
  <root>/ogbn_arxiv/split/time/{train,valid,test}.csv.gz

  <root>/ogbl_collab|ogbl_citation2/raw/...      (edge list + feats/years)

Parity: the reference loads via ogb's PygNodePropPredDataset /
PygLinkPropPredDataset (``trainer_node_classification.py:570-577``,
``trainer_link_prediction.py:230-236``); node-classification edges are
made undirected (to_undirected, trainer:574).
"""
from __future__ import annotations

import gzip
import os
import numpy as np

from ..graph.core import symmetrize
from .datasets import NodeData


def _read_csv_gz(path: str, dtype=np.float32) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _find(root: str, name: str) -> str:
    for c in (os.path.join(root, name), os.path.join(root, name.replace("-", "_"))):
        if os.path.isdir(c):
            return c
    raise FileNotFoundError(f"{name} not found under {root}")


def load_ogbn_arxiv(root: str) -> NodeData:
    d = _find(root, "ogbn_arxiv")
    raw = os.path.join(d, "raw")
    e = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64).T
    x = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    y = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.int64).ravel()
    n = x.shape[0]
    e = symmetrize(e, n)  # to_undirected (trainer:574)

    split_dir = os.path.join(d, "split", "time")
    masks = {}
    for s in ("train", "valid", "test"):
        idx = _read_csv_gz(os.path.join(split_dir, f"{s}.csv.gz"),
                           np.int64).ravel()
        m = np.zeros(n, bool)
        m[idx] = True
        masks[s] = m
    return NodeData(x=x, y=y, edge_index=e, train_mask=masks["train"],
                    val_mask=masks["valid"], test_mask=masks["test"],
                    name="ogbn-arxiv")


def load_ogbl_graph(root: str, name: str):
    """(GraphData, raw dir) for ogbl-citation2 / ogbl-collab, enough for the
    transfer surgery of linkpred/surgery.py."""
    from ..linkpred.surgery import GraphData

    d = _find(root, name.replace("-", "_"))
    raw = os.path.join(d, "raw")
    e = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64).T
    x_path = os.path.join(raw, "node-feat.csv.gz")
    x = (_read_csv_gz(x_path, np.float32) if os.path.exists(x_path)
         else None)
    n = int(e.max()) + 1 if x is None else x.shape[0]
    if x is None:
        x = np.zeros((n, 1), np.float32)

    node_year = None
    ny_path = os.path.join(raw, "node_year.csv.gz")
    if os.path.exists(ny_path):
        node_year = _read_csv_gz(ny_path, np.int64).ravel()
    edge_year = None
    ey_path = os.path.join(raw, "edge_year.csv.gz")
    if os.path.exists(ey_path):
        # collab stores per undirected edge; ogb repeats x2 for both
        # directions (trainer_link_prediction.py:169-171)
        ey = _read_csv_gz(ey_path, np.int64).ravel()
        edge_year = np.repeat(ey, 2) if 2 * len(ey) == e.shape[1] else ey
    ew = None
    ew_path = os.path.join(raw, "edge_weight.csv.gz")
    if os.path.exists(ew_path):
        w = _read_csv_gz(ew_path, np.float32).ravel()
        ew = np.repeat(w, 2) if 2 * len(w) == e.shape[1] else w

    return GraphData(x=x, edge_index=e, edge_weight=ew,
                     node_year=node_year, edge_year=edge_year,
                     keys=np.arange(n)), d
