"""Dataset container and the node-classification preparation pipeline.

The port of ``gnn_tail_generalization_tpu/data/datasets.py`` (single-device
parts). Reference parity: the reference's ``trainer_node_classification.py``
(load_data: Planetoid public split with NormalizeFeatures, the Cora
first-600-train special split, symmetrize + de/re-self-loop edge pipeline) and
``utils.py:680-752`` (degree analysis + isolation crafting).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import Config
from ..graph import analysis
from ..graph.core import Graph, build_graph, standard_pipeline


@dataclass
class NodeData:
    """Raw dataset: host numpy arrays, edge_index as loaded (directed ok)."""

    x: np.ndarray  # [N, F] float32
    y: np.ndarray  # [N] int64
    edge_index: np.ndarray  # [2, E]
    train_mask: np.ndarray  # [N] bool
    val_mask: Optional[np.ndarray]
    test_mask: Optional[np.ndarray]
    name: str = ""


@dataclass
class PreparedData:
    """Everything the train loop needs, after the full preprocessing chain.
    Arrays are host numpy; ``graph`` is a CPU ``Graph`` (``.to(device)``)."""

    x: np.ndarray
    y: np.ndarray
    edge_index: np.ndarray  # crafted (isolation) edge list used for training
    edge_index_bkup: np.ndarray  # pre-crafting edge list
    train_mask: np.ndarray
    val_mask: Optional[np.ndarray]
    test_mask: np.ndarray
    train_idx: np.ndarray
    test_idx: np.ndarray
    splits: Optional[analysis.DegreeSplits]
    graph: Graph  # built from the crafted edge list

    @property
    def n_node(self) -> int:
        return self.x.shape[0]


def normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-normalize to sum 1 (torch_geometric T.NormalizeFeatures)."""
    s = x.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return (x / s).astype(np.float32)


def apply_special_split(data: NodeData, cfg: Config) -> NodeData:
    """Cora special split: first 600 nodes train, rest test."""
    if "Cora" in data.name:
        n = data.x.shape[0]
        train = np.zeros(n, dtype=bool)
        train[:600] = True
        return dataclasses.replace(data, train_mask=train, test_mask=~train)
    return data


def prepare(data: NodeData, cfg: Config, *, spmm_dense_threshold: int = 8192
            ) -> PreparedData:
    """Full preprocessing: special split -> edge pipeline -> degree analysis
    -> isolation crafting -> CSR graph (dense adjacency for graphs of at most
    ``spmm_dense_threshold`` nodes, ``has_plans`` for larger ones, as the JAX
    package builds its Pallas plans)."""
    n = data.x.shape[0]
    data = apply_special_split(data, cfg)

    e = standard_pipeline(data.edge_index, n)

    test_mask = (
        data.test_mask if data.test_mask is not None else ~data.train_mask
    )

    splits = None
    e_crafted = e
    if cfg.do_deg_analyze:
        splits = analysis.degree_splits(n, e, cfg.use_special_split)
        if cfg.use_special_split:
            e_crafted, _ = analysis.craft_isolation(e, splits.zero_deg_mask)

    g = build_graph(e_crafted, n, dense_threshold=spmm_dense_threshold,
                    with_plans=n > spmm_dense_threshold)

    return PreparedData(
        x=np.asarray(data.x, np.float32),
        y=np.asarray(data.y, np.int64),
        edge_index=e_crafted,
        edge_index_bkup=e,
        train_mask=data.train_mask,
        val_mask=data.val_mask,
        test_mask=test_mask,
        train_idx=np.where(data.train_mask)[0],
        test_idx=np.where(test_mask)[0],
        splits=splits,
        graph=g,
    )


def _raw_files_present(data_root: str, dataset: str) -> bool:
    """Whether the JAX package's readers would find raw files for
    ``dataset`` under ``data_root`` (the same places they look)."""
    if dataset in ("Cora", "Citeseer", "Pubmed"):
        lname = dataset.lower()
        dirs = (os.path.join(data_root, dataset, "raw"),
                os.path.join(data_root, dataset),
                os.path.join(data_root, lname, "raw"))
        return any(os.path.exists(os.path.join(d, f"ind.{lname}.x"))
                   for d in dirs)
    if dataset == "ogbn-arxiv":
        return any(os.path.isdir(os.path.join(data_root, d))
                   for d in ("ogbn-arxiv", "ogbn_arxiv"))
    if dataset in ("TEXAS", "WISCONSIN", "CORNELL", "ACTOR", "chameleon",
                   "squirrel"):
        names = [dataset, dataset.lower()] + (["film"] if dataset == "ACTOR"
                                              else [])
        return any(os.path.exists(os.path.join(data_root, n, sub,
                                               "out1_graph_edges.txt"))
                   for n in names for sub in ("raw", ""))
    return False


def load_dataset(cfg: Config, data_root: Optional[str] = None) -> NodeData:
    """The deterministic synthetic stand-in with the preset shapes. The raw
    Planetoid/OGB/WebKB readers are not ported yet (ROADMAP A0, dataset
    readers): where their files are present this raises rather than silently
    training on synthetic data."""
    if data_root is not None and _raw_files_present(data_root, cfg.dataset):
        raise NotImplementedError(
            f"raw {cfg.dataset!r} files found under {data_root!r}, but the "
            "port has no dataset readers yet (ROADMAP: dataset readers)")
    known = ("Cora", "Citeseer", "Pubmed", "ogbn-arxiv", "TEXAS",
             "WISCONSIN", "CORNELL", "ACTOR", "chameleon", "squirrel", "")
    if cfg.dataset not in known:
        raise ValueError(
            f"unknown dataset {cfg.dataset!r}; choose one of {known[:-1]}"
        )
    from . import synthetic

    return synthetic.synthetic_planetoid(
        n_node=cfg.N_nodes or 2708,
        n_feat=cfg.num_feats or 1433,
        n_class=cfg.num_classes or 7,
        seed=0,
        name=f"synthetic-{cfg.dataset}" if cfg.dataset else "synthetic",
    )
