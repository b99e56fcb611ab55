"""Dataset container and the node-classification preparation pipeline.

The port of ``gnn_tail_generalization_tpu/data/datasets.py``: ``prepare``;
``prepare_sharded`` for one rank of a row-sharded run, which every
``train_which`` trains on, and with ``model_axis`` for one rank of the 2-D
graph x model mesh; and ``prepare_hier`` for one rank of the two-level
(host x card) layout. Reference parity:
the reference's ``trainer_node_classification.py`` (load_data: Planetoid
public split with NormalizeFeatures, the Cora first-600-train special split,
symmetrize + de/re-self-loop edge pipeline) and ``utils.py:680-752`` (degree
analysis + isolation crafting).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from ..config import Config
from ..graph import analysis
from ..graph.core import Graph, build_graph, standard_pipeline
from ..parallel.comm import Comm
from ..parallel.distgraph import ShardedGraph, build_dist_graph, pad_rows_np
from ..parallel.mesh import DeviceMesh


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
    Arrays are host numpy; ``graph`` is a CPU ``Graph`` (``.to(device)``), or
    one rank's ``DistGraph`` from ``prepare_sharded`` or ``HierGraph`` from
    ``prepare_hier``, whose row arrays are that rank's rows."""

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
    graph: Union[Graph, ShardedGraph]  # built from the crafted edge list

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


def _edges_and_splits(data: NodeData, cfg: Config):
    """(data after the special split, test mask, pipeline edges, crafted
    edges, degree splits): the chain every ``prepare`` shares."""
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
    return data, test_mask, e, e_crafted, splits


def prepare(data: NodeData, cfg: Config, *, spmm_dense_threshold: int = 8192
            ) -> PreparedData:
    """Full preprocessing: special split -> edge pipeline -> degree analysis
    -> isolation crafting -> CSR graph (dense adjacency for graphs of at most
    ``spmm_dense_threshold`` nodes, ``has_plans`` for larger ones, as the JAX
    package builds its Pallas plans)."""
    n = data.x.shape[0]
    data, test_mask, e, e_crafted, splits = _edges_and_splits(data, cfg)
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


def _sharded_data(data: NodeData, test_mask, e, e_crafted, splits,
                  g: ShardedGraph) -> PreparedData:
    """x, y, the masks and the head/tail/iso splits padded to
    ``g.n_node_pad`` (zero features, label 0, every mask False) with the
    rank's rows of ``g`` kept; ``edge_index``, ``train_idx`` and
    ``test_idx`` stay global host arrays."""
    def rows(a):
        return np.ascontiguousarray(g.local_rows(pad_rows_np(np.asarray(a), g.n_node_pad)))

    if splits is not None:
        splits = dataclasses.replace(
            splits, large_deg_mask=rows(splits.large_deg_mask),
            small_deg_mask=rows(splits.small_deg_mask),
            zero_deg_mask=(None if splits.zero_deg_mask is None
                           else rows(splits.zero_deg_mask)))
    return PreparedData(
        x=rows(np.asarray(data.x, np.float32)),
        y=rows(np.asarray(data.y, np.int64)),
        edge_index=e_crafted,
        edge_index_bkup=e,
        train_mask=rows(data.train_mask),
        val_mask=None if data.val_mask is None else rows(data.val_mask),
        test_mask=rows(test_mask),
        train_idx=np.where(data.train_mask)[0],
        test_idx=np.where(test_mask)[0],
        splits=splits,
        graph=g,
    )


def prepare_sharded(data: NodeData, cfg: Config, comm: Union[Comm, DeviceMesh], *,
                    rb: int = 128, axis: str = "graph",
                    model_axis: Optional[str] = None) -> PreparedData:
    """``prepare`` for rank ``comm.shard`` of a row-sharded run (JAX
    ``data/datasets.py:115-180``): the same chain, the graph a
    ``parallel/distgraph.py:DistGraph`` (with its edge view under
    ``cfg.apply_graph_dropout``), and x, y, the masks and the head/tail/iso
    splits padded to ``n_node_pad = round_up(n, S * rb)`` (zero features,
    label 0, every mask False) with this rank's rows kept. ``edge_index``,
    ``train_idx`` and ``test_idx`` stay global host arrays. Padded rows
    enter no loss, metric or aggregation, but they do enter the norms'
    statistics, as in the JAX package's sharded run.

    ``comm`` may be a ``parallel/mesh.py:DeviceMesh``: the rows are cut over
    its axis ``axis``, and with ``model_axis`` the run is the 2-D graph x
    model mesh (``S`` the graph axis's size): the rank keeps its graph
    shard's rows and every column of ``x`` (the first Dense takes it
    whole), and the model axis splits the kernels' columns
    (``parallel/distgraph.py``)."""
    model_comm = None
    if isinstance(comm, DeviceMesh):
        mesh = comm
        comm = mesh.comm(axis)
        model_comm = None if model_axis is None else mesh.comm(model_axis)
    elif model_axis is not None:
        raise ValueError("model_axis needs a DeviceMesh that holds the axis, "
                         "not a Comm")
    n = data.x.shape[0]
    data, test_mask, e, e_crafted, splits = _edges_and_splits(data, cfg)
    dg = build_dist_graph(e_crafted, n, comm, rb=rb,
                          with_edge_view=cfg.apply_graph_dropout,
                          model_comm=model_comm)
    return _sharded_data(data, test_mask, e, e_crafted, splits, dg)


def prepare_hier(data: NodeData, cfg: Config, mesh: DeviceMesh, *,
                 host_axis: str = "host", chip_axis: str = "chip",
                 rb: int = 128) -> PreparedData:
    """``prepare`` for one rank of the two-level (host x card) layout (JAX
    ``data/datasets.py:183-230``): the graph a ``parallel/hier.py:
    HierGraph`` over ``mesh``'s axes ``host_axis`` and ``chip_axis``, rows
    host-major (shard ``h * C + c``) and padded to ``round_up(n, H * C *
    rb)``: the row cut of a ``DistGraph`` of ``H * C`` shards, and the
    arrays as ``prepare_sharded`` cuts them. Graph dropout needs the
    ``DistGraph`` edge view, so ``cfg.apply_graph_dropout`` raises
    ``ValueError``, as JAX asserts (``:191-194``)."""
    from ..parallel.hier import build_hier_graph

    if cfg.apply_graph_dropout:
        raise ValueError("graph-dropout tricks need the DistGraph edge view; use "
                         "prepare_sharded for dropout-trick runs (not the "
                         "two-level layout)")
    n = data.x.shape[0]
    data, test_mask, e, e_crafted, splits = _edges_and_splits(data, cfg)
    hg = build_hier_graph(e_crafted, n, mesh, host_axis=host_axis,
                          chip_axis=chip_axis, rb=rb)
    return _sharded_data(data, test_mask, e, e_crafted, splits, hg)


def load_dataset(cfg: Config, data_root: Optional[str] = None,
                 which_run: int = 0) -> NodeData:
    """The registry of the JAX package's ``load_dataset`` (the reference's
    load_data/load_ogbn, trainer_node_classification.py:570-670): the raw
    files under ``data_root`` when the dataset's reader finds them
    (``planetoid.py``, ``ogb.py``, ``webkb.py``), otherwise a deterministic
    synthetic stand-in with the preset shapes. WebKB/Actor/Wikipedia re-split
    per run block (which_split = which_run // 10, trainer:645-651)."""
    if data_root is not None:
        try:
            if cfg.dataset in ("Cora", "Citeseer", "Pubmed"):
                from . import planetoid

                return planetoid.load_planetoid(data_root, cfg.dataset)
            if cfg.dataset == "ogbn-arxiv":
                from . import ogb

                return ogb.load_ogbn_arxiv(data_root)
            if cfg.dataset in ("TEXAS", "WISCONSIN", "CORNELL", "ACTOR",
                               "chameleon", "squirrel"):
                from . import webkb

                return webkb.load_webkb_like(
                    data_root, cfg.dataset, which_split=which_run // 10
                )
        except FileNotFoundError:
            pass
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
