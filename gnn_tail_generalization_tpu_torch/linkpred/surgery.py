"""Transfer-setting graph surgery for link prediction (I2-GTL data prep).

A numpy copy of ``gnn_tail_generalization_tpu/linkpred/surgery.py``: the
original imports nothing of JAX, but importing it runs the JAX package's
``__init__``, which does. The tests hold the code after this docstring equal
to the original's, and its outputs equal on the same inputs.

Reference parity (see the original's docstring): subgraph relabel and
downsampling (utils.py:212-275,535-566), union and seeding by node labels
(utils.py:342-509), the transfer split (utils.py:62-145, with the intended
handling of the sampled negatives) and the t2t / u2t / i2t / s / i settings
by node or edge year (trainer_link_prediction.py:106-213). All host-side
numpy; a one-time preprocessing stage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..graph.analysis import degree_census


@dataclass
class GraphData:
    """Lightweight host graph record for surgery operations."""

    x: np.ndarray
    edge_index: np.ndarray
    edge_weight: Optional[np.ndarray] = None
    node_year: Optional[np.ndarray] = None
    edge_year: Optional[np.ndarray] = None
    keys: Optional[np.ndarray] = None  # globally-unique node labels
    is_unique_in_targetG_mask: Optional[np.ndarray] = None
    is_unique_in_targetG_edge_mask: Optional[np.ndarray] = None

    @property
    def n_node(self) -> int:
        return self.x.shape[0]


def random_mask(length: int, true_prob: float, rng) -> np.ndarray:
    return rng.random(length) < true_prob


def subgraph_relabel(edge_index, subset_idx, subset_new_id=None,
                     edge_attr=None):
    """utils.py:539-566. Returns (edge_index, edge_attr, edge_mask)."""
    e = np.asarray(edge_index)
    subset_idx = np.asarray(subset_idx)
    num_nodes = int(max(e.max(initial=0), subset_idx.max(initial=0))) + 1
    node_mask = np.zeros(num_nodes, bool)
    node_mask[subset_idx] = True
    if subset_new_id is None:
        subset_new_id = np.arange(len(subset_idx))
    node_idx = np.zeros(num_nodes, np.int64)
    node_idx[subset_idx] = subset_new_id
    edge_mask = node_mask[e[0]] & node_mask[e[1]]
    e2 = node_idx[e[:, edge_mask]]
    attr = None if edge_attr is None else np.asarray(edge_attr)[edge_mask]
    return e2, attr, edge_mask


def remove_isolated_nodes(edge_index, n_node, edge_attr=None):
    """Drop nodes with no incident edge, relabel. Returns (edge_index,
    edge_attr, kept_node_mask)."""
    e = np.asarray(edge_index)
    used = np.zeros(n_node, bool)
    used[e.reshape(-1)] = True
    new_id = np.cumsum(used) - 1
    e2 = new_id[e]
    return e2, edge_attr, used


def down_sample_graph_with_node_perm(data: GraphData, perm=None,
                                     drop_rate: float = 0.9, seed: int = 0,
                                     do_remove_isolated_nodes: bool = True
                                     ) -> GraphData:
    """utils.py:234-275: node-perm subsampling + isolated-node removal +
    carry of x / years / keys."""
    rng = np.random.default_rng(seed)
    n = data.n_node
    if perm is None:
        perm = np.sort(rng.choice(n, int(n * (1 - drop_rate)), replace=False))
    else:
        perm = np.asarray(perm)

    e2, attr, e_mask = subgraph_relabel(
        data.edge_index, perm, edge_attr=data.edge_weight
    )
    n2 = len(perm)
    if do_remove_isolated_nodes:
        e2, attr, kept = remove_isolated_nodes(e2, n2, attr)
        perm = perm[kept]
        n2 = int(kept.sum())

    def take(a):
        return None if a is None else np.asarray(a)[perm]

    def take_e(a):
        return None if a is None else np.asarray(a)[e_mask]

    return GraphData(
        x=data.x[perm],
        edge_index=e2,
        edge_weight=attr,
        node_year=take(data.node_year),
        edge_year=take_e(data.edge_year),
        keys=take(data.keys),
    )


# ---------------------------------------------------------------------------
# Union / seeding by shared node labels
# ---------------------------------------------------------------------------


def _shared_maps(keys1, keys2):
    """(idx in g1, matching idx in g2) for nodes sharing a label
    (target_seeded_by_source's get_shared_node_idx_and_map,
    utils.py:482-491)."""
    pos2 = {k: i for i, k in enumerate(keys2.tolist())}
    idx1, idx2 = [], []
    for i, k in enumerate(keys1.tolist()):
        if k in pos2:
            idx1.append(i)
            idx2.append(pos2[k])
    return np.asarray(idx1, np.int64), np.asarray(idx2, np.int64)


def cal_union(g1: GraphData, g2: GraphData) -> GraphData:
    """Union graph keyed by node labels (utils.py:342-475, homo case):
    node order = [g2 nodes, g1-unshared nodes]; adjacency = A1 + A2 in
    union coordinates; ``is_unique_in_targetG_mask`` marks nodes present
    ONLY in g2 (the target-exclusive cohort)."""
    assert g1.keys is not None and g2.keys is not None
    pos2 = {k: i for i, k in enumerate(g2.keys.tolist())}
    n2 = g2.n_node
    idx1_map = np.empty(g1.n_node, np.int64)
    unique_mask = [True] * n2
    keys_u = list(g2.keys.tolist())
    nxt = n2
    for i, k in enumerate(g1.keys.tolist()):
        if k in pos2:
            idx1_map[i] = pos2[k]
            unique_mask[pos2[k]] = False
        else:
            idx1_map[i] = nxt
            unique_mask.append(False)
            keys_u.append(k)
            nxt += 1
    n_u = nxt
    idx2_map = np.arange(n2)

    x_u = np.zeros((n_u, g2.x.shape[1]), g2.x.dtype)
    x_u[idx1_map] = g1.x
    x_u[idx2_map] = g2.x

    e1 = idx1_map[g1.edge_index]
    e2 = g2.edge_index
    w1 = (np.ones(e1.shape[1]) if g1.edge_weight is None
          else np.asarray(g1.edge_weight))
    w2 = (np.ones(e2.shape[1]) if g2.edge_weight is None
          else np.asarray(g2.edge_weight))
    # A_U = A1 + A2: coalesce summing weights
    keys = np.concatenate([e1[0] * n_u + e1[1], e2[0] * n_u + e2[1]])
    w = np.concatenate([w1, w2])
    uniq, inv = np.unique(keys, return_inverse=True)
    w_u = np.zeros(len(uniq))
    np.add.at(w_u, inv, w)
    e_u = np.stack([uniq // n_u, uniq % n_u])

    return GraphData(
        x=x_u, edge_index=e_u, edge_weight=w_u,
        keys=np.asarray(keys_u),
        is_unique_in_targetG_mask=np.asarray(unique_mask),
    )


def target_seeded_by_source(g1: GraphData, g2: GraphData,
                            actually_do_addition: bool = True) -> GraphData:
    """utils.py:477-509: keep g2's node set; add g1's edges between shared
    nodes; mark target-exclusive nodes."""
    assert g1.keys is not None and g2.keys is not None
    idx1, idx2 = _shared_maps(g1.keys, g2.keys)
    unique_mask = np.ones(g2.n_node, bool)
    unique_mask[idx2] = False
    out = dataclasses.replace(g2, is_unique_in_targetG_mask=unique_mask)
    if not actually_do_addition:
        return out
    e1, _, _ = subgraph_relabel(g1.edge_index, idx1, subset_new_id=idx2)
    n2 = g2.n_node
    w2 = (np.ones(g2.edge_index.shape[1]) if g2.edge_weight is None
          else np.asarray(g2.edge_weight))
    keys = np.concatenate(
        [g2.edge_index[0] * n2 + g2.edge_index[1], e1[0] * n2 + e1[1]]
    )
    w = np.concatenate([w2, np.ones(e1.shape[1])])
    uniq, inv = np.unique(keys, return_inverse=True)
    w_u = np.zeros(len(uniq))
    np.add.at(w_u, inv, w)
    e_u = np.stack([uniq // n2, uniq % n2])
    return dataclasses.replace(out, edge_index=e_u, edge_weight=w_u)


# ---------------------------------------------------------------------------
# Transfer split
# ---------------------------------------------------------------------------


def init_split_edge_unified(data: GraphData, seed: int = 0,
                            prob_train: float = 0.2,
                            prob_valid: float = 0.4) -> Dict:
    """utils.py:62-145 with the intended negative handling (see module
    docstring). Edges fully inside the source graph (cond0) always train;
    the rest split prob_train/prob_valid/rest."""
    rng = np.random.default_rng(seed)
    e = np.asarray(data.edge_index)
    m = e.shape[1]

    if data.is_unique_in_targetG_edge_mask is not None:
        cond0 = ~np.asarray(data.is_unique_in_targetG_edge_mask)
    else:
        um = np.asarray(data.is_unique_in_targetG_mask)
        cond0 = (~um[e[0]]) & (~um[e[1]])

    r = rng.random(m)
    train_m = cond0 | (r < prob_train)
    valid_m = ~train_m & (r < prob_train + prob_valid)
    test_m = ~train_m & ~valid_m

    # negatives: uniform non-edges, split with the same probabilities
    from . import sampling as S

    n = data.n_node
    keys = S.edge_keys(e, n)
    neg = S.rejection_sample_non_edges(rng, keys, n, m).T
    rn = rng.random(m)
    if data.is_unique_in_targetG_edge_mask is not None:
        ncond0 = np.zeros(m, bool)  # edge mask not applicable to non-edges
    else:
        um = np.asarray(data.is_unique_in_targetG_mask)
        ncond0 = (~um[neg[0]]) & (~um[neg[1]])
    ntrain_m = ncond0 | (rn < prob_train)
    nvalid_m = ~ntrain_m & (rn < prob_train + prob_valid)
    ntest_m = ~ntrain_m & ~nvalid_m

    return {
        "train": {"edge": e[:, train_m].T, "edge_neg": neg[:, ntrain_m].T},
        "valid": {"edge": e[:, valid_m].T, "edge_neg": neg[:, nvalid_m].T},
        "test": {"edge": e[:, test_m].T, "edge_neg": neg[:, ntest_m].T},
    }


def transfer_surgery_node_year(data: GraphData, setting: str,
                               lo: int = 2014, hi: int = 2016,
                               drop_rate: float = 0.1,
                               drop_shared_edge_prob: float = 0.8,
                               exp_on_cold_edge: bool = False,
                               seed: int = 0):
    """citation2-style surgery (trainer_link_prediction.py:106-160).
    Returns (GraphData, split_edge)."""
    rng = np.random.default_rng(seed)
    data = down_sample_graph_with_node_perm(data, drop_rate=drop_rate,
                                            seed=seed)
    ny = data.node_year

    if setting == "t2t":
        target = np.where(ny >= lo)[0]
        data = down_sample_graph_with_node_perm(data, perm=target, seed=seed)
        shared = data.node_year <= hi
        e = data.edge_index
        shared_e = shared[e[0]] & shared[e[1]]
        drop = shared_e & random_mask(len(shared_e), drop_shared_edge_prob,
                                      rng)
        data = dataclasses.replace(
            data, edge_index=e[:, ~drop],
            edge_weight=(None if data.edge_weight is None
                         else data.edge_weight[~drop]),
            edge_year=(None if data.edge_year is None
                       else data.edge_year[~drop]),
        )
    elif setting == "u2t":
        pass
    elif setting == "i2t":
        target = np.where(ny >= lo)[0]
        data = down_sample_graph_with_node_perm(data, perm=target, seed=seed)
    elif setting == "s":
        target = np.where(ny <= hi)[0]
        data = down_sample_graph_with_node_perm(data, perm=target, seed=seed)
    elif setting == "i":
        target = np.where((ny <= hi) & (ny >= lo))[0]
        data = down_sample_graph_with_node_perm(data, perm=target, seed=seed)
    else:
        raise ValueError(setting)

    if exp_on_cold_edge:
        degs_o, degs_d = degree_census(data.n_node, data.edge_index)
        e = data.edge_index
        cold = degs_o[e[0]] + degs_d[e[1]] <= 3
        data = dataclasses.replace(data,
                                   is_unique_in_targetG_edge_mask=cold)
    else:
        data = dataclasses.replace(
            data, is_unique_in_targetG_mask=data.node_year >= hi
        )
    return data, init_split_edge_unified(data, seed=seed)


def transfer_surgery_edge_year(data: GraphData, setting: str,
                               lo: int = 2015, hi: int = 2016,
                               drop_rate: float = 0.1, seed: int = 0):
    """collab-style surgery (trainer_link_prediction.py:162-213)."""
    data = down_sample_graph_with_node_perm(data, drop_rate=drop_rate,
                                            seed=seed)
    ey = data.edge_year

    def nodes_of(mask):
        return np.unique(data.edge_index[:, mask].reshape(-1))

    if setting == "t2t":
        m = ey >= lo
        data = dataclasses.replace(
            data, edge_index=data.edge_index[:, m],
            edge_weight=(None if data.edge_weight is None
                         else data.edge_weight[m]),
            edge_year=ey[m],
        )
    elif setting == "u2t":
        pass
    elif setting == "i2t":
        data = down_sample_graph_with_node_perm(
            data, perm=nodes_of(ey >= lo), seed=seed)
    elif setting == "s":
        data = down_sample_graph_with_node_perm(
            data, perm=nodes_of(ey <= hi), seed=seed)
    elif setting == "i":
        data = down_sample_graph_with_node_perm(
            data, perm=nodes_of((lo <= ey) & (ey <= hi)), seed=seed)
    else:
        raise ValueError(setting)

    data = dataclasses.replace(
        data, is_unique_in_targetG_edge_mask=data.edge_year >= hi
    )
    return data, init_split_edge_unified(data, seed=seed)
