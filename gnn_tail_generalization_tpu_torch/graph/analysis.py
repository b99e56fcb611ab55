"""Degree census, head/tail/isolation node splits, isolation crafting.

A numpy copy of ``gnn_tail_generalization_tpu/graph/analysis.py`` (the parts
the teacher path needs); the tests hold it equal to the original.

Reference parity:
- degree census:          ``utils.py:300-334``  (graph_analyze)
- median-halving subsets: ``utils.py:910-942``  (get_partial_sorted_idx)
- split assembly:         ``utils.py:680-729``  (save_graph_analyze)
- isolation crafting:     ``utils.py:731-752``  (craft_isolation_v2)

The crafted isolation split removes every non-self-loop edge incident to the
chosen "zero degree" node set, *after* the analysis picked that set — the
order matters and is preserved here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def degree_census(n_node: int, edge_index: np.ndarray):
    """(out_degrees, in_degrees) per node, counting self loops."""
    e = np.asarray(edge_index)
    deg_out = np.bincount(e[0], minlength=n_node).astype(np.int64)
    deg_in = np.bincount(e[1], minlength=n_node).astype(np.int64)
    return deg_out, deg_in


def partial_sorted_idx(arr: np.ndarray, mode: str = "top25") -> np.ndarray:
    """Iterative median halving; 'top' = smaller values, 'bottom' = larger.
    Ties at the median land in the kept set."""
    arr = np.asarray(arr).reshape(-1)
    top = "top" in mode
    # number of halvings: 50->1, 25->2, 12->3, 6->4, 3->5
    halvings = {"50": 1, "25": 2, "12": 3, "6": 4, "3": 5}[
        mode.replace("top", "").replace("bottom", "")
    ]
    idx = np.arange(arr.size)
    for _ in range(halvings):
        med = np.median(arr[idx])
        if top:
            idx = np.where(arr <= med)[0]
        else:
            idx = np.where(arr >= med)[0]
    return idx


@dataclasses.dataclass
class DegreeSplits:
    """Node-index splits by (in-)degree. ``zero_deg_idx`` is only set for the
    special split (the artificial isolation cohort)."""

    large_deg_idx: np.ndarray
    small_deg_idx: np.ndarray
    zero_deg_idx: Optional[np.ndarray]
    large_deg_mask: np.ndarray
    small_deg_mask: np.ndarray
    zero_deg_mask: Optional[np.ndarray]


def _mask_of(idx: np.ndarray, n: int) -> np.ndarray:
    m = np.zeros(n, dtype=bool)
    m[idx] = True
    return m


def degree_splits(
    n_node: int, edge_index: np.ndarray, use_special_split: bool = True
) -> DegreeSplits:
    """Head/tail(/isolation) split assembly.

    Special split: 'top6' (≈ lowest-degree 1/16) sorted ascending by degree,
    lower half -> isolation cohort, upper half -> tail; head = 'bottom3'.
    """
    _, degs_dst = degree_census(n_node, edge_index)

    if not use_special_split:
        small = partial_sorted_idx(degs_dst, "top3")
        large = partial_sorted_idx(degs_dst, "bottom3")
        return DegreeSplits(
            large_deg_idx=large,
            small_deg_idx=small,
            zero_deg_idx=None,
            large_deg_mask=_mask_of(large, n_node),
            small_deg_mask=_mask_of(small, n_node),
            zero_deg_mask=None,
        )

    idx = partial_sorted_idx(degs_dst, "top6")
    # numpy DEFAULT argsort (introsort), as the reference's `.argsort()`: the
    # degree array is tie-heavy, so the sort algorithm determines which nodes
    # land in the isolation half
    order = np.argsort(degs_dst[idx])
    idx = idx[order]
    zero = idx[: len(idx) // 2]
    small = idx[len(idx) // 2 :]
    large = partial_sorted_idx(degs_dst, "bottom3")
    return DegreeSplits(
        large_deg_idx=large,
        small_deg_idx=small,
        zero_deg_idx=zero,
        large_deg_mask=_mask_of(large, n_node),
        small_deg_mask=_mask_of(small, n_node),
        zero_deg_mask=_mask_of(zero, n_node),
    )


def craft_isolation(edge_index: np.ndarray, zero_deg_mask: np.ndarray):
    """Delete every non-self-loop edge incident to the isolation cohort.
    Returns (crafted_edge_index, original_edge_index)."""
    e = np.asarray(edge_index)
    touches = zero_deg_mask[e[0]] | zero_deg_mask[e[1]]
    keep = (e[0] == e[1]) | ~touches
    return e[:, keep], e
