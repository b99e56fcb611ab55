"""CSR graph container and host-side graph construction.

The port of ``gnn_tail_generalization_tpu/graph/core.py``. The edge list is
kept twice as compressed sparse rows: grouped by destination (the forward
SpMM ``y[dst] += w * x[src]``) and grouped by source (the transposed view the
SpMM backward runs on). Both are built once on the host. There are no padding
edges: the JAX package pads for XLA's static shapes, and a CSR needs none.

Reference parity (semantics, not code):
- loader pipeline symmetrize -> remove self loops -> add self loops
  (the reference's ``trainer_node_classification.py:655-662``);
- degree semantics of the conv normalization: in/out degree of the directed
  edge list, *including* self loops, clamped to >= 1 by the conv
  (``GNN_model/GCN.py:205-213,242-250``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


#: in-degree above which a row is a hub row: the CUDA SpMM kernels cut its
#: edges into chunks of at most this many, each summed by a block of its
#: own (csrc/spmm_csr.cu; PERF.md says why 64)
HUB_THRESHOLD = 64


@dataclasses.dataclass(frozen=True)
class RowSchedule:
    """How the CUDA SpMM kernels split one CSR's rows, built from its
    ``indptr`` alone (``build_schedule``).

    Rows of in-degree <= ``threshold`` are light: a group of lanes sums each
    one whole, in CSR order. ``hub_rows`` [n_hub] int32 are the others,
    ascending. Hub ``h`` owns chunks ``hub_chunk_ptr[h]`` to
    ``hub_chunk_ptr[h + 1]``; chunk ``c`` is the CSR edges
    ``chunk_bounds[c, 0]`` to ``chunk_bounds[c, 1]``, at most ``threshold``
    consecutive ones. Each chunk's sum is written to its own row of a
    scratch, and a hub row is the sum of its chunks in chunk order, so the
    order of every sum follows from the schedule alone."""

    hub_rows: torch.Tensor  # [n_hub] int32
    hub_chunk_ptr: torch.Tensor  # [n_hub + 1] int32
    chunk_bounds: torch.Tensor  # [n_chunks, 2] int32
    threshold: int

    @property
    def n_hub(self) -> int:
        return self.hub_rows.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.chunk_bounds.shape[0]

    def to(self, device) -> "RowSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def build_schedule(indptr, threshold: int = HUB_THRESHOLD) -> RowSchedule:
    """The ``RowSchedule`` of a CSR with row pointers ``indptr`` ([R + 1],
    numpy or a CPU tensor)."""
    if threshold < 1:
        raise ValueError(f"threshold must be >= 1, got {threshold}")
    ip = np.asarray(indptr, np.int64)
    deg = np.diff(ip)
    hub_rows = np.flatnonzero(deg > threshold)
    per_hub = -(-deg[hub_rows] // threshold)
    chunk_ptr = np.zeros(hub_rows.shape[0] + 1, np.int64)
    np.cumsum(per_hub, out=chunk_ptr[1:])
    owner = np.repeat(np.arange(hub_rows.shape[0]), per_hub)
    start = ip[hub_rows][owner] + (np.arange(owner.shape[0]) - chunk_ptr[owner]) * threshold
    end = np.minimum(start + threshold, ip[hub_rows + 1][owner])
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    return RowSchedule(
        hub_rows=as_t(hub_rows), hub_chunk_ptr=as_t(chunk_ptr),
        chunk_bounds=as_t(np.stack([start, end], axis=1).reshape(-1, 2)),
        threshold=threshold)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable CSR graph. Row ``r`` of the forward CSR holds the edges into
    node ``r``: ``indices[indptr[r]:indptr[r+1]]`` are their sources, in the
    order of a stable sort of the edge list by destination. The ``*_t``
    arrays are the same edges grouped by source (the CSR of A^T).

    ``dense_adj`` is an optional [N, N] ``A[dst, src] = w`` for small graphs,
    where one dense matmul beats any sparse kernel (see ops/spmm.py).

    ``has_plans`` is true where the JAX package's graph carries Pallas plans
    (``plans is not None``): ``prepare``'s graph above the dense threshold
    and its loss-masked view. Masked graphs and the propagation adjacencies
    have none, and ``pallas_bf16`` computes in f32 on them, as the JAX
    package does (ops/spmm.py).

    ``t_from_fwd`` maps the transposed CSR's edges to the forward ones
    (``weight_t == weight[t_from_fwd]``) and ``fwd_from_t`` is its inverse,
    so a per-edge mask over the forward order also masks the transposed
    weights (nn/graph_dropout.py).

    ``schedule`` and ``schedule_t`` split the rows of the forward and the
    transposed CSR for the CUDA kernels (``RowSchedule``); they depend on
    the row pointers only, so a reweighted graph keeps them. Without one
    the kernel wrapper builds it from ``indptr`` on every call."""

    indptr: torch.Tensor  # [N + 1] int32
    indices: torch.Tensor  # [E] int32 source ids
    weight: torch.Tensor  # [E] float32
    indptr_t: torch.Tensor  # [N + 1] int32, rows = source nodes
    indices_t: torch.Tensor  # [E] int32 destination ids
    weight_t: torch.Tensor  # [E] float32
    t_from_fwd: torch.Tensor  # [E] int64
    fwd_from_t: torch.Tensor  # [E] int64
    deg_out: torch.Tensor  # [N] float32, includes self loops and duplicates
    deg_in: torch.Tensor  # [N] float32
    dense_adj: Optional[torch.Tensor]
    n_node: int
    n_edge: int
    has_plans: bool = False
    schedule: Optional[RowSchedule] = None
    schedule_t: Optional[RowSchedule] = None

    def transpose(self) -> "Graph":
        """The reversed-edge graph."""
        return Graph(
            indptr=self.indptr_t, indices=self.indices_t, weight=self.weight_t,
            indptr_t=self.indptr, indices_t=self.indices, weight_t=self.weight,
            t_from_fwd=self.fwd_from_t, fwd_from_t=self.t_from_fwd,
            deg_out=self.deg_in, deg_in=self.deg_out,
            dense_adj=None if self.dense_adj is None else self.dense_adj.T,
            n_node=self.n_node, n_edge=self.n_edge, has_plans=self.has_plans,
            schedule=self.schedule_t, schedule_t=self.schedule,
        )

    def to(self, device) -> "Graph":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), (torch.Tensor, RowSchedule))}
        return dataclasses.replace(self, **moved)

    def with_edge_weight(self, w: torch.Tensor, w_t: Optional[torch.Tensor] = None,
                         rebuild_dense: bool = False) -> "Graph":
        """The graph with edge weights ``w`` ([E], forward-CSR order).
        ``w_t`` defaults to the same weights in transposed-CSR order.
        ``rebuild_dense=False`` drops the dense adjacency (``auto`` then
        takes the CSR kernel). ``has_plans`` goes, as the JAX package drops
        its plans, so ``pallas_bf16`` computes in f32 here too; both row
        schedules stay, since they depend on ``indptr`` alone."""
        if w.shape != (self.n_edge,):
            raise ValueError(f"w must be [{self.n_edge}], got {tuple(w.shape)}")
        w = w.to(torch.float32).contiguous()
        w_t = w[self.t_from_fwd] if w_t is None else w_t.to(torch.float32).contiguous()
        dense = None
        if rebuild_dense and self.dense_adj is not None:
            rows = edge_rows(self.indptr, self.n_edge)
            dense = torch.zeros(self.n_node, self.n_node, dtype=w.dtype,
                                device=w.device)
            dense.index_put_((rows, self.indices.long()), w, accumulate=True)
        return dataclasses.replace(self, weight=w, weight_t=w_t,
                                   dense_adj=dense, has_plans=False)


# ---------------------------------------------------------------------------
# Host-side edge-index transforms (numpy; run once at data-load time)
# ---------------------------------------------------------------------------


def _as_np(edge_index) -> np.ndarray:
    e = np.asarray(edge_index)
    if e.ndim != 2 or e.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {e.shape}")
    return e.astype(np.int64)


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` for a 1-D integer array, by a sort and a neighbour
    compare: numpy 2.3's ``np.unique`` took 33 s on 18M int32 keys on the
    H100 host, where ``np.sort`` takes 0.5 s on 30M int64 ones."""
    s = np.sort(a)
    keep = np.empty(s.shape[0], bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def coalesce(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Deduplicate edges, returning them sorted by (dst, src)."""
    e = _as_np(edge_index)
    keys = sorted_unique(e[1] * n_node + e[0])
    return np.stack([keys % n_node, keys // n_node])


def symmetrize(edge_index: np.ndarray, n_node: Optional[int] = None) -> np.ndarray:
    """A <- A + A^T with deduplication."""
    e = _as_np(edge_index)
    if n_node is None:
        n_node = int(e.max()) + 1
    both = np.concatenate([e, e[::-1]], axis=1)
    return coalesce(both, n_node)


def remove_self_loops(edge_index: np.ndarray) -> np.ndarray:
    e = _as_np(edge_index)
    return e[:, e[0] != e[1]]


def add_self_loops(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    e = _as_np(edge_index)
    loops = np.arange(n_node, dtype=np.int64)
    return np.concatenate([e, np.stack([loops, loops])], axis=1)


def standard_pipeline(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """symmetrize -> remove self loops -> add self loops, the node-classification
    loader pipeline."""
    e = symmetrize(edge_index, n_node)
    e = remove_self_loops(e)
    return add_self_loops(e, n_node)


def degrees(edge_index: np.ndarray, n_node: int):
    """(out_degree, in_degree) of the directed edge list, including self loops
    and duplicates (dgl out_degrees/in_degrees)."""
    e = _as_np(edge_index)
    deg_out = np.bincount(e[0], minlength=n_node).astype(np.float32)
    deg_in = np.bincount(e[1], minlength=n_node).astype(np.float32)
    return deg_out, deg_in


def gcn_norm_weights(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Edge weights of D^-1/2 A D^-1/2 over the given edges, D the in-degree
    of the edge list (symmetric edge lists assumed). For the normalized
    adjacency with self loops, pass an edge list that went through
    remove_self_loops and add_self_loops."""
    e = _as_np(edge_index)
    deg = np.bincount(e[1], minlength=n_node).astype(np.float64)
    dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    return (dinv[e[0]] * dinv[e[1]]).astype(np.float32)


def _csr(rows: np.ndarray, cols: np.ndarray, w: np.ndarray, n_node: int):
    """(indptr, indices, weight, order) grouping edges by ``rows``, stable;
    ``order`` holds the edge-list position of each CSR edge."""
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n_node + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_node), out=indptr[1:])
    return (torch.from_numpy(indptr.astype(np.int32)),
            torch.from_numpy(cols[order].astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(w[order], np.float32)),
            order)


def edge_rows(indptr: torch.Tensor, n_edge: int) -> torch.Tensor:
    """[E] int64: the row of each CSR edge (its destination in the forward
    CSR, its source in the transposed one)."""
    n_rows = indptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device),
        (indptr[1:] - indptr[:-1]).long(), output_size=n_edge)


def build_graph(
    edge_index: np.ndarray,
    n_node: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    dense_threshold: int = 8192,
    with_dense: Optional[bool] = None,
    with_plans: bool = False,
) -> Graph:
    """Build the CPU ``Graph`` from a host edge list ``[2, E]`` (row 0 the
    sources). ``edge_weight=None`` means unit weights (the GCN degree
    normalization is applied outside the SpMM, see nn/gcn.py). Graphs with
    ``n_node <= dense_threshold`` also get ``dense_adj``; ``with_dense``
    overrides that. ``with_plans`` sets ``has_plans``, where the JAX
    package's ``build_graph`` would build Pallas plans."""
    e = _as_np(edge_index)
    n_edge = e.shape[1]
    if n_edge >= 2**31 or n_node >= 2**31:
        raise ValueError("the CSR kernels index with int32")
    if edge_weight is None:
        w = np.ones(n_edge, dtype=np.float32)
    else:
        w = np.asarray(edge_weight, dtype=np.float32)
        if w.shape != (n_edge,):
            raise ValueError(f"edge_weight shape {w.shape} != ({n_edge},)")

    deg_out, deg_in = degrees(e, n_node)
    indptr, indices, weight, order_f = _csr(e[1], e[0], w, n_node)
    indptr_t, indices_t, weight_t, order_t = _csr(e[0], e[1], w, n_node)
    fwd_pos = np.empty(n_edge, np.int64)  # edge-list position -> CSR position
    fwd_pos[order_f] = np.arange(n_edge)
    t_from_fwd = fwd_pos[order_t]
    fwd_from_t = np.empty(n_edge, np.int64)
    fwd_from_t[t_from_fwd] = np.arange(n_edge)

    if with_dense is None:
        with_dense = n_node <= dense_threshold
    dense = None
    if with_dense:
        dense_np = np.zeros((n_node, n_node), dtype=np.float32)
        np.add.at(dense_np, (e[1], e[0]), w)
        dense = torch.from_numpy(dense_np)

    return Graph(
        indptr=indptr, indices=indices, weight=weight,
        indptr_t=indptr_t, indices_t=indices_t, weight_t=weight_t,
        t_from_fwd=torch.from_numpy(t_from_fwd),
        fwd_from_t=torch.from_numpy(fwd_from_t),
        deg_out=torch.from_numpy(deg_out), deg_in=torch.from_numpy(deg_in),
        dense_adj=dense, n_node=n_node, n_edge=n_edge, has_plans=with_plans,
        schedule=build_schedule(indptr.numpy()),
        schedule_t=build_schedule(indptr_t.numpy()),
    )


def loss_masked_view(
    g: Graph,
    edge_index: np.ndarray,
    dst_mask: np.ndarray,
    edge_weight: Optional[np.ndarray] = None,
) -> Graph:
    """A final-layer training view of ``g``: only edges whose destination is
    inside ``dst_mask`` are kept, but the degree arrays (i.e. the GCN
    normalization) stay those of the FULL graph.

    When only loss-masked rows of the last conv's output feed the loss (NLL
    over the train mask), aggregating the other rows is dead work: the step's
    loss and gradient are identical with them dropped, and the final layer's
    forward and backward SpMMs shrink with the mask. Rows outside the mask
    aggregate to zero, so the view must ONLY be used when nothing row-coupling
    (cross-row norms, edgewise losses, collect_SE) consumes them.

    ``edge_index``/``edge_weight`` are the HOST arrays ``g`` was built from.
    The view carries ``dense_adj`` and ``has_plans`` exactly when ``g``
    does."""
    e = _as_np(edge_index)
    m = np.asarray(dst_mask, bool)
    keep = m[e[1]]
    w_sub = None if edge_weight is None else np.asarray(edge_weight)[keep]
    sub = build_graph(e[:, keep], g.n_node, w_sub,
                      with_dense=g.dense_adj is not None,
                      with_plans=g.has_plans)
    return dataclasses.replace(sub, deg_out=g.deg_out, deg_in=g.deg_in)


def subgraph_edges(
    edge_index: np.ndarray,
    subset: np.ndarray,
    n_node: int,
    relabel: bool = True,
    edge_attr: Optional[np.ndarray] = None,
):
    """Crop edges to a node subset, optionally relabeling (utils.py:1250-1267).
    A copy of the JAX package's host helper."""
    e = _as_np(edge_index)
    mask = np.zeros(n_node, dtype=bool)
    mask[np.asarray(subset)] = True
    emask = mask[e[0]] & mask[e[1]]
    e = e[:, emask]
    attr = None if edge_attr is None else np.asarray(edge_attr)[emask]
    if relabel:
        new_id = np.zeros(n_node, dtype=np.int64)
        new_id[np.asarray(subset)] = np.arange(len(np.asarray(subset)))
        e = new_id[e]
    return e, attr
