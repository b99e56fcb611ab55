"""DistGraph: one rank's row shard of the graph, and the ring SpMM over it.

The port of ``gnn_tail_generalization_tpu/parallel/distgraph.py``. The JAX
package makes the whole teacher run on a mesh by giving ``ops.spmm.spmm`` a
``DistGraph`` and letting GSPMD partition everything else from the input
shardings (``distgraph.py:8-13``). PyTorch partitions nothing by itself, so
here each rank is a process holding its shard, and every reduction over the
node axis is written out (``nn/norms.py``, ``train/loops.py``,
``train/evalutil.py``); the SpMM stays behind ``ops/spmm.py:spmm``.

Layout (``build_dist_graph``, as in the JAX package, ``:265-387``):

- nodes are padded to ``n_node_pad = round_up(n, S * rb)`` and cut into S
  shards of ``rows_per_shard`` rows; edges take the canonical order of
  ``lexsort((src, dst))``, sorted and cut into buckets on the host by
  ``native/``'s C++ (``canonical_order``, ``ring_buckets``);
- rank k holds the forward buckets (k, j), j = 0..S-1: the edges with dst in
  shard k and src in shard j, each a CSR over its ``rows_per_shard`` local
  rows with local sources and a ``RowSchedule`` of its own; and the
  transposed buckets, bucket (k, j) of A^T being bucket (j, k) of A with the
  roles swapped. ``transpose()`` swaps the two sets and the degrees;
- ``deg_out`` / ``deg_in`` are this rank's rows of the degree vectors.

``dist_spmm`` is the ring (``:390-456``): ``y = 0``; for t = 0..S-1 add the
kernel's product of bucket (k, (k + t) % S) and the block held, then pass
the block on (``Comm.ring_shift``, started before the product so that the
block moves while the kernel runs). The backward is the same ring on the
transposed buckets. An empty bucket launches nothing; the communicator
counts it under ``skipped_buckets``. Under ``auto``/``pallas`` every bucket
runs the f32 CUDA kernel, under ``pallas_bf16`` the bf16 one (the JAX dist
path always takes its Pallas plans, ``ops/spmm.py:72-77``), under
``gather`` the plain version; on a CPU tensor the kernel wrappers run the
plain version.

The 2-D graph x model mesh (``model_comm``; JAX ``model_axis``,
``:407-414``, ``:469-471``, ``shard_params :695-719``): ``comm`` is the graph
axis (its ring order the graph coordinate) and the buckets are those of the
graph axis alone. Activations stay whole on every rank of the model axis;
only what JAX shards over ``model`` is cut into column slices: the SE tables
and the Dense kernels (``nn/gcn.py``, ``nn/mlp.py``) and the ring's operand.
``dist_spmm`` rings this model shard's ``d / M`` columns of ``x`` through
the bucket kernels and all-gathers the result over the model axis
(``dist_spmm_cols`` when the caller already holds the slice); where ``M``
does not divide ``d`` the operand stays whole, as in JAX. ``dist_take_rows``
follows the same rule. The moves are ``parallel/comm.py``'s ``split_cols``
and ``gather_cols``, whose backward takes the rank's own column slice of the
gradient and sums nothing: every model rank computes the loss whole.

``ShardedGraph`` is the row interface both this ``DistGraph`` and
``parallel/hier.py:HierGraph`` give the model and the loops: ``comm``,
``rows_per_shard``, ``n_node``, ``n_node_pad``, ``row0``, ``local_rows``,
``deg_in``/``deg_out``, ``to``, ``transpose`` and ``spmm``.

The TPU plan arrays (``p_*``, ``pt_*``, ``_stack_bucket_plans``, chunking and
striped padding) are not carried over: a CSR needs none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..graph.core import RowSchedule, _csr, build_schedule, edge_rows, sorted_unique
from ..ops import spmm_kernels as K
from .comm import Comm, gather_cols, split_cols

#: parameters whose rows are the graph's nodes: each rank holds its shard's
#: rows (the JAX package's ``shard_params`` shards ``se``; ``input_embs``
#: only ever meets its own rows too), and their gradients are not summed
ROW_SHARDED = ("se", "input_embs")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One CSR of the ring: ``rows_per_shard`` local destination rows,
    sources local to the bucket's source shard. ``gid``: the canonical edge
    id of each CSR slot, where the graph has an edge view."""

    indptr: torch.Tensor  # [rows + 1] int32
    indices: torch.Tensor  # [E_b] int32
    weight: torch.Tensor  # [E_b] float32
    schedule: RowSchedule
    gid: Optional[torch.Tensor] = None  # [E_b] int64

    @property
    def n_edge(self) -> int:
        return self.indices.shape[0]

    def to(self, device) -> "Bucket":
        return Bucket(self.indptr.to(device), self.indices.to(device),
                      self.weight.to(device), self.schedule.to(device),
                      None if self.gid is None else self.gid.to(device))


def _bucket(rows: np.ndarray, cols: np.ndarray, w: np.ndarray, n_rows: int,
            gid: Optional[np.ndarray]) -> Bucket:
    indptr, indices, weight, order = _csr(rows, cols, w, n_rows)
    return Bucket(indptr, indices, weight, build_schedule(indptr.numpy()),
                  None if gid is None else torch.from_numpy(gid[order]))


@dataclasses.dataclass(frozen=True)
class EdgeView:
    """The canonical global edge list, the same on every rank: the surface
    ``nn/graph_dropout.py``'s mask samplers read (a CSR over the ``n_node``
    real nodes, sources in ``indices``), so every rank draws the same mask
    over the canonical order."""

    indptr: torch.Tensor  # [n_node + 1] int32
    indices: torch.Tensor  # [E] int32 sources
    weight: torch.Tensor  # [E] float32
    n_node: int
    n_edge: int

    def to(self, device) -> "EdgeView":
        return dataclasses.replace(self, indptr=self.indptr.to(device),
                                   indices=self.indices.to(device),
                                   weight=self.weight.to(device))


class ShardedGraph:
    """One rank's rows of a graph sharded over ``comm`` (module docstring):
    ``rows_per_shard`` rows from ``row0``, of the ``n_node_pad`` padded
    nodes. Subclasses hold ``comm``, ``rows_per_shard``, ``n_node``,
    ``n_node_pad``, ``deg_out`` and ``deg_in`` (this rank's rows), and give
    ``spmm``, ``transpose`` and ``to``, and each answers what the loops ask
    of its layout: ``has_edge_view``, ``has_loss_view`` and
    ``teacher_only``."""

    model_comm: Optional[Comm] = None

    @property
    def n_shards(self) -> int:
        return self.comm.world_size

    @property
    def row0(self) -> int:
        """The global id of this rank's first row."""
        return self.comm.shard * self.rows_per_shard

    @property
    def has_edge_view(self) -> bool:
        """Whether it holds the canonical edge list graph dropout masks."""
        raise NotImplementedError

    @property
    def has_loss_view(self) -> bool:
        """Whether ``train/loops.py:final_agg_view`` builds the loss-masked
        view of the last layer on this layout."""
        raise NotImplementedError

    @property
    def teacher_only(self) -> bool:
        """Whether only the TeacherGNN trains on this layout."""
        raise NotImplementedError

    def local_rows(self, t):
        """This rank's rows of an array over all ``n_node_pad`` rows."""
        return t[self.row0: self.row0 + self.rows_per_shard]

    def spmm(self, x: torch.Tensor, method: str) -> torch.Tensor:
        """``y = A @ x`` on this rank's rows, differentiable."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DistGraph(ShardedGraph):
    """Rank ``comm.shard``'s part of a row-sharded graph (module docstring).
    ``edge_view``: only on forward graphs built ``with_edge_view``.
    ``model_comm``: the model axis of a 2-D mesh, else None."""

    comm: Comm
    buckets: Tuple[Bucket, ...]  # bucket (k, j) at position j
    buckets_t: Tuple[Bucket, ...]
    deg_out: torch.Tensor  # [rows_per_shard] float32
    deg_in: torch.Tensor
    n_node: int
    n_node_pad: int
    rows_per_shard: int
    rb: int = 128
    edge_view: Optional[EdgeView] = None
    model_comm: Optional[Comm] = None

    @property
    def has_edge_view(self) -> bool:
        return self.edge_view is not None

    @property
    def has_loss_view(self) -> bool:
        return True

    @property
    def teacher_only(self) -> bool:
        """The 2-D mesh trains the teacher only, as in the JAX package."""
        return self.model_comm is not None

    def spmm(self, x: torch.Tensor, method: str) -> torch.Tensor:
        return dist_spmm(self, x, method)

    def transpose(self) -> "DistGraph":
        """A^T: the transposed bucket set and swapped degrees (no data
        moves). The edge view belongs to the forward graph and is dropped."""
        return dataclasses.replace(self, buckets=self.buckets_t,
                                   buckets_t=self.buckets, deg_out=self.deg_in,
                                   deg_in=self.deg_out, edge_view=None)

    def to(self, device) -> "DistGraph":
        return dataclasses.replace(
            self, buckets=tuple(b.to(device) for b in self.buckets),
            buckets_t=tuple(b.to(device) for b in self.buckets_t),
            deg_out=self.deg_out.to(device), deg_in=self.deg_in.to(device),
            edge_view=None if self.edge_view is None else self.edge_view.to(device))


def comm_of(g) -> Optional[Comm]:
    """The communicator of a sharded graph (the graph axis of a 2-D mesh);
    None for a one-device graph."""
    return g.comm if isinstance(g, ShardedGraph) else None


def model_comm_of(g) -> Optional[Comm]:
    """The model axis of a 2-D mesh's graph; None otherwise."""
    return g.model_comm if isinstance(g, ShardedGraph) else None


def model_cols(d: int, model_comm: Optional[Comm]) -> Optional[Comm]:
    """``model_comm`` where its ranks split ``d`` columns between them (JAX
    ``shard_params``' ``feat_ok``), else None: the width stays whole."""
    if model_comm is None or model_comm.world_size == 1 or d % model_comm.world_size:
        return None
    return model_comm


def build_dist_graph(edge_index: np.ndarray, n_node: int, comm: Comm,
                     edge_weight: Optional[np.ndarray] = None, *, rb: int = 128,
                     with_edge_view: bool = False,
                     model_comm: Optional[Comm] = None,
                     impl: str = "native") -> DistGraph:
    """Rank ``comm.shard``'s ``DistGraph`` (on the CPU; ``.to(device)``)
    from the host edge list ``[2, E]`` that every rank holds whole.
    ``with_edge_view``: keep the canonical edge list and each CSR slot's
    canonical edge id, for graph dropout (``masked_dist_graph``).
    ``model_comm``: the model axis of a 2-D mesh (``comm`` its graph axis);
    the buckets depend on the graph axis alone. ``impl``: the canonical
    sort and the bucket CSRs by ``native``'s C++ (``native``) or its numpy
    version (``plain``), which agree bit for bit."""
    s, k = comm.world_size, comm.shard
    e = np.asarray(edge_index, np.int64)
    w = (np.ones(e.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    n_node_pad = round_up(n_node, s * rb)
    can = native.canonical_order(e[0], e[1], n_node_pad, impl=impl)
    e, w = e[:, can], w[can]
    rows = n_node_pad // s
    lo = k * rows
    deg_out = np.bincount(e[0], minlength=n_node_pad).astype(np.float32)
    deg_in = np.bincount(e[1], minlength=n_node_pad).astype(np.float32)
    fwd, t = native.ring_buckets(e[0], e[1], w, rows, s, k,
                                 with_gid=with_edge_view, impl=impl)

    def bucket_set(arrays):
        return tuple(Bucket(torch.from_numpy(ip), torch.from_numpy(idx),
                            torch.from_numpy(wt), build_schedule(ip),
                            None if gid is None else torch.from_numpy(gid))
                     for ip, idx, wt, gid in arrays)

    view = None
    if with_edge_view:
        indptr = np.zeros(n_node + 1, np.int64)
        np.cumsum(np.bincount(e[1], minlength=n_node), out=indptr[1:])
        view = EdgeView(torch.from_numpy(indptr.astype(np.int32)),
                        torch.from_numpy(e[0].astype(np.int32)),
                        torch.from_numpy(w), n_node, e.shape[1])
    return DistGraph(
        comm=comm, buckets=bucket_set(fwd), buckets_t=bucket_set(t),
        deg_out=torch.from_numpy(deg_out[lo: lo + rows].copy()),
        deg_in=torch.from_numpy(deg_in[lo: lo + rows].copy()),
        n_node=n_node, n_node_pad=n_node_pad, rows_per_shard=rows, rb=rb,
        edge_view=view, model_comm=model_comm)


def _plain(indptr, indices, weight, x, schedule=None):
    return K.spmm_csr_plain(indptr, indices, weight, x)


def ring_kernel(method: str):
    """The bucket SpMM of ``method`` (module docstring)."""
    if method == "pallas_bf16":
        return K.spmm_csr_bf16
    if method == "gather":
        return _plain
    if method in ("auto", "pallas", "dense"):
        return K.spmm_csr_f32
    raise ValueError(f"unknown spmm method {method!r}")


def _ring(g: DistGraph, x: torch.Tensor, kernel) -> torch.Tensor:
    s, k = g.n_shards, g.comm.shard
    y, blk = None, x
    for t in range(s):
        shift = g.comm.ring_shift(blk) if t < s - 1 else None
        b = g.buckets[(k + t) % s]
        if b.n_edge:
            part = kernel(b.indptr, b.indices, b.weight, blk, schedule=b.schedule)
            y = part if y is None else y.add_(part)
        else:
            g.comm.counts["skipped_buckets"] += 1
        if shift is not None:
            blk = shift.wait()
    if y is None:
        y = torch.zeros(g.rows_per_shard, x.shape[1], dtype=torch.float32,
                        device=x.device)
    return y


class _DistSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, method):
        ctx.g, ctx.method, ctx.x_dtype = g, method, x.dtype
        return _ring(g, x, ring_kernel(method)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        dx = _ring(ctx.g.transpose(), dy.contiguous(), ring_kernel(ctx.method))
        return dx.to(ctx.x_dtype), None, None


def _check_rows(g: ShardedGraph, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != g.rows_per_shard:
        raise ValueError(f"x must be [{g.rows_per_shard}, d], this rank's rows of "
                         f"the {g.n_node_pad} padded nodes (pad_rows_np), got "
                         f"{tuple(x.shape)}")


def dist_spmm(g: DistGraph, x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """``y = A @ x`` on this rank's rows: ``x`` and ``y`` are
    ``[rows_per_shard, d]``, this rank's shard of the padded node axis. On a
    2-D mesh ``x`` is whole and the ring takes this model shard's columns
    where the model axis divides ``d`` (module docstring)."""
    _check_rows(g, x)
    mc = model_cols(x.shape[1], g.model_comm)
    if mc is None:
        return _DistSpMM.apply(x.contiguous(), g, method)
    return gather_cols(_DistSpMM.apply(split_cols(x, mc), g, method), mc)


def dist_spmm_cols(g: DistGraph, x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """``y = A @ x`` on a 2-D mesh from this model shard's column slice
    ``x`` (``[rows_per_shard, d / M]``, e.g. the product with a column
    slice of a kernel): the ring on the slice, all-gathered over the model
    axis into the whole ``[rows_per_shard, d]``."""
    _check_rows(g, x)
    return gather_cols(_DistSpMM.apply(x.contiguous(), g, method), g.model_comm)


def dist_take_rows(g: ShardedGraph, h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global ids) of a row-sharded ``h``, the same ``[K, d]``
    on every rank: each rank fills the rows it owns, zeros elsewhere, and
    one differentiable sum over the ranks assembles them (``:459-485``). On
    a 2-D mesh each model shard sums its columns (the rule of
    ``dist_spmm``), and the slices are all-gathered."""
    mc = model_cols(h.shape[1], g.model_comm)
    if mc is not None:
        h = split_cols(h, mc)
    local = idx.long() - g.row0
    ok = (local >= 0) & (local < g.rows_per_shard)
    vals = h[local.clamp(0, g.rows_per_shard - 1)]
    vals = torch.where(ok[:, None], vals, torch.zeros((), dtype=h.dtype, device=h.device))
    out = g.comm.all_reduce_sum(vals)
    return out if mc is None else gather_cols(out, mc)


def global_edge_view(g: ShardedGraph) -> EdgeView:
    """The canonical edge list the mask samplers draw over (``:488-512``)."""
    if not g.has_edge_view:
        raise ValueError("the DistGraph has no edge view: build it with "
                         "with_edge_view=True (prepare_sharded does under "
                         "apply_graph_dropout), and mask the forward graph, "
                         "not its transpose")
    return g.edge_view


def masked_dist_graph(g: DistGraph, mask: torch.Tensor) -> DistGraph:
    """``g`` with a per-edge mask over the canonical order (1 keeps, 0 drops;
    the same on every rank) applied to every bucket's weights, forward and
    transposed, through the slots' canonical ids, and the degrees recounted
    from the surviving edges of nonzero weight (``:515-564``). Structure and
    schedules stay valid, since only weights change. No gradient flows into
    the mask or the degrees."""
    ev = global_edge_view(g)
    with torch.no_grad():
        mask = mask.to(torch.float32)

        def scaled(bs):
            return tuple(dataclasses.replace(b, weight=b.weight * mask[b.gid])
                         for b in bs)

        keep = mask * (ev.weight != 0).float()
        deg_in = torch.zeros(g.n_node_pad, device=keep.device).index_add_(
            0, edge_rows(ev.indptr, ev.n_edge), keep)
        deg_out = torch.zeros(g.n_node_pad, device=keep.device).index_add_(
            0, ev.indices.long(), keep)
        deg_in, deg_out = g.local_rows(deg_in), g.local_rows(deg_out)
    return dataclasses.replace(g, buckets=scaled(g.buckets),
                               buckets_t=scaled(g.buckets_t),
                               deg_in=deg_in, deg_out=deg_out)


def pad_rows_np(a: np.ndarray, n_node_pad: int, fill=0) -> np.ndarray:
    pad = n_node_pad - a.shape[0]
    if pad == 0:
        return a
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)


def is_row_sharded(name: str) -> bool:
    """Whether the parameter ``name`` of a state_dict is row-sharded."""
    return name.rsplit(".", 1)[-1] in ROW_SHARDED


def shard_state_dict(state: Mapping[str, torch.Tensor], shard: int,
                     n_shards: int) -> Dict[str, torch.Tensor]:
    """Rank ``shard``'s state: rows ``shard * R`` to ``(shard + 1) * R`` of
    each row-sharded parameter (R its rows over ``n_shards``), everything
    else whole (the JAX package's ``shard_params``, ``:695-719``)."""
    out = {}
    for name, t in state.items():
        if is_row_sharded(name):
            rows = t.shape[0] // n_shards
            t = t[shard * rows: (shard + 1) * rows]
        out[name] = t.clone()
    return out


def slice_model_cols(state: Mapping[str, torch.Tensor],
                     like: Mapping[str, Tuple[int, ...]],
                     shard: int) -> Dict[str, torch.Tensor]:
    """``state`` cut to the shapes ``like`` of a 2-D rank's module: along
    each dimension where a tensor is wider, model shard ``shard``'s slice
    (the kernels' and SE tables' columns, JAX ``shard_params :708-716``);
    a tensor of the right shape stays as it is."""
    out = {}
    for name, t in state.items():
        for dim, (have, want) in enumerate(zip(t.shape, like[name])):
            if have != want:
                t = t.narrow(dim, shard * want, want)
        out[name] = t.contiguous()
    return out


def gather_model_cols(state: Mapping[str, torch.Tensor],
                      whole: Mapping[str, Tuple[int, ...]],
                      comm: Comm) -> Dict[str, torch.Tensor]:
    """The inverse of ``slice_model_cols`` over the model axis ``comm``: each
    tensor narrower than its shape in ``whole`` all-gathered and joined
    along that dimension in shard order. Collective: every model rank calls
    it with the same names."""
    out = {}
    for name, t in state.items():
        for dim, (have, want) in enumerate(zip(t.shape, whole[name])):
            if have != want:
                t = torch.cat(list(comm.all_gather(t.contiguous())), dim=dim)
        out[name] = t
    return out


def sum_replicated_grads(model: torch.nn.Module, comm: Comm) -> None:
    """Sums the gradients of the replicated parameters over the ranks, in
    one all-reduce of their concatenation; the row-sharded ones stay the
    rank's own. The optimizer then steps alike on every rank. On a 2-D mesh
    ``comm`` is the graph axis: a column slice is replicated over it and
    summed there, and nothing is summed over the model axis."""
    grads = [p.grad for name, p in model.named_parameters()
             if p.grad is not None and not is_row_sharded(name)]
    if not grads:
        return
    flat = comm.all_reduce_sum_(torch.cat([t.reshape(-1) for t in grads]))
    for t, part in zip(grads, flat.split([t.numel() for t in grads])):
        t.copy_(part.view_as(t))


def comm_volume_stats(edge_index: np.ndarray, n_node: int, n_shards: int,
                      d_feat: int = 128, itemsize: int = 4, rb: int = 128) -> dict:
    """The rows and bytes one ``dist_spmm`` moves around an S-shard ring,
    against the partition's halo lower bound (``:567-625``, the same dict).
    The ring passes each shard's whole ``[rows_per_shard, d]`` block S - 1
    times; the halo is, for each bucket (k, j != k), the distinct source
    rows shard k needs from shard j."""
    e = np.asarray(edge_index, np.int64)
    n_node_pad = round_up(n_node, n_shards * rb)
    rows = n_node_pad // n_shards
    dst_shard, src_shard = e[1] // rows, e[0] // rows
    halo_rows = 0
    halo_per_dst = np.zeros(n_shards, np.int64)
    for k in range(n_shards):
        for j in range(n_shards):
            if k == j:
                continue
            u = len(sorted_unique(e[0][(dst_shard == k) & (src_shard == j)]))
            halo_rows += u
            halo_per_dst[k] += u
    ring_rows = (n_shards - 1) * n_node_pad
    return {
        "n_shards": n_shards,
        "n_node_pad": int(n_node_pad),
        "rows_per_shard": int(rows),
        "ring_rows_per_spmm": int(ring_rows),
        "ring_bytes_per_spmm": int(ring_rows * d_feat * itemsize),
        "ring_bytes_per_chip_per_spmm": int((n_shards - 1) * rows * d_feat * itemsize),
        "halo_rows_lower_bound": int(halo_rows),
        "halo_bytes_lower_bound": int(halo_rows * d_feat * itemsize),
        "halo_rows_max_dst_shard": int(halo_per_dst.max()),
        "ring_over_halo": float(ring_rows / max(halo_rows, 1)),
    }


def project_scaling_efficiency(step_ms_1chip: float, n_spmm_per_step: int,
                               stats: dict, link_gbps: float,
                               slow_link_gbps: float, slow_links: int = 0,
                               d_feat: int = 128, itemsize: int = 4) -> dict:
    """The S-card step and scaling efficiency projected from a measured
    one-card step and the ring's volume (``:628-674``): compute scales as
    1/S, and each SpMM adds S - 1 hops of one ``[rows_per_shard, d]`` block,
    every card sending one at a time, the hop paced by the slowest link in
    the ring. No overlap is credited. The bandwidths are the caller's, in
    GB/s a link a direction: ``link_gbps`` for a link within a host,
    ``slow_link_gbps`` for one of the ``slow_links`` that cross hosts.

    efficiency = T_1 / (S * T_S),  T_S = T_1 / S + n_spmm * t_ring."""
    s = stats["n_shards"]
    block_bytes = stats["rows_per_shard"] * d_feat * itemsize
    gbps = slow_link_gbps if slow_links > 0 else link_gbps
    hop_ms = block_bytes / (gbps * 1e9) * 1e3
    t_ring_ms = (s - 1) * hop_ms
    t_s = step_ms_1chip / s + n_spmm_per_step * t_ring_ms
    return {
        "t_step_projected_ms": round(t_s, 3),
        "t_ring_per_spmm_ms": round(t_ring_ms, 3),
        "hop_ms": round(hop_ms, 4),
        "efficiency": round(step_ms_1chip / (s * t_s), 4),
        "assumptions": {"link_gbps": link_gbps, "slow_link_gbps": slow_link_gbps,
                        "slow_links_in_ring": slow_links, "overlap_credit": 0.0},
    }
