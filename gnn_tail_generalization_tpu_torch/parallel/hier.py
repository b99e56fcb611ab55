"""The two-level (host x card) SpMM: a ring within each host, only the halo
across hosts.

The port of ``gnn_tail_generalization_tpu/parallel/hier.py``. The flat ring
(``parallel/distgraph.py``) passes whole feature blocks S - 1 times; when
some of its hops cross hosts, every hop is paced by the slow link. Here the
ranks lie on a ``(host, chip)`` mesh (``parallel/mesh.py:DeviceMesh``), the
rows host-major (shard ``h * C + c``, the row cut of a ``DistGraph`` of
``S = H * C`` shards), and one ``hier_spmm`` on rank ``(h, k)`` is:

- within the host: the ring over the chip axis, as ``distgraph.py:_ring``:
  ``C`` intra buckets (dst card ``k``, src card ``j`` of host ``h``), a CSR
  over the local rows with local sources each, ``C - 1`` shifts, each
  started before the bucket's kernel;
- across hosts, for ``t = 1 .. H - 1``: the host ships to host
  ``(h - t) % H`` the rows of its own that host needs (``halo_idx[t - 1]``,
  host-local ids): each card fills the rows it owns, zeros elsewhere; one
  sum over the chip axis assembles the ``[u_max, d]`` halo on every card of
  the host; card ``k`` ships its ``u_max / C`` slice with one host-axis
  shift by ``t`` (JAX's pairs ``(i, (i - t) % H)``); the receiving host
  all-gathers the slices over the chip axis in card order; and one kernel
  runs cross bucket ``t``, whose sources are positions in the sorted
  unique halo list ``U_gh`` of the pair (``g = (h + t) % H``).

The halo moves in ``x``'s dtype. ``pallas_bf16`` runs the bf16 kernel on
every bucket, intra and cross; ``auto``/``pallas`` the f32 one; ``gather``
the plain version. An empty bucket launches nothing and counts under the
world ``Comm``'s ``skipped_buckets``. The backward is the same on
``transpose()``, which swaps every bucket set, the halo lists, ``u_max`` and
the unpadded halo count (``dcn_rows`` and ``dcn_rows_t``; the JAX
``transpose()`` keeps ``dcn_rows``, so its ``hier_comm_stats`` on a
transposed graph reports the forward direction's count).

``u_max = round_up(max(max_u, 8), 8 * C)``, as in JAX, so that
``hier_comm_stats`` agrees; its pad slots are referenced by no edge and
their ``halo_idx`` entries are -1, which the assembly masks to zero. The
TPU plan arrays, stripes and chunk counts are not carried over, nor is
``shard_params_hier``: its rule (SE tables row-sharded over both axes, the
rest whole) is ``distgraph.py:shard_state_dict``'s with ``S = H * C``,
which ``train/loops.py`` and ``utils/convert.py`` apply to a hier rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph.core import sorted_unique
from .comm import Comm
from .distgraph import Bucket, ShardedGraph, _bucket, _check_rows, ring_kernel, round_up
from .mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class _Direction:
    intra: Tuple[Bucket, ...]  # src card j at position j
    cross: Tuple[Bucket, ...]  # step t at position t - 1
    halo_idx: torch.Tensor  # [H - 1, u_max] int64 host-local rows shipped; -1 pads
    u_max: int
    dcn_rows: int

    def to(self, device) -> "_Direction":
        return dataclasses.replace(
            self, intra=tuple(b.to(device) for b in self.intra),
            cross=tuple(b.to(device) for b in self.cross),
            halo_idx=self.halo_idx.to(device))


@dataclasses.dataclass(frozen=True)
class HierGraph(ShardedGraph):
    """Rank ``(h, k)``'s part of a two-level graph (module docstring):
    ``comm`` the world (shard ``h * C + k``), ``chip_comm`` the ranks of
    host ``h``, ``host_comm`` card ``k`` of every host."""

    comm: Comm
    chip_comm: Comm
    host_comm: Comm
    fwd: _Direction
    bwd: _Direction
    deg_out: torch.Tensor  # [rows_per_shard] float32
    deg_in: torch.Tensor
    n_node: int
    n_node_pad: int
    rows_per_shard: int
    rb: int = 128

    @property
    def has_edge_view(self) -> bool:
        return False  # no graph dropout on this layout, as in JAX

    @property
    def has_loss_view(self) -> bool:
        return False  # as JAX (loops.py:103-108)

    @property
    def teacher_only(self) -> bool:
        return True  # as JAX (main.py:171-172)

    @property
    def n_hosts(self) -> int:
        return self.host_comm.world_size

    @property
    def n_chips(self) -> int:
        return self.chip_comm.world_size

    @property
    def intra(self) -> Tuple[Bucket, ...]:
        return self.fwd.intra

    @property
    def cross(self) -> Tuple[Bucket, ...]:
        return self.fwd.cross

    @property
    def halo_idx(self) -> torch.Tensor:
        return self.fwd.halo_idx

    @property
    def u_max(self) -> int:
        return self.fwd.u_max

    @property
    def dcn_rows(self) -> int:
        """Unpadded cross-host halo rows of one SpMM, summed over the pairs."""
        return self.fwd.dcn_rows

    @property
    def dcn_rows_t(self) -> int:
        """The same for the transposed graph (the backward)."""
        return self.bwd.dcn_rows

    def transpose(self) -> "HierGraph":
        return dataclasses.replace(self, fwd=self.bwd, bwd=self.fwd,
                                   deg_out=self.deg_in, deg_in=self.deg_out)

    def to(self, device) -> "HierGraph":
        return dataclasses.replace(self, fwd=self.fwd.to(device), bwd=self.bwd.to(device),
                                   deg_out=self.deg_out.to(device),
                                   deg_in=self.deg_in.to(device))

    def spmm(self, x: torch.Tensor, method: str) -> torch.Tensor:
        return hier_spmm(self, x, method)


def _build_direction(src: np.ndarray, dst: np.ndarray, w: np.ndarray, rows: int,
                     H: int, C: int, h: int, k: int) -> _Direction:
    """Rank ``(h, k)``'s buckets and halo lists of one edge direction
    (JAX ``_build_direction :195-260``; ``dst`` the rows)."""
    shard_s, shard_d = src // rows, dst // rows
    lo = (h * C + k) * rows
    mine = np.flatnonzero(shard_d == h * C + k)
    intra = []
    for j in range(C):
        ids = mine[shard_s[mine] == h * C + j]
        intra.append(_bucket(dst[ids] - lo, src[ids] - (h * C + j) * rows, w[ids],
                             rows, None))
    cross, halo, u_max, dcn_rows = [], np.zeros((0, 0), np.int64), 0, 0
    if H > 1:
        host_s, host_d = shard_s // C, shard_d // C
        xe = np.flatnonzero(host_s != host_d)
        key = host_d[xe] * H + host_s[xe]
        # every pair's unique sources: u_max and dcn_rows are the graph's
        pair_u: Dict[Tuple[int, int], np.ndarray] = {}
        for hd in range(H):
            for t in range(1, H):
                u = sorted_unique(src[xe[key == hd * H + (hd + t) % H]])
                pair_u[(hd, t)] = u
                dcn_rows += len(u)
        u_max = round_up(max(max(len(u) for u in pair_u.values()), 8), 8 * C)
        halo = np.full((H - 1, u_max), -1, np.int64)
        for t in range(1, H):
            g = (h + t) % H
            ids = xe[key == h * H + g]
            ids = ids[shard_d[ids] == h * C + k]
            pos = np.searchsorted(pair_u[(h, t)], src[ids])
            cross.append(_bucket(dst[ids] - lo, pos, w[ids], rows, None))
            # what this host ships at step t: the rows host (h - t) % H needs
            u = pair_u[((h - t) % H, t)]
            halo[t - 1, : len(u)] = u - h * C * rows
    return _Direction(tuple(intra), tuple(cross), torch.from_numpy(halo), u_max,
                      dcn_rows)


def build_hier_graph(edge_index: np.ndarray, n_node: int, mesh: DeviceMesh,
                     edge_weight: Optional[np.ndarray] = None, *,
                     host_axis: str = "host", chip_axis: str = "chip",
                     rb: int = 128) -> HierGraph:
    """This rank's ``HierGraph`` (on the CPU; ``.to(device)``) from the host
    edge list ``[2, E]`` that every rank holds whole (JAX ``:263-335``).
    The mesh's world order must put host ``h``'s card ``c`` at shard
    ``h * C + c`` (the axes in that order)."""
    H, C = mesh.shape[host_axis], mesh.shape[chip_axis]
    h, k = mesh.coords[host_axis], mesh.coords[chip_axis]
    world = mesh.world
    if world.world_size != H * C or world.shard != h * C + k:
        raise ValueError(f"the mesh {mesh} does not put ({host_axis}, {chip_axis}) "
                         f"({h}, {k}) at shard h * C + c of a world of H * C")
    e = np.asarray(edge_index, np.int64)
    w = (np.ones(e.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    n_node_pad = round_up(n_node, H * C * rb)
    rows = n_node_pad // (H * C)
    lo = (h * C + k) * rows
    deg_out = np.bincount(e[0], minlength=n_node_pad).astype(np.float32)
    deg_in = np.bincount(e[1], minlength=n_node_pad).astype(np.float32)
    return HierGraph(
        comm=world, chip_comm=mesh.comm(chip_axis), host_comm=mesh.comm(host_axis),
        fwd=_build_direction(e[0], e[1], w, rows, H, C, h, k),
        bwd=_build_direction(e[1], e[0], w, rows, H, C, h, k),
        deg_out=torch.from_numpy(deg_out[lo: lo + rows].copy()),
        deg_in=torch.from_numpy(deg_in[lo: lo + rows].copy()),
        n_node=n_node, n_node_pad=n_node_pad, rows_per_shard=rows, rb=rb)


def _launch(g: HierGraph, kernel, b: Bucket, table: torch.Tensor,
            y: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``y`` plus bucket ``b``'s product with ``table``; an empty bucket
    launches nothing."""
    if not b.n_edge:
        g.comm.counts["skipped_buckets"] += 1
        return y
    part = kernel(b.indptr, b.indices, b.weight, table, schedule=b.schedule)
    return part if y is None else y.add_(part)


def intra_ring(g: HierGraph, x: torch.Tensor, kernel,
               y: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """The ring within the host: ``y`` plus the intra buckets' products
    (None where every bucket is empty)."""
    C, k = g.n_chips, g.chip_comm.shard
    blk = x
    for t in range(C):
        shift = g.chip_comm.ring_shift(blk) if t < C - 1 else None
        y = _launch(g, kernel, g.intra[(k + t) % C], blk, y)
        if shift is not None:
            blk = shift.wait()
    return y


def halo_exchange(g: HierGraph, x: torch.Tensor, t: int) -> torch.Tensor:
    """The ``[u_max, d]`` halo this rank receives at cross step ``t``, the
    rows of host ``(h + t) % H`` that host ``h`` needs (module docstring)."""
    k, rows, u_sl = g.chip_comm.shard, g.rows_per_shard, g.u_max // g.n_chips
    local = g.halo_idx[t - 1] - k * rows
    ok = (local >= 0) & (local < rows)
    halo = torch.where(ok[:, None], x[local.clamp(0, rows - 1)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    g.chip_comm.all_reduce_sum_(halo)  # this host's whole halo, on each card
    recv = g.host_comm.ring_shift(halo[k * u_sl: (k + 1) * u_sl], offset=t).wait()
    return g.chip_comm.all_gather(recv).reshape(g.u_max, -1)


def _hier(g: HierGraph, x: torch.Tensor, kernel) -> torch.Tensor:
    y = intra_ring(g, x, kernel)
    for t in range(1, g.n_hosts):
        y = _launch(g, kernel, g.cross[t - 1], halo_exchange(g, x, t), y)
    if y is None:
        y = torch.zeros(g.rows_per_shard, x.shape[1], dtype=torch.float32,
                        device=x.device)
    return y


class _HierSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, method):
        ctx.g, ctx.method, ctx.x_dtype = g, method, x.dtype
        return _hier(g, x, ring_kernel(method)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        dx = _hier(ctx.g.transpose(), dy.contiguous(), ring_kernel(ctx.method))
        return dx.to(ctx.x_dtype), None, None


def hier_spmm(g: HierGraph, x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """``y = A @ x`` on this rank's rows (JAX ``:338-413``): ``x`` and ``y``
    are ``[rows_per_shard, d]``; the backward is the same on the transposed
    graph."""
    _check_rows(g, x)
    return _HierSpMM.apply(x.contiguous(), g, method)


def hier_comm_stats(g: HierGraph, d_feat: int = 128, itemsize: int = 4) -> dict:
    """The cross-host and within-host volume of one ``hier_spmm`` against
    the flat ring's (JAX ``:416-434``, the same keys): the cross-host bytes
    are the padded halo blocks, one host hop a pair; the flat ring passes
    every block S - 1 times. On a transposed graph ``dcn_rows_halo_unpadded``
    is the transposed direction's (``dcn_rows_t``)."""
    H, C = g.n_hosts, g.n_chips
    pairs = H * (H - 1)
    flat_ring_rows = (H * C - 1) * g.n_node_pad
    return {
        "dcn_rows_halo_unpadded": int(g.dcn_rows),
        "dcn_bytes_per_spmm": int(pairs * g.u_max * d_feat * itemsize),
        "dcn_rows_padded": int(pairs * g.u_max),
        "ici_ring_rows_per_spmm": int((C - 1) * g.n_node_pad),
        "flat_ring_rows_per_spmm": int(flat_ring_rows),
        "flat_over_hier_dcn": float(flat_ring_rows / max(pairs * g.u_max, 1)),
    }

