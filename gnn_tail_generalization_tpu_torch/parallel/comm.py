"""The communicator of the sharded path: the collectives the JAX package's
``shard_map`` code uses, over ``torch.distributed``.

One ``Comm`` per rank holds its rank, the world size, its device, the
transport and the ring order. Two transports, named by the caller:

- ``"nccl"``: one card a rank; tensors go to NCCL where they lie.
- ``"gloo"``: the CPU, or several ranks on one card. A CUDA tensor is staged
  through a pinned host buffer for every collective, since gloo's
  point-to-point calls take no CUDA tensor; the compute stays on the card.

A failed NCCL set-up raises: nothing switches to gloo behind the caller's
back. The collectives:

- ``ring_shift(t, offset=1)``: the JAX ring (``parallel/distgraph.py:
  452-453``, a ``ppermute`` with device ``i`` sending to ``(i - 1) % S``):
  shard ``s`` sends ``t`` to shard ``s - offset`` and receives shard
  ``s + offset``'s, so after ``t`` shifts of 1 shard ``s`` holds the block of
  shard ``(s + t) % S``; ``offset`` t is the host-axis hop of
  ``parallel/hier.py`` (JAX ``hier.py:403-404``). It returns a handle whose
  ``wait()`` gives the received block, so a caller can compute while the
  block moves.
- ``all_reduce_sum(t)``: the sum over the ranks, differentiable (its
  backward is the same sum of the gradients, as ``psum``'s transpose), for
  cross-shard norms, the SE regulariser and ``dist_take_rows``.
- ``all_reduce_sum_(t)``: the same in place, outside autograd (gradients,
  metrics).
- ``all_gather(t)``: every shard's ``t``, stacked in shard order into
  ``[S, *t.shape]`` (``all_gather_into_tensor`` over NCCL), outside
  autograd: the sharded latent-neighbour op's candidates.
- ``reduce_scatter_sum(t)``: of ``[S * r, ...]`` ``t``, the sum over the
  ranks of the ``r`` rows at this shard's place in shard order
  (``reduce_scatter_tensor``), outside autograd.

``gather_rows(t, comm)`` is the differentiable row all-gather: the shards'
``[r, d]`` blocks stacked in shard order into ``[S * r, d]``
(``jax.lax.all_gather(..., tiled=True)``), whose backward is the transpose,
``reduce_scatter_sum`` of the gradient (``parallel/distributed.py``).

Shard ``s`` is the rank at position ``s`` of ``order`` (default: rank order);
``parallel/multihost.py`` gives an order that keeps ring neighbours on one
host. A ``Comm`` over a sub-group (one axis of ``parallel/mesh.py:
DeviceMesh``) takes the ``torch.distributed`` group and, as ``order``, the
global ranks of its members in axis order; ``world_size`` is then the
group's size and ``rank`` stays the global rank. Point-to-point peers are
global ranks even within a group; each ``Comm`` keeps its own counts.

The model axis of the 2-D graph x model mesh (``parallel/distgraph.py``)
adds four differentiable moves over a ``Comm``, Megatron's column-parallel
pair and its inverse, for tensors that every rank of the group holds whole
and computes alike downstream:

- ``copy_to(t, comm)``: the identity, whose backward sums the gradient over
  the group (each rank's gradient is a part, as after a column slice of a
  matmul's weight);
- ``reduce_from(t, comm)``: the sum over the group, whose backward is the
  identity (every rank computes the downstream loss whole);
- ``split_cols(t, comm)``: this shard's column slice, whose backward
  all-gathers the slices' gradients;
- ``gather_cols(t, comm)``: the shards' column slices side by side, whose
  backward takes this shard's slice of the gradient and sums nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo")


class Comm:
    def __init__(self, rank: int, world_size: int, device, transport: str,
                 order: Optional[Sequence[int]] = None, group=None):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        self.rank, self.world_size = rank, world_size
        self.device = torch.device(device)
        self.transport = transport
        self.group = group
        self.order: List[int] = list(range(world_size) if order is None else order)
        if group is None and world_size > 1 and sorted(self.order) != list(range(world_size)):
            raise ValueError(f"order {self.order} is not a permutation of the ranks")
        if len(set(self.order)) != world_size or rank not in self.order:
            raise ValueError(f"order {self.order} is not {world_size} distinct ranks "
                             f"holding rank {rank}")
        self.shard = self.order.index(rank)
        # position s of a collective's output (the group's rank order, which
        # sorts the global ranks) holding shard s's part
        ranked = sorted(self.order)
        self._to_shard_order = [ranked.index(r) for r in self.order]
        # the shard whose block goes to position p of a collective's input
        # (the group's rank order)
        self._to_rank_order = [self.order.index(r) for r in ranked]
        # pinned host buffers of the gloo transport, by (role, shape, dtype)
        self._host: Dict[Tuple, torch.Tensor] = {}
        #: collectives started, and ring buckets that had no edge to launch on
        self.counts = {"ring_shifts": 0, "all_reduces": 0, "all_gathers": 0,
                       "reduce_scatters": 0, "skipped_buckets": 0}

    @property
    def staged(self) -> bool:
        """Whether collectives go through pinned host buffers."""
        return self.transport == "gloo" and self.device.type == "cuda"

    def _host_buffer(self, role: str, like: torch.Tensor) -> torch.Tensor:
        key = (role, tuple(like.shape), like.dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sums ``t`` over the ranks in place; returns ``t``."""
        if self.world_size == 1:
            return t
        self.counts["all_reduces"] += 1
        if not self.staged:
            dist.all_reduce(t, group=self.group)
            return t
        h = self._host_buffer("reduce", t)
        h.copy_(t)  # waits for the card
        dist.all_reduce(h, group=self.group)
        t.copy_(h)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[S, *t.shape]``: position ``s`` holds shard ``s``'s ``t``."""
        t = t.contiguous()
        if self.world_size == 1:
            return t.unsqueeze(0).clone()
        self.counts["all_gathers"] += 1
        shape = (self.world_size,) + tuple(t.shape)
        if self.transport == "nccl":
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.group)
        else:
            send, recv = t, torch.empty(shape, dtype=t.dtype)
            if self.staged:
                send = self._host_buffer("gather", t)
                send.copy_(t)  # waits for the card
                recv = self._host_buffer("gathered", recv)
            dist.all_gather(list(recv.unbind(0)), send, group=self.group)
            out = recv.to(t.device, copy=True)  # the host buffer is reused
        if self.order != sorted(self.order):  # group rank order -> shard order
            out = out[torch.tensor(self._to_shard_order, device=out.device)]
        return out

    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``[r, *rest]``: the sum over the ranks of rows ``shard * r`` to
        ``(shard + 1) * r`` of ``[S * r, *rest]`` ``t``, whose blocks are in
        shard order."""
        if t.shape[0] % self.world_size:
            raise ValueError(f"{t.shape[0]} rows do not split over {self.world_size} "
                             f"shards")
        if self.world_size == 1:
            return t.clone()
        self.counts["reduce_scatters"] += 1
        blocks = t.reshape(self.world_size, -1, *t.shape[1:])
        if self.order != sorted(self.order):  # shard order -> group rank order
            blocks = blocks[torch.tensor(self._to_rank_order, device=t.device)]
        send = blocks.reshape(t.shape).contiguous()
        out = torch.empty(blocks.shape[1:], dtype=t.dtype, device=t.device)
        if not self.staged:
            dist.reduce_scatter_tensor(out, send, group=self.group)
            return out
        h_in, h_out = self._host_buffer("scatter", send), self._host_buffer("scattered", out)
        h_in.copy_(send)  # waits for the card
        dist.reduce_scatter_tensor(h_out, h_in, group=self.group)
        return out.copy_(h_out)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable."""
        if self.world_size == 1:
            return t
        return _AllReduceSum.apply(t, self)

    def ring_shift(self, t: torch.Tensor, offset: int = 1) -> "RingShift":
        """Starts sending ``t`` to shard ``shard - offset`` and receiving the
        block of shard ``shard + offset``, of the same shape and type."""
        nxt = self.order[(self.shard + offset) % self.world_size]
        prv = self.order[(self.shard - offset) % self.world_size]
        t = t.contiguous()
        self.counts["ring_shifts"] += 1
        if self.staged:
            send, recv = self._host_buffer("send", t), self._host_buffer("recv", t)
            send.copy_(t)
        else:
            send, recv = t, torch.empty_like(t)
        # the peers are global ranks, with or without a group
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, prv, group=self.group),
            dist.P2POp(dist.irecv, recv, nxt, group=self.group)])
        return RingShift(works, recv, t.device if self.staged else None)


class RingShift:
    """A block in flight around the ring; ``wait()`` returns it."""

    def __init__(self, works, recv: torch.Tensor, device: Optional[torch.device]):
        self._works, self._recv, self._device = works, recv, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        if self._device is None:
            return self._recv
        return self._recv.to(self._device)  # a copy: the host buffer is reused


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce_sum_(grad.contiguous().clone()), None


def gather_rows(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``[S * r, d]``: the shards' ``[r, d]`` row blocks in shard order; its
    gradient reduce-scattered back (module docstring)."""
    return t if comm.world_size == 1 else _GatherRows.apply(t, comm)


def copy_to(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``t``; its gradient summed over ``comm`` (module docstring)."""
    return t if comm.world_size == 1 else _CopyTo.apply(t, comm)


def reduce_from(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The sum of ``t`` over ``comm``; its gradient passed on as it is."""
    return t if comm.world_size == 1 else _ReduceFrom.apply(t, comm)


def split_cols(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Shard ``comm.shard``'s slice of the columns of ``[n, d]`` ``t``
    (``d`` a multiple of the group's size)."""
    return t if comm.world_size == 1 else _SplitCols.apply(t, comm)


def gather_cols(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``[n, d * S]``: the shards' ``[n, d]`` column slices in shard order."""
    return t if comm.world_size == 1 else _GatherCols.apply(t, comm)


def own_cols(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Shard ``comm.shard``'s slice of the columns of ``[n, d]`` ``t``, outside
    autograd."""
    w = t.shape[1] // comm.world_size
    return t[:, comm.shard * w: (comm.shard + 1) * w].contiguous()


def _cat_cols(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    parts = comm.all_gather(t)  # [S, n, w]
    return parts.permute(1, 0, 2).reshape(t.shape[0], -1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_gather(t).reshape(-1, *t.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce_scatter_sum(grad.contiguous()), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce_sum_(grad.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        return comm.all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return own_cols(t, comm)

    @staticmethod
    def backward(ctx, grad):
        return _cat_cols(grad.contiguous(), ctx.comm), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return _cat_cols(t, comm)

    @staticmethod
    def backward(ctx, grad):
        return own_cols(grad, ctx.comm), None
