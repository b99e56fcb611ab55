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

- ``ring_shift(t)``: the JAX ring (``parallel/distgraph.py:452-453``, a
  ``ppermute`` with device ``i`` sending to ``(i - 1) % S``): shard ``s``
  sends ``t`` to shard ``s - 1`` and receives shard ``s + 1``'s, so after
  ``t`` shifts shard ``s`` holds the block of shard ``(s + t) % S``. It
  returns a handle whose ``wait()`` gives the received block, so a caller
  can compute while the block moves.
- ``all_reduce_sum(t)``: the sum over the ranks, differentiable (its
  backward is the same sum of the gradients, as ``psum``'s transpose), for
  cross-shard norms, the SE regulariser and ``dist_take_rows``.
- ``all_reduce_sum_(t)``: the same in place, outside autograd (gradients,
  metrics).
- ``all_gather(t)``: every shard's ``t``, stacked in shard order into
  ``[S, *t.shape]`` (``all_gather_into_tensor`` over NCCL), outside
  autograd: the sharded latent-neighbour op's candidates.

Shard ``s`` is the rank at position ``s`` of ``order`` (default: rank order);
``parallel/multihost.py`` gives an order that keeps ring neighbours on one
host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo")


class Comm:
    def __init__(self, rank: int, world_size: int, device, transport: str,
                 order: Optional[Sequence[int]] = None):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        self.rank, self.world_size = rank, world_size
        self.device = torch.device(device)
        self.transport = transport
        self.order: List[int] = list(range(world_size) if order is None else order)
        if sorted(self.order) != list(range(world_size)):
            raise ValueError(f"order {self.order} is not a permutation of the ranks")
        self.shard = self.order.index(rank)
        # pinned host buffers of the gloo transport, by (role, shape, dtype)
        self._host: Dict[Tuple, torch.Tensor] = {}
        #: collectives started, and ring buckets that had no edge to launch on
        self.counts = {"ring_shifts": 0, "all_reduces": 0, "all_gathers": 0,
                       "skipped_buckets": 0}

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
            dist.all_reduce(t)
            return t
        h = self._host_buffer("reduce", t)
        h.copy_(t)  # waits for the card
        dist.all_reduce(h)
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
            dist.all_gather_into_tensor(out, t)
        else:
            send, recv = t, torch.empty(shape, dtype=t.dtype)
            if self.staged:
                send = self._host_buffer("gather", t)
                send.copy_(t)  # waits for the card
                recv = self._host_buffer("gathered", recv)
            dist.all_gather(list(recv.unbind(0)), send)
            out = recv.to(t.device, copy=True)  # the host buffer is reused
        if self.order != sorted(self.order):  # rank order -> shard order
            out = out[torch.tensor(self.order, device=out.device)]
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable."""
        if self.world_size == 1:
            return t
        return _AllReduceSum.apply(t, self)

    def ring_shift(self, t: torch.Tensor) -> "RingShift":
        """Starts sending ``t`` to the previous shard and receiving the next
        shard's block of the same shape and type."""
        nxt = self.order[(self.shard + 1) % self.world_size]
        prv = self.order[(self.shard - 1) % self.world_size]
        t = t.contiguous()
        self.counts["ring_shifts"] += 1
        if self.staged:
            send, recv = self._host_buffer("send", t), self._host_buffer("recv", t)
            send.copy_(t)
        else:
            send, recv = t, torch.empty_like(t)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, prv),
                                        dist.P2POp(dist.irecv, recv, nxt)])
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
