"""Joining a process group that spans hosts, with a ring order that keeps
ring neighbours on one host.

The port of ``gnn_tail_generalization_tpu/parallel/multihost.py``:

- ``initialize_multihost`` becomes ``torch.distributed.init_process_group``:
  from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) when no argument is given, else from the
  explicit ``rank``, ``world_size`` and ``init_method``. It returns the
  rank's ``Comm``.
- ``make_multihost_graph_mesh`` becomes ``host_major_order``: the ranks
  grouped by host, so that contiguous row shards, and therefore the ring's
  neighbours, sit on one host for all but one hop per host boundary (the
  JAX mesh's host-major device order, ``multihost.py:81-87``).
- ``initialize_multihost(..., mesh=(shape, names))`` lays the ranks on a
  ``parallel/mesh.py:DeviceMesh`` in that order, the last axis within a
  host: under torchrun a ``(host, chip)`` mesh's host axis is the node, so
  ``LOCAL_WORLD_SIZE`` must equal the mesh's last extent ``C``.
"""
from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .comm import Comm
from .mesh import DeviceMesh


def host_major_order(hosts: Sequence[str]) -> List[int]:
    """The ranks ordered by host (hosts in order of their lowest rank), then
    by rank: position ``s`` of the result is the rank that holds shard ``s``.
    ``hosts[r]`` is rank ``r``'s host name."""
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    return sorted(range(len(hosts)), key=lambda r: (first[hosts[r]], r))


def initialize_multihost(transport: str, device: str = "cuda", *,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         init_method: Optional[str] = None,
                         mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None
                         ) -> Union[Comm, DeviceMesh]:
    """Joins the process group and returns this rank's ``Comm``, its ring in
    ``host_major_order``. With no ``rank``/``world_size``, both come from
    torchrun's environment and ``init_method`` defaults to ``env://``.
    ``device="cuda"`` takes card ``LOCAL_RANK`` (else ``rank``) modulo the
    host's count; NCCL needs a card a rank on each host. ``mesh``: return
    the ``DeviceMesh`` of that shape instead, its last axis within a host
    (raises unless each host holds that many ranks)."""
    if rank is None or world_size is None:
        try:
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        except KeyError:
            raise RuntimeError("no rank and world size given, and none in the "
                               "environment (RANK, WORLD_SIZE): start under "
                               "torchrun or pass them") from None
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("device='cuda', but torch finds no CUDA device")
        if transport == "nccl" and local >= count:
            raise RuntimeError(f"local rank {local} has no card of its own "
                               f"({count} found); NCCL takes one card a rank")
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(transport, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    hosts: List[Optional[str]] = [None] * world_size
    dist.all_gather_object(hosts, socket.gethostname())
    comm = Comm(rank, world_size, dev, transport, order=host_major_order(hosts))
    if mesh is None:
        return comm
    shape, names = mesh
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    counts = {h: hosts.count(h) for h in hosts}
    if per_host != shape[-1] or set(counts.values()) != {shape[-1]}:
        raise ValueError(f"a mesh of shape {tuple(shape)} keeps its last axis on one "
                         f"host: each host needs {shape[-1]} ranks (LOCAL_WORLD_SIZE="
                         f"{per_host}, ranks a host {counts})")
    return DeviceMesh(comm, shape, names)
