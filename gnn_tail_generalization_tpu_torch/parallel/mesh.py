"""The rank grid: a ``torch.distributed`` counterpart of ``jax.make_mesh``.

The JAX package lays its devices on a named mesh (``jax.make_mesh``,
``parallel/distributed.py:make_graph_mesh``, ``parallel/tensor_parallel.py:
make_2d_mesh``) and ``shard_map`` runs a collective over one axis of it. Here
each rank is a process, and ``DeviceMesh(world, shape, names)`` gives it:

- its coordinates: the mesh's positions are the world ``Comm``'s shards in
  row-major order, as ``jax.make_mesh`` orders its devices, so position
  ``p`` of a ``(graph, model)`` mesh is ``g = p // M``, ``m = p % M``, and of
  a ``(host, chip)`` mesh ``h = p // C``, ``c = p % C``;
- one ``Comm`` an axis (``comm(name)``), over the ranks that differ from
  this one in that coordinate only, in axis order, and the world ``Comm``.

Building a mesh is collective: every rank of the world must build the same
meshes in the same order, since ``torch.distributed.new_group`` must be
called by every rank for every group, the groups a rank is not in
included, or the processes hang. A line of one rank needs no group, and a
line over every rank takes the world's group.

``parallel/launch.py:spawn(..., mesh=(shape, names))`` and
``parallel/multihost.py:initialize_multihost(..., mesh=...)`` build one.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .comm import Comm

GRAPH_MODEL = ("graph", "model")  # the 2-D mesh (parallel/distgraph.py)
HOST_CHIP = ("host", "chip")  # the two-level layout (parallel/hier.py)


class DeviceMesh:
    def __init__(self, world: Comm, shape: Sequence[int], names: Sequence[str]):
        shape, names = tuple(int(v) for v in shape), tuple(names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs one distinct name an axis: {shape}, {names}")
        if int(np.prod(shape)) != world.world_size or min(shape) < 1:
            raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))} "
                             f"ranks, the world has {world.world_size}")
        self.world, self.names = world, names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        grid = np.arange(world.world_size).reshape(shape)
        self.coords: Dict[str, int] = _coords(world.shard, names, shape)
        self._comms: Dict[str, Comm] = {}
        for a, name in enumerate(names):  # every rank, every line, one order
            for line in _lines(grid, a):
                ranks = [world.order[p] for p in line]
                group = _group(ranks, world)
                if world.rank in ranks:
                    self._comms[name] = Comm(world.rank, len(ranks), world.device,
                                             world.transport, order=ranks, group=group)

    @classmethod
    def layout(cls, shape: Sequence[int], names: Sequence[str], position: int,
               device="cpu") -> "DeviceMesh":
        """The mesh as position ``position`` sees it, with no process group:
        its ``Comm``s have the shards and sizes of the real ones and run no
        collective. Enough to build and inspect that rank's layout in one
        process."""
        shape = tuple(int(v) for v in shape)
        size = int(np.prod(shape))
        mesh = cls(Comm(position, size, device, "gloo"), (size,), ("_world",))
        mesh.names, mesh.shape = tuple(names), dict(zip(names, shape))
        mesh.coords = _coords(position, names, shape)
        mesh._comms = {n: Comm(mesh.coords[n], mesh.shape[n], device, "gloo")
                       for n in names}
        return mesh

    def comm(self, name: str) -> Comm:
        """The ``Comm`` of axis ``name``: its shard is this rank's coordinate."""
        if name not in self._comms:
            raise ValueError(f"the mesh has axes {self.names}, not {name!r}")
        return self._comms[name]

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def device(self):
        return self.world.device

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, rank {self.world.rank} at {self.coords})"


def _coords(position: int, names, shape) -> Dict[str, int]:
    return {n: int(c) for n, c in zip(names, np.unravel_index(position, shape))}


def _lines(grid: np.ndarray, axis: int) -> List[Tuple[int, ...]]:
    """The positions of each line along ``axis``, in a fixed order."""
    moved = np.moveaxis(grid, axis, -1)
    return [tuple(int(p) for p in moved[idx])
            for idx in itertools.product(*(range(n) for n in moved.shape[:-1]))]


def _group(ranks: Sequence[int], world: Comm):
    """The process group of ``ranks``: none for one rank or the whole world
    (the default group), else a new group, made by every rank."""
    if len(ranks) == 1 or len(ranks) == world.world_size:
        return None
    return dist.new_group(ranks=sorted(ranks))


def parse_hier_mesh(spec: str) -> Tuple[int, int]:
    """``"HxC"`` (e.g. ``"2x4"``) as ``(H, C)``; raises ``ValueError``
    otherwise."""
    parts = str(spec).lower().split("x")
    try:
        h, c = (int(v) for v in parts)
    except ValueError:
        raise ValueError(f"--hier_mesh takes HxC (hosts x cards a host, e.g. "
                         f"2x4), got {spec!r}") from None
    if h < 1 or c < 1:
        raise ValueError(f"--hier_mesh {spec!r}: both counts must be positive")
    return h, c
