"""Start local ranks and collect what each returns.

``spawn(fn, world_size, transport, device, *args)`` starts ``world_size``
processes with the ``spawn`` start method (never ``fork``: the caller may
hold threads, a test process JAX's), joins them into one process group
through a ``file://`` rendezvous in a fresh temporary directory (so that
concurrent callers never race for a port), calls ``fn(comm, *args)`` in each
with its ``parallel/comm.py:Comm``, and returns the results in rank order.
``fn`` must be a module-level function: the child imports it by name.
With ``mesh=(shape, names)`` each rank gets, instead of its ``Comm``, the
``parallel/mesh.py:DeviceMesh`` of that shape over the world.
``fn`` and ``args`` are pickled once into that directory, not through each
process's pipe, so that the ranks start together (a child reads its pipe
only after its imports, and a large payload would hold each ``start`` until
then).

Devices: ``"cpu"`` runs every rank on the CPU (one thread each) over gloo.
``"cuda"`` gives rank ``r`` card ``r``; NCCL needs a card a rank, and gloo
may put several ranks on one card (rank ``r`` on card ``r % count``).

If a rank fails, the others are stopped and ``spawn`` raises
``RuntimeError`` with the failed rank's traceback; so does a run past
``timeout`` seconds.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .comm import TRANSPORTS, Comm
from .mesh import DeviceMesh


def rank_device(rank: int, transport: str, device: str) -> torch.device:
    """The device of ``rank`` (see the module docstring). Raises where the
    cards do not fit the transport."""
    if device == "cpu":
        if transport != "gloo":
            raise ValueError(f"the CPU takes the gloo transport, not {transport!r}")
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device='cuda', but torch finds no CUDA device")
    if transport == "nccl" and rank >= count:
        raise RuntimeError(
            f"rank {rank} has no card of its own ({count} found): NCCL takes one "
            f"card a rank; name the host-staged transport (gloo) to share one")
    return torch.device("cuda", rank % count)


def _child(rank: int, world_size: int, transport: str, device: str,
           root: str, mesh) -> None:
    try:
        with open(os.path.join(root, "program.pkl"), "rb") as f:
            fn, args = pickle.load(f)  # written by this rank's parent
        dev = rank_device(rank, transport, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(transport, init_method=f"file://{root}/rendezvous",
                                rank=rank, world_size=world_size)
        comm = Comm(rank, world_size, dev, transport)
        out = fn(comm if mesh is None else DeviceMesh(comm, *mesh), *args)
        dist.destroy_process_group()
        torch.save(out, os.path.join(root, f"result_{rank}.pt"))
    except BaseException:
        # no group teardown here: the other ranks may be waiting in a
        # collective, and the parent stops them once it sees this file
        path = os.path.join(root, f"error_{rank}.txt")
        with open(path + ".tmp", "w") as f:
            f.write(traceback.format_exc())
        os.replace(path + ".tmp", path)  # whole when the parent sees it
        raise


def spawn(fn: Callable, world_size: int, transport: str, device: str,
          *args: Any, timeout: float = 3600.0,
          mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None) -> List[Any]:
    """``[fn(comm_0, *args), ..., fn(comm_{S-1}, *args)]``, each in a
    process of its own (see the module docstring)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
    for r in range(world_size):  # fail here, before any process starts
        rank_device(r, transport, device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as root:
        with open(os.path.join(root, "program.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_child, args=(r, world_size, transport, device,
                                                  root, mesh), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or any(
                        os.path.exists(os.path.join(root, f"error_{r}.txt"))
                        for r in range(world_size)):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:  # a failed rank leaves the others in a collective
                if p.is_alive():
                    p.terminate()
                p.join(10)
        errors = [f"timed out after {timeout} s"] if timed_out else []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("spawned ranks failed\n" + "\n".join(errors))
        # written by this call's own ranks, so unpickling them is safe
        return [torch.load(os.path.join(root, f"result_{r}.pt"), weights_only=False)
                for r in range(world_size)]
