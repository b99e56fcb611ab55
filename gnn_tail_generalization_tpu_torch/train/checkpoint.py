"""Checkpoint / resume: save and load of state trees (parameters, SE
tables, optimizer state, the epoch counter).

The port of ``gnn_tail_generalization_tpu/train/checkpoint.py`` (the
reference's ``torch.save``/``load`` of state_dicts, ``utils.py:958-986``).
A tree is written with ``torch.save`` after its numpy arrays became tensors
and every tensor was moved to the host, so it holds tensors, numbers,
strings, lists, tuples and dicts only, and ``torch.load(weights_only=True)``
reads it back: no pickle of arbitrary objects. ``torch.optim`` state_dicts
are such trees.

The sharded pair (JAX ``save_sharded_state`` / ``load_sharded_state``, on
orbax there): a rank of a sharded run saves with its ``ShardLayout``, and
the state goes to the directory ``<path without suffix>.shards``: one file
a shard with its rows of each row-sharded tensor (the tensors whose key
names a row-sharded parameter, ``parallel/distgraph.py:is_row_sharded``),
the rest written once by shard 0, and a manifest of the layout, written
last. Loading rebuilds each row-sharded tensor over the padded node axis
and cuts it for the loader's number of shards, one (the unpadded one-device
layout) included, as orbax reshards on load. Where a file and a directory
are both at a path, the newer one is read (``load_train_state``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.comm import Comm
from ..parallel.distgraph import is_row_sharded

MANIFEST, REPLICATED = "manifest.pt", "replicated.pt"
_SHARDED = "<row-sharded>"  # where a row-sharded tensor sits in replicated.pt


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """The row layout a rank saves with: its communicator, the graph's
    node count and its padded count (``n_node_pad / S`` rows a shard)."""

    comm: Comm
    n_node: int
    n_node_pad: int


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _check_like(got: Any, want: Any, path: str = "") -> None:
    """Raise unless ``got`` has the structure of ``want``: the same dict
    keys and sequence lengths, and tensors of the same shape and dtype."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise ValueError(f"checkpoint{path}: keys "
                             f"{sorted(got) if isinstance(got, dict) else type(got)}"
                             f" != {sorted(want)}")
        for k in want:
            _check_like(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"checkpoint{path}: not a sequence of {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _check_like(a, b, f"{path}/{i}")
    elif isinstance(want, (torch.Tensor, np.ndarray)):
        w = torch.as_tensor(want)
        if not isinstance(got, torch.Tensor) or got.shape != w.shape \
                or got.dtype != w.dtype:
            raise ValueError(f"checkpoint{path}: {got!r:.80} does not fit "
                             f"{tuple(w.shape)} {w.dtype}")


def save_pytree(tree: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_to_host(tree), path)


def load_pytree(template: Optional[Any], path: str, map_location="cpu") -> Any:
    """The tree saved at ``path``, read with ``weights_only=True`` onto
    ``map_location``. With a ``template`` it must have its structure, and
    tensor shapes and dtypes (as the JAX package's structure-validated
    restore)."""
    tree = torch.load(path, map_location=map_location, weights_only=True)
    if template is not None:
        _check_like(tree, _to_host(template))
    return tree


def sharded_dir(path: str) -> str:
    """The directory of the sharded state saved for ``path``."""
    return os.path.splitext(path)[0] + ".shards"


def _split(tree: Any, prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Any]:
    """(the row-sharded tensors of the dicts in ``tree`` by their
    '/'-joined key path, ``tree`` with each of them replaced by a marker)."""
    if not isinstance(tree, dict):
        return {}, tree
    rows, rest = {}, {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, torch.Tensor) and is_row_sharded(str(k)):
            rows[path], rest[k] = v, _SHARDED
        else:
            sub_rows, rest[k] = _split(v, path + "/")
            rows.update(sub_rows)
    return rows, rest


def _join(rest: Any, rows: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    if not isinstance(rest, dict):
        return rest
    return {k: rows[f"{prefix}{k}"] if isinstance(v, str) and v == _SHARDED
            else _join(v, rows, f"{prefix}{k}/") for k, v in rest.items()}


def _barrier(comm: Comm) -> None:
    comm.all_reduce_sum_(torch.zeros(1, device=comm.device))


def save_sharded_state(dirpath: str, state: Any, layout: ShardLayout) -> None:
    """This rank's part of ``state`` into ``dirpath`` (module docstring);
    every rank calls it, and it returns once the manifest is written."""
    comm = layout.comm
    s = comm.world_size
    os.makedirs(dirpath, exist_ok=True)
    if comm.shard == 0:  # no manifest while the shards are being written
        for name in os.listdir(dirpath):
            if name == MANIFEST or (name.startswith("shard_") and
                                    int(name[6:-3]) >= s):
                os.remove(os.path.join(dirpath, name))
    rows, rest = _split(_to_host(state))
    torch.save(rows, os.path.join(dirpath, f"shard_{comm.shard}.pt"))
    if comm.shard == 0:
        torch.save(rest, os.path.join(dirpath, REPLICATED))
    _barrier(comm)  # every shard written
    if comm.shard == 0:
        torch.save({"n_shards": s, "n_node": layout.n_node,
                    "n_node_pad": layout.n_node_pad,
                    "rows_per_shard": layout.n_node_pad // s},
                   os.path.join(dirpath, MANIFEST))
    _barrier(comm)


def load_sharded_state(dirpath: str, *, shard: int = 0, n_shards: int = 1,
                       n_node_pad: Optional[int] = None,
                       map_location="cpu") -> Any:
    """The state saved in ``dirpath``, each row-sharded tensor cut for
    shard ``shard`` of ``n_shards`` over ``n_node_pad`` padded rows (default:
    the graph's unpadded node count, the one-device layout): the saved
    padded rows are put back together, cut or zero-padded to
    ``n_node_pad``, and sliced. Read with ``weights_only=True``."""
    def load(name):
        return torch.load(os.path.join(dirpath, name), map_location=map_location,
                          weights_only=True)

    man = load(MANIFEST)
    target = man["n_node"] if n_node_pad is None else n_node_pad
    if target < man["n_node"] or target % n_shards:
        raise ValueError(f"{target} rows do not hold the {man['n_node']} nodes in "
                         f"{n_shards} equal shards")
    parts = [load(f"shard_{k}.pt") for k in range(man["n_shards"])]
    rows = target // n_shards
    out = {}
    for key in parts[0]:
        full = torch.cat([p[key] for p in parts])[:target]
        if full.shape[0] < target:
            full = torch.cat([full, full.new_zeros((target - full.shape[0],)
                                                   + full.shape[1:])])
        out[key] = full[shard * rows: (shard + 1) * rows].clone()
    return _join(load(REPLICATED), out)


def save_train_state(path: str, *, params, opt_state=None, batch_stats=None,
                     epoch: int = 0, extra: Optional[dict] = None,
                     layout: Optional[ShardLayout] = None) -> None:
    """``params`` (a model's state_dict: parameters and buffers),
    ``epoch``, and where given the optimizer's state_dict, separate batch
    statistics and ``extra``: one file at ``path``, or, from a rank of a
    sharded run (``layout``), the directory ``sharded_dir(path)``, after
    which shard 0 removes a file left at ``path`` by an earlier run."""
    state = {"params": params, "epoch": epoch}
    if opt_state is not None:
        if layout is not None:
            raise ValueError("an optimizer state is not cut into row shards")
        state["opt_state"] = opt_state
    if batch_stats is not None:
        state["batch_stats"] = batch_stats
    if extra:
        state["extra"] = extra
    if layout is None:
        save_pytree(state, path)
        return
    save_sharded_state(sharded_dir(path), state, layout)
    if layout.comm.shard == 0 and os.path.exists(path):
        os.remove(path)


def load_train_state(path: str, template: Optional[dict] = None,
                     map_location="cpu", *, shard: int = 0, n_shards: int = 1,
                     n_node_pad: Optional[int] = None) -> dict:
    """The state saved for ``path``: the file, or the sharded directory
    (``load_sharded_state`` with ``shard``, ``n_shards`` and
    ``n_node_pad``), the newer of the two where both exist. With a
    ``template`` the result must have its structure (``load_pytree``)."""
    manifest = os.path.join(sharded_dir(path), MANIFEST)
    use_dir = os.path.exists(manifest) and not (
        os.path.exists(path) and os.path.getmtime(path) > os.path.getmtime(manifest))
    if not use_dir:
        return load_pytree(template, path, map_location)
    tree = load_sharded_state(sharded_dir(path), shard=shard, n_shards=n_shards,
                              n_node_pad=n_node_pad, map_location=map_location)
    if template is not None:
        _check_like(tree, _to_host(template))
    return tree
