"""Checkpoint / resume: save and load of state trees (parameters, SE
tables, optimizer state, the epoch counter).

The port of ``gnn_tail_generalization_tpu/train/checkpoint.py`` (the
reference's ``torch.save``/``load`` of state_dicts, ``utils.py:958-986``).
A tree is written with ``torch.save`` after its numpy arrays became tensors
and every tensor was moved to the host, so it holds tensors, numbers,
strings, lists, tuples and dicts only, and ``torch.load(weights_only=True)``
reads it back: no pickle of arbitrary objects. ``torch.optim`` state_dicts
are such trees. The JAX package's sharded orbax pair comes with the
multi-device layer.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch


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


def save_train_state(path: str, *, params, opt_state=None, batch_stats=None,
                     epoch: int = 0, extra: Optional[dict] = None) -> None:
    """One file at ``path``: ``params`` (a model's state_dict: parameters
    and buffers), ``epoch``, and where given the optimizer's state_dict,
    separate batch statistics and ``extra``."""
    state = {"params": params, "epoch": epoch}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if batch_stats is not None:
        state["batch_stats"] = batch_stats
    if extra:
        state["extra"] = extra
    save_pytree(state, path)


def load_train_state(path: str, template: Optional[dict] = None,
                     map_location="cpu") -> dict:
    return load_pytree(template, path, map_location)
