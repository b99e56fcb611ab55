"""Parameters of the JAX package's models as the port's state_dicts.

``flat`` maps the '/'-joined paths of a flax ``params`` tree (as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives them) to numpy
arrays, e.g. ``backbone/conv_0/kernel`` or ``MLP_0/Dense_1/bias``. Each path
is walked down the port's module alongside: every flax submodule name maps to
one submodule of the port (``_child``). At the leaf, a flax ``Dense`` kernel
``[in, out]`` becomes a ``Linear.weight`` ``[out, in]``, a ``LayerNorm``
``scale`` becomes its ``weight``, the conv kernel keeps its ``[in, out]``
layout, and a parameter of the module itself (``alphas``, ``input_embs``)
keeps its name.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models.semlp import GraphMLP, SEMLPPart1, SEMLPPart2, StudentBaseMLP
from ..models.teacher import TeacherGNN
from ..nn.backbone import TricksCombBackbone
from ..nn.gcn import GCNConv
from ..nn.mlp import MLP, BlockResMLP

# leaf name -> (port parameter name, transpose?)
_LEAVES = (
    (GCNConv, {"kernel": ("weight", False), "se": ("se", False),
               "bias": ("bias", False)}),
    (nn.Linear, {"kernel": ("weight", True), "bias": ("bias", False)}),
    (nn.LayerNorm, {"scale": ("weight", False), "bias": ("bias", False)}),
)


def _child(module: nn.Module, name: str) -> Optional[str]:
    """The port attribute under ``module`` that holds the flax submodule
    ``name``, or None."""
    m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
    kind, i = (m.group(1), int(m.group(2))) if m else (name, None)
    if isinstance(module, TeacherGNN) and name in ("backbone", "proj2class"):
        return name
    if isinstance(module, TricksCombBackbone):
        return {"conv": f"convs.{i}", "Dense": "input_dense" if i == 0 else None,
                "out_mlp": "out_mlp"}.get(kind)
    if isinstance(module, MLP):
        return {"Dense": f"dense.{i}", "LayerNorm": f"norms.{i}"}.get(kind)
    if isinstance(module, BlockResMLP):
        if kind == "MLP":
            return f"blocks.{i}"
        if kind == "Dense":  # flax numbers the projections that exist
            projs = [p for p in ("in_proj", "out_proj")
                     if getattr(module, p) is not None]
            return projs[i] if i < len(projs) else None
        return None
    if isinstance(module, (SEMLPPart1, SEMLPPart2, StudentBaseMLP)):
        return "net" if name in ("MLP_0", "BlockResMLP_0") else None
    if isinstance(module, GraphMLP):
        return {"MLP_0": "mlp", "Dense_0": "out"}.get(name)
    return None


def _port_name(module: nn.Module, parts) -> Tuple[str, bool]:
    head, rest = parts[0], parts[1:]
    if not rest:
        for cls, leaves in _LEAVES:
            if isinstance(module, cls) and head in leaves:
                return leaves[head]
        if head in dict(module.named_parameters(recurse=False)):
            return head, False
        raise KeyError(head)
    attr = _child(module, head)
    sub = module.get_submodule(attr) if attr else None
    if not isinstance(sub, nn.Module):
        raise KeyError(head)
    name, transpose = _port_name(sub, rest)
    return f"{attr}.{name}", transpose


def state_dict_from_flax(flat: Mapping[str, np.ndarray], module: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's ``module`` holding the flax parameters
    ``flat``. Raises if a parameter is missing, extra or of the wrong
    shape."""
    out = {}
    for path, arr in flat.items():
        path = path.removeprefix("params/")
        try:
            name, transpose = _port_name(module, path.split("/"))
        except (KeyError, AttributeError):
            raise KeyError(f"no port parameter for flax path {path!r}") from None
        a = np.asarray(arr, np.float32)
        out[name] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != expected:
        raise ValueError(f"flax parameters do not fit the port's module: "
                         f"missing {sorted(expected.keys() - got.keys())}, "
                         f"extra {sorted(got.keys() - expected.keys())}, "
                         f"shapes {[(k, got[k], expected[k]) for k in got.keys() & expected.keys() if got[k] != expected[k]]}")
    return out


def params_from_jax(flat: Mapping[str, np.ndarray], cfg: Config
                    ) -> Dict[str, torch.Tensor]:
    """The state_dict of ``TeacherGNN(cfg)`` holding the flax parameters."""
    with torch.device("meta"):  # names and shapes only, no memory
        model = TeacherGNN(cfg)
    return state_dict_from_flax(flat, model)
