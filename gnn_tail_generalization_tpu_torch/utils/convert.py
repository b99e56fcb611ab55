"""Parameters of the JAX package's TeacherGNN as the port's state_dict.

``flat`` maps the '/'-joined paths of the flax ``params`` tree (as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives them) to numpy
arrays, e.g. ``backbone/conv_0/kernel``. A flax ``Dense`` kernel ``[in, out]``
becomes a ``Linear.weight`` ``[out, in]``; the conv kernel keeps its
``[in, out]`` layout.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from ..models.teacher import TeacherGNN

_DENSE = {"Dense_0": "input_dense", "out_mlp": "out_mlp"}


def _port_name(path: str):
    """(port state_dict name, transpose?) for a flax parameter path."""
    if path == "input_embs":
        return "input_embs", False
    m = re.fullmatch(r"backbone/conv_(\d+)/(kernel|se|bias)", path)
    if m:
        leaf = {"kernel": "weight", "se": "se", "bias": "bias"}[m.group(2)]
        return f"backbone.convs.{m.group(1)}.{leaf}", False
    m = re.fullmatch(r"backbone/(Dense_0|out_mlp)/(kernel|bias)", path)
    if m:
        leaf = "weight" if m.group(2) == "kernel" else "bias"
        return f"backbone.{_DENSE[m.group(1)]}.{leaf}", leaf == "weight"
    raise KeyError(f"no port parameter for flax path {path!r}")


def params_from_jax(flat: Mapping[str, np.ndarray], cfg: Config
                    ) -> Dict[str, torch.Tensor]:
    """The state_dict of ``TeacherGNN(cfg)`` holding the flax parameters.
    Raises if a parameter is missing, extra or of the wrong shape."""
    out = {}
    for path, arr in flat.items():
        name, transpose = _port_name(path.removeprefix("params/"))
        a = np.asarray(arr, np.float32)
        out[name] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    with torch.device("meta"):  # names and shapes only, no memory
        expected = {k: tuple(v.shape) for k, v in TeacherGNN(cfg).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != expected:
        raise ValueError(f"flax parameters do not fit the config's model: "
                         f"missing {sorted(expected.keys() - got.keys())}, "
                         f"extra {sorted(got.keys() - expected.keys())}, "
                         f"shapes {[(k, got[k], expected[k]) for k in got.keys() & expected.keys() if got[k] != expected[k]]}")
    return out
