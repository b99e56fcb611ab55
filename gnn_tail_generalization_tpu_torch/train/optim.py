"""Optimizer factory.

The port of ``gnn_tail_generalization_tpu/train/optim.py``. The JAX package
builds optax ``chain(add_decayed_weights(wd), adam(lr))`` to reproduce
``torch.optim.Adam(weight_decay=wd)`` — L2 added to the gradient before the
moment updates, not decoupled AdamW — so here it is that optimizer itself.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..config import Config


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                   lr: Optional[float] = None,
                   weight_decay: Optional[float] = None) -> torch.optim.Optimizer:
    lr = cfg.lr if lr is None else lr
    wd = cfg.weight_decay if weight_decay is None else weight_decay
    if cfg.optfun == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    if cfg.optfun == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=wd)
    raise ValueError(cfg.optfun)
