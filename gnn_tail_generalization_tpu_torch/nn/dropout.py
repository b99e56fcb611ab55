"""Dropout with an explicit generator.

The port of ``gnn_tail_generalization_tpu/nn/dropout.py``. The keep-mask is
drawn with ``torch.rand`` from the caller's ``torch.Generator``, so a run is
reproducible from its seed. The JAX package's halfword-threshold trick exists
to cut the TPU's random-bit cost and is not carried over; random streams
differ between the frameworks either way, so parity tests run at rate 0.
"""
from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, *, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: zero each element with probability ``rate`` and
    scale the kept ones by ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
