"""The device an entry point runs on.

Every entry point of the port takes ``device`` and defaults to the card
(``"cuda"``). A caller who wants the CPU says so (``device="cpu"``, as the
tests do); asked for the card where torch finds none, an entry point raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Raises ``RuntimeError`` for a CUDA
    device when torch finds no CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}, but torch finds no CUDA device")
    return device
