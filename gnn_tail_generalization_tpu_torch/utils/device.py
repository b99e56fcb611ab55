"""The device an entry point runs on.

Every entry point of the port takes ``device`` and defaults to the card
(``"cuda"``). A caller who wants the CPU says so (``device="cpu"``, as the
tests do); asked for the card where torch finds none, an entry point raises
instead of quietly running on the CPU. ``card`` names the card a
measurement ran on; ``device_info`` is the ``device`` field of the bench
twins' JSON lines.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Raises ``RuntimeError`` for a CUDA
    device when torch finds no CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}, but torch finds no CUDA device")
    return device


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def device_info() -> dict:
    """The first card's name, its ``card()`` line and the device count."""
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": card(),
            "count": torch.cuda.device_count()}
