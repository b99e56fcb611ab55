"""Which trick strings apply a norm layer.

Only ``norm_applies`` of ``gnn_tail_generalization_tpu/nn/norms.py`` is
ported so far; the norm layers themselves wait (ROADMAP A3, norms).
"""
from __future__ import annotations

NORM_NAMES = ("BatchNorm", "PairNorm", "NodeNorm", "MeanNorm", "GroupNorm",
              "CombNorm")


def norm_applies(type_trick: str) -> bool:
    """The reference's run_norm_if_any (``norm_tricks.py:146-150``) applies
    the norm only when the trick string is EXACTLY one of the norm names —
    combined strings like 'InitialBatchNorm' build the layers but skip them at
    forward time. Preserved: exact match applies."""
    return type_trick in NORM_NAMES
