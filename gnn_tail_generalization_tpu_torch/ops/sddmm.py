"""SDDMM-style edge scoring: per-edge dot products of endpoint embeddings.

The port of ``gnn_tail_generalization_tpu/ops/sddmm.py``: the DistMult score
``score_e = sum(h[src_e] * h[dst_e])`` of the edgewise teacher loss
(``train/edgewise.py``) and the per-edge-weight gradient of
``ops/spmm.py:spmm_edge_grad``. The JAX package computes these in XLA, not in
a Pallas kernel, so they are plain torch here.
"""
from __future__ import annotations

import torch


def edge_dot(h_src: torch.Tensor, h_dst: torch.Tensor) -> torch.Tensor:
    """DistMult score per edge row."""
    return (h_src * h_dst).sum(dim=-1)


def sddmm(x: torch.Tensor, senders: torch.Tensor,
          receivers: torch.Tensor) -> torch.Tensor:
    """score_e = x[senders_e] . x[receivers_e] for an edge list."""
    return edge_dot(x[senders.long()], x[receivers.long()])
