"""Batched latent-neighbour discovery (the Cold Brew "replacement" op).

The port of ``gnn_tail_generalization_tpu/ops/topk_attention.py``
(the reference's per-node loop, ``MLP_model/__init__.py:143-156``): one
``[B, se_dim] x [se_dim, N]`` score matmul per row chunk, the top-K of the
raw scores, a softmax over those K, and the weighted sum of the selected SE
rows, all without gradient. The JAX package computes it in plain XLA, outside
any Pallas kernel, so here it is plain torch.

Two points keep it equal to the JAX op:

- ``jax.lax.top_k`` picks the lowest index among exactly tied scores, and
  ``torch.topk`` promises no order on ties. Rows where the K-th score is tied
  with a score outside the selection are re-selected by a stable sort, and
  the K selected are put in the JAX order (score descending, then index
  ascending), so that the weighted sum adds them in the same order.
- The scores are true f32 products: TF32 would change which neighbours are
  selected. The callers (``main``, ``chip_smoke.py``) turn TF32 off.

``make_dist_latent_replace`` (the row-sharded table) comes with the
sharded students (ROADMAP A12b).
"""
from __future__ import annotations

from typing import Optional

import torch


def top_k_lowest_index(scores: torch.Tensor, k: int):
    """(values, indices) of the K largest scores per row, ordered as
    ``jax.lax.top_k`` orders them: score descending, and among exactly equal
    scores the lower index first."""
    vals, idx = torch.topk(scores, k, dim=1)
    # rows whose K-th value also occurs outside the selection: the set of
    # indices torch picked among the tied ones is unspecified
    tied = (scores >= vals[:, -1:]).sum(dim=1) > k
    if tied.any():
        rows = tied.nonzero()[:, 0]
        order = torch.sort(scores[rows], dim=1, descending=True, stable=True)[1]
        idx[rows] = order[:, :k]
        vals[rows] = scores[rows[:, None], idx[rows]]
    # canonical order of the K: index ascending, then a stable sort by value
    idx, perm = torch.sort(idx, dim=1)
    vals = vals.gather(1, perm)
    vals, perm = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, idx.gather(1, perm)


@torch.no_grad()
def latent_neighbor_replace(le_guess: torch.Tensor, teacher_se: torch.Tensor,
                            top_k: int, row_chunk: int = 8192,
                            score_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Virtual-neighbourhood embedding per row of ``le_guess`` [B, se_dim]:
    softmax(top-K of le_guess @ teacher_se^T) @ teacher_se[selected], [B,
    se_dim] f32.

    Rows go ``row_chunk`` at a time, so the [B, N] score matrix is never whole
    (one f32 chunk at ogbn-arxiv is 8192 x 169,343 x 4 B = 5.5 GB).
    ``score_dtype=torch.bfloat16`` rounds the scoring matmul's operands to
    bf16 and keeps the products and sums in f32, as the JAX op's
    ``preferred_element_type=f32``; selection, softmax and the weighted sum
    stay f32."""
    se = teacher_se.float()
    se_t = se.T
    if score_dtype is not None:
        se_t = se_t.to(score_dtype).float()
    out = torch.empty(le_guess.shape[0], se.shape[1], dtype=torch.float32,
                      device=le_guess.device)
    for start in range(0, le_guess.shape[0], row_chunk):
        rows = le_guess[start:start + row_chunk].float()
        if score_dtype is not None:
            rows = rows.to(score_dtype).float()
        vals, idx = top_k_lowest_index(rows @ se_t, top_k)
        attn = torch.softmax(vals, dim=-1)
        out[start:start + row_chunk] = torch.einsum("bk,bkd->bd", attn, se[idx])
    return out
