"""Batched latent-neighbour discovery (the Cold Brew "replacement" op).

The port of ``gnn_tail_generalization_tpu/ops/topk_attention.py``
(the reference's per-node loop, ``MLP_model/__init__.py:143-156``): one
``[B, se_dim] x [se_dim, N]`` score matmul per row chunk, the top-K of the
raw scores, a softmax over those K, and the weighted sum of the selected SE
rows, all without gradient. The JAX package computes it in plain XLA, outside
any Pallas kernel; here the score matmul, the softmax and the weighted sum are
plain torch, and the selection is a kernel.

Two points keep it equal to the JAX op:

- ``jax.lax.top_k`` picks the lowest index among exactly tied scores, and
  orders the K by score descending, then index ascending, so the weighted
  sum adds them in that order. ``top_k_lowest_index`` gives the same: on
  the card one pass of the hand-written kernel of
  ``ops/topk_kernels.py:topk_rows_f32`` over the score chunk, with no read
  back to the host; on the CPU the plain version, ``top_k_plain``.
- The scores are true f32 products: TF32 would change which neighbours are
  selected. The callers (``main``, ``chip_smoke.py``) turn TF32 off.

``dist_latent_replace`` is the op over a row-sharded table (JAX
``make_dist_latent_replace``): each rank scores the batch against its rows
and keeps its own top-K, one all-gather brings every shard's candidates to
every rank, and one all-reduce merges the weighted sums.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.comm import Comm
from ..utils import debug
from . import topk_kernels


def top_k_lowest_index(scores: torch.Tensor, k: int):
    """(values, indices) of the K largest scores per row, ordered as
    ``jax.lax.top_k`` orders them: score descending, and among exactly equal
    scores the lower index first. The kernel on a CUDA tensor (it launches
    or raises), the plain version on a CPU one."""
    if scores.device.type == "cpu":
        return topk_kernels.top_k_plain(scores, k)
    return topk_kernels.topk_rows_f32(scores, k)


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
    with debug.span("gnn.replace"):
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


@torch.no_grad()
def dist_latent_replace(g_or_comm, le_guess: torch.Tensor, se_local: torch.Tensor,
                        top_k: int, n_valid: int, rows_per_shard: int,
                        row_chunk: int = 8192) -> torch.Tensor:
    """``latent_neighbor_replace`` of the replicated batch ``le_guess`` [B,
    se_dim] against a table row-sharded over the ranks: ``se_local`` holds
    this rank's ``rows_per_shard`` rows of the ``[n_node_pad, se_dim]``
    table, and rows at global index ``>= n_valid`` (the padding) are never
    selected. ``g_or_comm``: a ``DistGraph`` or its ``Comm``. Returns the
    same [B, se_dim] f32 on every rank.

    Per rank, ``row_chunk`` batch rows at a time: the f32 scores against
    the rank's rows, padded columns at -inf, and the rank's top-K with
    global ids (``top_k_lowest_index``'s tie rule). Then, for the whole
    batch, one all-gather of the S * K candidates (values and ids, packed
    into one int32 tensor), laid out shard-major so that among equal
    scores the lower global id comes first, the exact global top-K and its
    softmax, each rank's weighted sum of the selected rows it holds, and
    one all-reduce of [B, se_dim]. The scores are those of the one-device
    op, so only a tie at a shard's local cut can pick another neighbour of
    equal score."""
    comm: Comm = getattr(g_or_comm, "comm", g_or_comm)
    if top_k > rows_per_shard:
        raise ValueError(f"top_k={top_k} exceeds the {rows_per_shard} rows of a shard")
    row0 = comm.shard * rows_per_shard
    n_real = min(max(n_valid - row0, 0), rows_per_shard)  # this rank's real rows
    se = se_local.float()
    se_t = se.T
    b, dev = le_guess.shape[0], le_guess.device
    cand = torch.empty(b, 2 * top_k, dtype=torch.int32, device=dev)
    for start in range(0, b, row_chunk):
        scores = le_guess[start:start + row_chunk].float() @ se_t
        scores[:, n_real:] = float("-inf")
        vals, idx = top_k_lowest_index(scores, top_k)
        cand[start:start + row_chunk, :top_k] = vals.view(torch.int32)
        cand[start:start + row_chunk, top_k:] = (idx + row0).int()
    every = comm.all_gather(cand)  # [S, B, 2K]
    s = every.shape[0]
    cand_vals = every[:, :, :top_k].contiguous().view(torch.float32)
    cand_ids = every[:, :, top_k:]
    cand_vals = cand_vals.permute(1, 0, 2).reshape(b, s * top_k)
    cand_ids = cand_ids.permute(1, 0, 2).reshape(b, s * top_k)
    vals, pos = top_k_lowest_index(cand_vals, top_k)
    sel = cand_ids.gather(1, pos).long()
    attn = torch.softmax(vals, dim=-1)
    local = sel - row0
    mine = (local >= 0) & (local < rows_per_shard)
    neigh = torch.where(mine[:, :, None], se[local.clamp(0, rows_per_shard - 1)],
                        torch.zeros((), device=dev))
    out = torch.einsum("bk,bkd->bd", attn, neigh)
    return comm.all_reduce_sum_(out)
