"""Cold Brew student models: SEMLP (two-part MLP), StudentBaseMLP, GraphMLP.

The port of ``gnn_tail_generalization_tpu/models/semlp.py`` (the reference's
``MLP_model/__init__.py``).

- SEMLP part 1 (51-99) regresses node features onto the teacher's
  concatenated per-layer embeddings (the SE table): an MLP
  [num_feats, 256 x (n-1), se_dim] for the 'nlayer' archs, the BlockResMLP
  for 'residual'.
- SEMLP part 2 (101-156) finds the top-K latent neighbours of the detached,
  ``alphas[0]``-scaled part-1 output in the SE table
  (``ops/topk_attention.py``) and classifies MLP([x, replaced, part1_out]).
  Part 2 trains only its own MLP and the two ``alphas`` (initialised to
  1e-4): the part-1 output and the replacement are detached, and the
  replacement is scaled by ``alphas[1]`` after it.
- GraphMLP (158-208): an MLP whose hidden output enters a neighbour
  contrastive loss against the r-th power of the normalised adjacency,
  cropped to the batch.

Train mode (``self.training``) draws dropout from the forward's
``generator``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..config import Config
from ..nn.mlp import MLP, BlockResMLP, dense_layer
from ..ops.topk_attention import latent_neighbor_replace


def _dim_model(cfg: Config) -> Optional[int]:
    # reads StudentMLP__dim_model, then uses StudentBaseMLP.dim_model, as the
    # JAX package does
    return None if cfg.StudentMLP__dim_model == -1 else cfg.StudentBaseMLP.dim_model


def _block_res_mlp(cfg: Config, dims_in_out, generator) -> BlockResMLP:
    return BlockResMLP(dims_in_out, cfg.StudentBaseMLP.num_blocks,
                       skip_conn_period=cfg.StudentBaseMLP.skip_conn_period,
                       dim_model=_dim_model(cfg), generator=generator)


class SEMLPPart1(nn.Module):
    """Features -> teacher SE regressor (MLP_model/__init__.py:76-99)."""

    def __init__(self, cfg: Config, se_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.SEMLP_part1_arch == "residual":
            self.net = _block_res_mlp(cfg, (cfg.num_feats, se_dim), generator)
        else:
            nlayer = int(cfg.SEMLP_part1_arch[0])
            neurons = [cfg.num_feats] + [256] * (nlayer - 1) + [se_dim]
            self.net = MLP(neurons, dropout=cfg.dropout_MLP, generator=generator)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.net(x, generator=generator)


class SEMLPPart2(nn.Module):
    """Classifier over [x, virtual neighbourhood, part1_out]
    (MLP_model/__init__.py:101-138). ``se_dim``: the width of the SE table
    (unused when ``SEMLP__downgrade_to_MLP``). ``replace_fn(le_guess,
    teacher_se, top_k)``: the latent-neighbour op, by default
    ``latent_neighbor_replace``; on a rank of a sharded run the sharded op
    over the rank's rows of the table."""

    def __init__(self, cfg: Config, se_dim: int,
                 generator: Optional[torch.Generator] = None,
                 replace_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.replace_fn = replace_fn or latent_neighbor_replace
        in_feats = cfg.num_feats
        if cfg.SEMLP__downgrade_to_MLP:
            self.register_parameter("alphas", None)
        else:
            self.alphas = nn.Parameter(torch.tensor([1e-4, 1e-4]))
            # the reference's line 113 double-indexes x when part 1's output
            # is left out; the intended input is [x, replaced]
            in_feats += se_dim * (2 if cfg.SEMLP__include_part1out else 1)
        if cfg.train_which == "StudentBaseMLP":  # run downgraded: input x
            self.net = _block_res_mlp(cfg, (cfg.num_feats, cfg.num_classes_bkup),
                                      generator)
        else:
            self.net = MLP([in_feats, 256, cfg.num_classes_bkup],
                           dropout=cfg.dropout_MLP, generator=generator)

    def forward(self, x: torch.Tensor, part1_out: Optional[torch.Tensor],
                teacher_se: Optional[torch.Tensor], *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``part1_out``: part 1's raw output for the batch; ``teacher_se``:
        the [N, se_dim] table (a rank's rows under a sharded ``replace_fn``).
        Both are ignored when downgraded to an MLP."""
        c = self.cfg
        if c.SEMLP__downgrade_to_MLP:
            part2_in = x
        else:
            p1 = part1_out.detach() * self.alphas[0]
            replaced = self.replace_fn(
                p1.detach(), teacher_se, c.SEMLP_topK_2_replace) * self.alphas[1]
            parts = [x, replaced, p1] if c.SEMLP__include_part1out else [x, replaced]
            part2_in = torch.cat(parts, dim=-1)
        return self.net(part2_in, generator=generator)


class StudentBaseMLP(nn.Module):
    """Thin BlockResMLP wrapper (MLP_model/__init__.py:3-20)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = _block_res_mlp(cfg, tuple(cfg.StudentBaseMLP.dims_in_out),
                                  generator)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.net(x, generator=generator)


def cosine_sim(x: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity (MLP_model/__init__.py:200-208). Zero-norm
    rows are guarded (the reference gives NaN on them)."""
    nrm = torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
    return (x @ x.T) / (nrm @ nrm.T)


def neighbor_contrastive_loss(z: torch.Tensor, adj_pow_crop: torch.Tensor,
                              tau: float) -> torch.Tensor:
    """GraphMLP's NContrast loss (MLP_model/__init__.py:190-198): rows whose
    numerator is 0 are left out of the mean."""
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    simz = (1.0 - eye) * torch.exp(cosine_sim(z) / tau)
    numer = (adj_pow_crop * simz).sum(dim=1)
    denom = simz.sum(dim=1)
    nz = numer != 0
    logs = torch.where(nz, torch.log(torch.where(nz, numer, 1.0) / denom), 0.0)
    return -logs.sum() / nz.sum().clamp(min=1)


class GraphMLP(nn.Module):
    """MLP_model/__init__.py:158-183. Returns (logits, z); the train loop
    computes the NContrast loss from z and the cropped adjacency power."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = 256  # as the paper reports (MLP_model/__init__.py:163-164)
        self.mlp = MLP([cfg.num_feats, hidden, hidden], dropout=0.6,
                       generator=generator)
        self.out = dense_layer(hidden, cfg.num_classes_bkup, generator)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None):
        z = self.mlp(x, generator=generator)
        return self.out(z), z
