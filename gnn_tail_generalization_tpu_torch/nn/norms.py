"""The normalization tricks of the teacher GCN.

The port of ``gnn_tail_generalization_tpu/nn/norms.py`` (the reference's
``GNN_model/norm_tricks.py``):
- pair_norm: center columns, divide by the mean row norm;
- mean_norm: center columns;
- node_norm: per-row n|v|m|srv|pr variants (variance with ddof 0);
- GroupNorm: softmax soft-clustering + grouped batch norm + skip;
- CombNorm: GroupNorm then node_norm;
- BatchNorm: plain batch norm over the rows;
- groupnorm_presets: the per-dataset GroupNorm presets.

``BatchNorm`` is flax's ``nn.BatchNorm``, not ``torch.nn.BatchNorm1d``: its
batch variance is E[x^2] - E[x]^2 (ddof 0) in the normalization AND in the
running variance, where torch's running variance takes the unbiased one
(N / (N - 1) larger); and its ``decay`` is flax's momentum (the weight of the
old running value), so flax 0.9 is torch's momentum 0.1.

Sharded (``comm`` given, the rows split over the ranks of a ``DistGraph``):
every mean over the node axis (pair and mean norm, the batch statistics of
``BatchNorm`` and ``GroupNorm``) is a local sum, summed over the ranks by a
differentiable all-reduce and divided by the global row count, so the
statistics and the running statistics are the same on every rank. The padded
rows count: under GSPMD the JAX package's sharded run reduces over all
``n_node_pad`` rows (``train/loops.py:159-160`` sets ``N_nodes`` to it), and
the port matches that sharded function, not the unpadded one-device run.
``node_norm`` is per row and needs nothing.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..parallel.comm import Comm
from .mlp import dense_layer

NORM_NAMES = ("BatchNorm", "PairNorm", "NodeNorm", "MeanNorm", "GroupNorm",
              "CombNorm")
_EPS = 1e-5


def row_means(comm: Optional[Comm], *ts: torch.Tensor) -> List[torch.Tensor]:
    """The mean over the rows (dim 0) of each of ``ts``; with ``comm``,
    over the rows of every rank (one all-reduce for all of them)."""
    if comm is None:
        return [t.mean(dim=0) for t in ts]
    sums = comm.all_reduce_sum(torch.stack([t.sum(dim=0) for t in ts]))
    return list(sums / (ts[0].shape[0] * comm.world_size))


def pair_norm(x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
    (mean,) = row_means(comm, x)
    x = x - mean
    (sq,) = row_means(comm, (x**2).sum(dim=1))
    return x / torch.sqrt(1e-6 + sq)


def mean_norm(x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
    return x - row_means(comm, x)[0]


def node_norm(x: torch.Tensor, node_norm_type: str = "n") -> torch.Tensor:
    """Per-row norms (norm_tricks.py:53-84): n centres and scales by the
    row std, v scales, m centres, srv divides by the std's square root, and
    pr by its power_root-th root with the reference's power_root of 2."""
    if node_norm_type == "m":
        return x - x.mean(dim=1, keepdim=True)
    if node_norm_type not in ("n", "v", "srv", "pr"):
        raise ValueError(node_norm_type)
    std = torch.sqrt(x.var(dim=1, keepdim=True, correction=0) + _EPS)
    if node_norm_type == "n":
        return (x - x.mean(dim=1, keepdim=True)) / std
    if node_norm_type == "v":
        return x / std
    return x / torch.sqrt(std)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the rows of ``[N, dim]``: scale and bias
    (``weight``, ``bias``), running statistics in the buffers
    ``running_mean`` (init 0) and ``running_var`` (init 1), eps 1e-5
    (flax's default, and the reference's). Train mode
    normalizes by the batch statistics and moves the running ones,
    ``r <- decay * r + (1 - decay) * batch``; eval mode uses the running
    ones."""

    def __init__(self, dim: int, decay: float):
        super().__init__()
        self.decay = decay
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        if self.training:
            mean, sq = row_means(comm, x, x * x)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                for r, batch in ((self.running_mean, mean), (self.running_var, var)):
                    r.mul_(self.decay).add_(batch, alpha=1.0 - self.decay)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + _EPS) * self.weight) + self.bias


class GroupNorm(nn.Module):
    """Differentiable group norm: with one group a batch norm; else
    softmax(Linear(x)) soft-clusters the rows, the [N, G * dim] block of
    scaled copies is batch-normed, the groups are summed back, and the
    result is added with ``skip_weight`` (flax momentum 0.7)."""

    def __init__(self, dim: int, num_groups: int, skip_weight: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.num_groups, self.skip_weight = dim, num_groups, skip_weight
        self.bn = BatchNorm(dim * num_groups, decay=0.7)
        self.score = (dense_layer(dim, num_groups, generator)
                      if num_groups > 1 else None)

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        if self.score is None:
            x_temp = self.bn(x, comm)
        else:
            score = torch.softmax(self.score(x), dim=1)  # [N, G]
            x_temp = (score[:, :, None] * x[:, None, :]).reshape(
                x.shape[0], self.num_groups * self.dim)
            x_temp = self.bn(x_temp, comm).reshape(
                x.shape[0], self.num_groups, self.dim).sum(dim=1)
        return x + x_temp * self.skip_weight


def groupnorm_presets(dataset: str, type_model: str, num_layers: int):
    """(skip_weight, num_groups) — reset_weight_GroupNorm,
    norm_tricks.py:153-206."""
    gcn_or_gat = type_model in ("GAT", "GCN")
    if dataset in ("Citeseer", "ogbn-arxiv") or "CV" in dataset:
        skip = ((0.001 if num_layers < 6 else 0.005) if gcn_or_gat
                else (0.0005 if num_layers < 60 else 0.002))
    elif dataset == "Pubmed":
        if type_model == "GCN":
            skip = 0.001 if num_layers < 6 else 0.01
        elif type_model == "GAT":
            skip = 0.005 if num_layers < 6 else 0.01
        else:
            skip = 0.05
    elif dataset == "Cora":
        if type_model == "GCN":
            skip = 0.001 if num_layers < 6 else 0.03
        elif type_model == "GAT":
            skip = 0.001 if num_layers < 6 else 0.01
        else:
            skip = 0.01 if num_layers < 60 else 0.005
    elif dataset == "CoauthorCS":
        if gcn_or_gat:
            skip = 0.001 if num_layers < 6 else 0.03
        else:
            skip = 0.001 if num_layers < 10 else 0.5
    elif dataset in ("CoauthorPhysics", "AmazonComputers",
                     "AmazonPhoto", "TEXAS", "WISCONSIN", "CORNELL"):
        skip = 0.005
    else:
        raise NotImplementedError(dataset)
    num_groups = 5 if dataset == "Pubmed" else 10
    return skip, num_groups


class NormLayer(nn.Module):
    """One entry of layers_norm, dispatched on the norm kind the way
    appendNormLayer/run_norm_if_any do (norm_tricks.py:130-150). ``dim`` is
    the width of the conv output it follows. Batch norm takes flax momentum
    0.9."""

    def __init__(self, kind: str, dim: int, node_norm_type: str = "n",
                 skip_weight: Optional[float] = None,
                 num_groups: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind, self.node_norm_type = kind, node_norm_type
        self.bn = BatchNorm(dim, decay=0.9) if kind == "BatchNorm" else None
        self.group = (GroupNorm(dim, num_groups, skip_weight, generator)
                      if kind in ("GroupNorm", "CombNorm") else None)

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        k = self.kind
        if k == "BatchNorm":
            return self.bn(x, comm)
        if k == "PairNorm":
            return pair_norm(x, comm)
        if k == "NodeNorm":
            return node_norm(x, self.node_norm_type)
        if k == "MeanNorm":
            return mean_norm(x, comm)
        if k == "GroupNorm":
            return self.group(x, comm)
        if k == "CombNorm":
            return node_norm(self.group(x, comm), self.node_norm_type)
        return x


def norm_kind_of(type_trick: str) -> str:
    """Which norm layer a trick string selects (appendNormLayer order,
    norm_tricks.py:130-143; substring match like AcontainsB)."""
    for k in NORM_NAMES:
        if k in type_trick:
            return k
    return "None"


def norm_applies(type_trick: str) -> bool:
    """The reference's run_norm_if_any (``norm_tricks.py:146-150``) applies
    the norm only when the trick string is EXACTLY one of the norm names —
    combined strings like 'InitialBatchNorm' build the layers but skip them at
    forward time. Preserved: exact match applies."""
    return type_trick in NORM_NAMES
