"""The MLP stacks: ``getMLP`` and the residual-block MLP.

The port of ``gnn_tail_generalization_tpu/nn/mlp.py`` (the reference's
``utils.py:885-908`` getMLP and ``MLP_model/__init__.py:22-49`` BlockResMLP).

Every Dense is initialised as flax initialises ``nn.Dense`` (``dense_layer``).
Two flax defaults differ from torch's and are kept: ``nn.gelu`` is the tanh
approximation, and ``nn.LayerNorm`` uses eps 1e-6. The JAX ``MLP``'s
``activation``, ``use_bias`` and ``normfun`` options have no caller that
changes them and are not carried over: the stack is always GELU with
LayerNorm and biases.

On a 2-D graph x model mesh ``dense_layer(..., model_comm=...)`` gives a
``ColumnLinear`` where the model axis splits the output width: the JAX
package's column-parallel kernel (``parallel/distgraph.py:shard_params
:714-716``), whose input and output are whole on every model rank.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.comm import Comm, copy_to, gather_cols
from ..parallel.distgraph import model_cols
from .dropout import dropout

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978
_LN_EPS = 1e-6  # flax nn.LayerNorm's default


def dense_layer(in_feats: int, out_feats: int,
                generator: Optional[torch.Generator], *,
                bias: bool = True, model_comm: Optional[Comm] = None) -> nn.Module:
    """``nn.Linear`` initialised like flax ``nn.Dense``: lecun-normal weight,
    zero bias (``bias=False``: flax's ``use_bias=False``). With the model
    axis ``model_comm`` of a 2-D mesh that splits ``out_feats``: a
    ``ColumnLinear`` holding this model shard's rows of that weight."""
    lin = nn.Linear(in_feats, out_feats, bias=bias)
    std = (1.0 / in_feats) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    if bias:
        nn.init.zeros_(lin.bias)
    mc = model_cols(out_feats, model_comm)
    return lin if mc is None else ColumnLinear(lin, mc)


class ColumnLinear(nn.Module):
    """The column-parallel Dense of a 2-D mesh: ``weight`` holds model shard
    ``comm.shard``'s rows of ``lin.weight`` (``[out / M, in]``, the kernel's
    output columns), ``bias`` is whole (replicated, as in JAX). The input
    enters through ``copy_to`` (its gradient summed over the model axis),
    the slices of the product are all-gathered (``gather_cols``), and the
    bias is added to the whole output, so input and output are those of
    ``lin`` on every model rank."""

    def __init__(self, lin: nn.Linear, comm: Comm):
        super().__init__()
        self.comm = comm
        rows = lin.out_features // comm.world_size
        self.weight = nn.Parameter(
            lin.weight.detach()[comm.shard * rows: (comm.shard + 1) * rows].clone())
        self.bias = lin.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gather_cols(F.linear(copy_to(x, self.comm), self.weight), self.comm)
        return y if self.bias is None else y + self.bias


class MLP(nn.Module):
    """getMLP: ``neurons`` holds all n+1 widths, input to output.
    [Linear, LayerNorm, GELU, Dropout] x (n-1) + Linear (+ Dropout when
    ``last_dropout``); 0 or 1 neurons is the identity and 2 a bare Linear.
    Train mode (``self.training``) draws dropout from the forward's
    ``generator``."""

    def __init__(self, neurons: Sequence[int], *, dropout: float = 0.1,
                 last_dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ns = list(neurons)
        self.dropout = dropout
        self.last_dropout = last_dropout
        self.dense = nn.ModuleList(dense_layer(a, b, generator)
                                   for a, b in zip(ns[:-1], ns[1:]))
        self.norms = nn.ModuleList(nn.LayerNorm(w, eps=_LN_EPS)
                                   for w in ns[1:-1])

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if len(self.dense) == 0:
            return x
        if len(self.dense) == 1:
            return self.dense[0](x)

        def drop(t):
            return dropout(t, self.dropout, train=self.training,
                           generator=generator)

        for lin, norm in zip(self.dense[:-1], self.norms):
            x = drop(F.gelu(norm(lin(x)), approximate="tanh"))
        x = self.dense[-1](x)
        return drop(x) if self.last_dropout else x


class BlockResMLP(nn.Module):
    """Residual-block MLP: in_proj -> num_blocks x (x + MLP(x)) -> out_proj,
    the last block without trailing dropout. ``dim_model`` defaults to
    min(max(dims_in_out), 256) and ``dim_hidden`` to int(1.5 * dim_model) + 2;
    the projections are left out when the widths already match."""

    def __init__(self, dims_in_out: Tuple[int, int], num_blocks: int, *,
                 skip_conn_period: int = 2, dim_model: Optional[int] = None,
                 dim_hidden: Optional[int] = None, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d_in, d_out = dims_in_out
        dim_model = dim_model or min(max(dims_in_out), 256)
        dim_hidden = dim_hidden or int(dim_model * 1.5) + 2
        self.in_proj = (dense_layer(d_in, dim_model, generator)
                        if dim_model != d_in else None)
        neurons = [dim_model] + [dim_hidden] * (skip_conn_period - 1) + [dim_model]
        self.blocks = nn.ModuleList(
            MLP(neurons, dropout=dropout, last_dropout=b != num_blocks - 1,
                generator=generator)
            for b in range(num_blocks))
        self.out_proj = (dense_layer(dim_model, d_out, generator)
                         if dim_model != d_out else None)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.in_proj is not None:
            x = self.in_proj(x)
        for block in self.blocks:
            x = x + block(x, generator=generator)
        if self.out_proj is not None:
            x = self.out_proj(x)
        return x
