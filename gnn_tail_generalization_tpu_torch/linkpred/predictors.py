"""Edge-score predictors: DOT / BIL / MLP / MLPDOT / MLPBIL / MLPCAT.

The port of ``gnn_tail_generalization_tpu/linkpred/predictors.py`` (the
reference's ``Link_prediction_model/layer.py:85-203``). All operate on
gathered endpoint embeddings [B, d] -> scores [B]. Every Dense is built by
``nn/mlp.py:dense_layer`` (flax's init) and held in ``dense``, numbered as
flax numbers its ``Dense_i``. flax infers input widths; here each predictor
takes ``in_channels``, the encoder's output width. Train-mode dropout draws
from the forward's ``generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.dropout import dropout as _dropout
from ..nn.mlp import dense_layer
from ..ops import pair_score


class DotPredictor(nn.Module):
    """sum(x_i * x_j). Given an int64 [m, 2] tensor of pairs as ``x_j``,
    ``x_i`` is the encoded table and the scores are those of its rows
    (source, destination) in one call (``ops/pair_score.py:pair_dot``: the
    kernel on the card), so a forward hook sees a whole split's scores.
    ``takes_pairs`` says when a caller may pass the pairs."""

    def forward(self, x_i, x_j, *, generator=None):
        if x_j.dtype == torch.int64:
            return pair_score.pair_dot(x_i, x_j)
        return torch.sum(x_i * x_j, dim=-1)


def takes_pairs(predictor: nn.Module, h: torch.Tensor) -> bool:
    """Whether ``predictor(h, pairs)`` scores int64 pairs [m, 2] of the whole
    table ``h`` in one forward: a ``DotPredictor`` (no subclass, no other
    predictor) over a float32 table, the one the kernel takes."""
    return type(predictor) is DotPredictor and h.dtype == torch.float32


class BilinearPredictor(nn.Module):
    """sum(W x_i * x_j) (layer.py:193-203)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList(
            [dense_layer(in_channels, hidden_channels, generator, bias=False)])

    def forward(self, x_i, x_j, *, generator=None):
        return torch.sum(self.dense[0](x_i) * x_j, dim=-1)


class _Tower(nn.Module):
    """The predictors with a Dense stack: ``widths`` holds every Dense's
    (in, out); ``bias_last=False`` leaves the last one without bias."""

    def __init__(self, widths, dropout: float, generator, *,
                 bias_last: bool = True):
        super().__init__()
        self.dropout = dropout
        n = len(widths)
        self.dense = nn.ModuleList(
            dense_layer(a, b, generator, bias=bias_last or i < n - 1)
            for i, (a, b) in enumerate(widths))

    def _drop(self, x, generator):
        return _dropout(x, self.dropout, train=self.training,
                        generator=generator)


class MLPPredictor(_Tower):
    """Hadamard -> MLP -> scalar (layer.py:85-106)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        widths = [in_channels] + [hidden_channels] * (num_layers - 1) + [1]
        super().__init__(list(zip(widths[:-1], widths[1:])), dropout, generator)

    def forward(self, x_i, x_j, *, generator=None):
        x = x_i * x_j
        for i, lin in enumerate(self.dense):
            x = lin(x)
            if i < len(self.dense) - 1:
                x = self._drop(F.relu(x), generator)
        return x[..., 0]


class MLPCatPredictor(_Tower):
    """Symmetrized concat MLP (layer.py:108-134)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        widths = [2 * in_channels] + [hidden_channels] * (num_layers - 1) + [1]
        super().__init__(list(zip(widths[:-1], widths[1:])), dropout, generator)

    def forward(self, x_i, x_j, *, generator=None):
        x1 = torch.cat([x_i, x_j], dim=-1)
        x2 = torch.cat([x_j, x_i], dim=-1)
        for i, lin in enumerate(self.dense):
            x1, x2 = lin(x1), lin(x2)
            if i < len(self.dense) - 1:
                x1 = self._drop(F.relu(x1), generator)
                x2 = self._drop(F.relu(x2), generator)
        return ((x1 + x2) / 2)[..., 0]


class MLPDotPredictor(_Tower):
    """Shared-tower MLP (relu+dropout after EVERY layer) then dot
    (layer.py:136-156)."""

    bilinear = False

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        widths = [in_channels] + [hidden_channels] * (num_layers + self.bilinear)
        super().__init__(list(zip(widths[:-1], widths[1:])), dropout, generator,
                         bias_last=not self.bilinear)
        self.num_layers = num_layers

    def forward(self, x_i, x_j, *, generator=None):
        for lin in self.dense[:self.num_layers]:
            x_i = self._drop(F.relu(lin(x_i)), generator)
            x_j = self._drop(F.relu(lin(x_j)), generator)
        if self.bilinear:
            x_i = self.dense[-1](x_i)
        return torch.sum(x_i * x_j, dim=-1)


class MLPBilPredictor(MLPDotPredictor):
    """Shared-tower MLP then bilinear dot (layer.py:158-180); the bilinear
    Dense, without bias, is the last of ``dense``."""

    bilinear = True


def create_predictor(name: str, in_channels: int, hidden_channels: int,
                     num_layers: int, dropout: float,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """Factory (model.py:306-319); ``in_channels`` is the encoder's output
    width."""
    name = name.upper()
    if name == "DOT":
        return DotPredictor()
    if name == "BIL":
        return BilinearPredictor(in_channels, hidden_channels, generator)
    kinds = {"MLP": MLPPredictor, "MLPCAT": MLPCatPredictor,
             "MLPDOT": MLPDotPredictor, "MLPBIL": MLPBilPredictor}
    if name not in kinds:
        raise ValueError(name)
    return kinds[name](in_channels, hidden_channels, num_layers, dropout,
                       generator)
