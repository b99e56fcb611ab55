"""Deep Graph Infomax pretraining.

The port of ``gnn_tail_generalization_tpu/baselines/dgi.py`` (the
reference's ``Link_prediction_baseline/models/dgi.py``: GIN encoder,
corruption by a row permutation, a bilinear discriminator against the
sigmoid-mean summary, BCE on the clean and corrupted rows).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.core import Graph
from ..nn.mlp import dense_layer
from ..utils.device import resolve_device
from .encoders import GINEncoder
from .fit import fit


class DGI(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = GINEncoder(in_dim, hidden_dim, num_layers, generator)
        self.disc = dense_layer(hidden_dim, hidden_dim, generator, bias=False)  # bilinear W

    def embed(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(g, x)

    def forward(self, g: Graph, x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
        """The DGI BCE loss. ``perm``: the corruption row permutation. The
        encoder runs on the clean rows, then on the corrupted ones, so its
        batch statistics move twice, in that order."""
        pos = self.encoder(g, x)
        neg = self.encoder(g, x[perm])
        ws = self.disc(torch.sigmoid(pos.mean(dim=0)))  # [D]
        return F.softplus(-(pos @ ws)).mean() + F.softplus(neg @ ws).mean()


def train_dgi(g: Graph, x, hidden_dim: int = 64, num_layers: int = 2,
              epochs: int = 100, lr: float = 1e-3, seed: int = 0,
              patience: int = 20, log_every: int = 0, *, device="cuda",
              init_state: Optional[Mapping[str, torch.Tensor]] = None,
              perms: Optional[Sequence[torch.Tensor]] = None,
              stats: Optional[dict] = None):
    """run_airport.py-style loop (382-548): Adam, early stopping on the best
    loss; returns the frozen embeddings of the best epoch's parameters and
    batch statistics, and that state. ``init_state``: starting parameters
    and batch statistics instead of the init from ``seed``. ``perms``: each
    epoch's corruption permutation, else drawn on ``device`` from a
    generator seeded ``seed``. ``stats`` as in ``fit.fit``."""
    device = resolve_device(device)
    g = g.to(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    n = x.shape[0]
    model = DGI(x.shape[1], hidden_dim, num_layers,
                generator=torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_of(ep):
        perm = (torch.randperm(n, generator=gen, device=device) if perms is None
                else torch.as_tensor(perms[ep], device=device))
        return model(g, x, perm)

    best = fit(model, loss_of, epochs, lr, "dgi", patience=patience,
               log_every=log_every, stats=stats)
    model.load_state_dict(best)
    model.eval()
    with torch.no_grad():
        return model.embed(g, x), best
