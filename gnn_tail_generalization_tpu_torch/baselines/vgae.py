"""Variational Graph Auto-Encoder pretraining.

The port of ``gnn_tail_generalization_tpu/baselines/vgae.py`` (the
reference's ``Link_prediction_baseline/models/vgae.py:37-168``): two
GCN-SAGE towers for mu and log sigma over a shared base, an inner-product
decoder, pos-weighted BCE over a sampled sub-adjacency, plus KL.

The JAX module draws its reparameterisation noise inside; here the caller
passes it (``train_vgae`` draws it from a ``torch.Generator``), so a test
can feed both packages the same noise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..graph.core import Graph, edge_rows
from ..utils.device import resolve_device
from .encoders import GCNSAGELayer
from .fit import fit


class VGAE(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base = GCNSAGELayer(in_dim, hidden_dim, generator=generator)
        self.mu_layer = GCNSAGELayer(hidden_dim, latent_dim, activation=False,
                                     generator=generator)
        self.logstd_layer = GCNSAGELayer(hidden_dim, latent_dim, activation=False,
                                         generator=generator)

    def encode(self, g: Graph, x: torch.Tensor):
        h = self.base(g, x)
        return self.mu_layer(g, h), self.logstd_layer(g, h)

    def embed(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.mu_layer(g, self.base(g, x))

    def forward(self, g: Graph, x: torch.Tensor, batch_idx: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """ELBO loss over the sub-adjacency of ``batch_idx`` ([B] distinct
        node ids); ``noise``: [N, latent] standard normal."""
        mu, logstd = self.encode(g, x)
        zb = (mu + torch.exp(logstd) * noise)[batch_idx]
        logits = zb @ zb.T
        # reference semantics (vgae.py:100-110): pos_weight and norm come
        # from the SELF-LOOP-FREE sub-adjacency, the BCE label adds the
        # identity back, and the weighted BCE is scaled by
        # norm = B^2 / (2 (B^2 - pos))
        adj = sub_adjacency(g, batch_idx)
        eye = torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
        label = torch.maximum(adj, eye)  # adj_label = sub + I
        pos = (adj * (1.0 - eye)).sum()
        total = float(adj.numel())
        pos_weight = (total - pos) / torch.clamp(pos, min=1.0)
        norm = total / torch.clamp(2.0 * (total - pos), min=1.0)
        w = torch.where(label > 0, pos_weight, 1.0)
        bce = norm * torch.mean(w * (torch.clamp(logits, min=0) - logits * label
                                     + torch.log1p(torch.exp(-logits.abs()))))
        kl = -0.5 / x.shape[0] * torch.mean(
            torch.sum(1 + 2 * logstd - mu**2 - torch.exp(logstd) ** 2, dim=1))
        return bce + kl


def sub_adjacency(g: Graph, batch_idx: torch.Tensor) -> torch.Tensor:
    """Dense [B, B] 0/1 adjacency among the batch nodes, ``A[dst, src]``:
    a slice of ``dense_adj`` where the graph has one, else a scan of the
    forward CSR's edges (``_sub_adjacency``)."""
    if g.dense_adj is not None:
        return (g.dense_adj[batch_idx][:, batch_idx] > 0).float()
    b = batch_idx.shape[0]
    dev = g.indices.device
    pos_of = torch.full((g.n_node,), -1, dtype=torch.long, device=dev)
    pos_of[batch_idx] = torch.arange(b, device=dev)
    src = pos_of[g.indices.long()]
    dst = pos_of[edge_rows(g.indptr, g.n_edge)]
    ok = (src >= 0) & (dst >= 0) & (g.weight != 0)
    a = torch.zeros(b, b, device=dev)
    a[dst[ok], src[ok]] = 1.0
    return a


def train_vgae(g: Graph, x, hidden_dim: int = 64, latent_dim: int = 32,
               batch_size: int = 256, epochs: int = 100, lr: float = 1e-3,
               seed: int = 0, log_every: int = 0, *, device="cuda",
               stats: Optional[dict] = None):
    """Adam for ``epochs`` steps, each on a batch of ``min(batch_size, N)``
    distinct nodes and fresh noise, both drawn on ``device`` from a
    generator seeded ``seed``; returns the frozen mu embeddings and the
    final state. ``stats`` as in ``dgi.train_dgi``."""
    device = resolve_device(device)
    g = g.to(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    n = x.shape[0]
    bsz = min(batch_size, n)
    model = VGAE(x.shape[1], hidden_dim, latent_dim,
                 generator=torch.Generator().manual_seed(seed)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_of(ep):
        bidx = torch.randperm(n, generator=gen, device=device)[:bsz]
        noise = torch.randn(n, latent_dim, generator=gen, device=device)
        return model(g, x, bidx, noise)

    state = fit(model, loss_of, epochs, lr, "vgae", log_every=log_every, stats=stats)
    model.eval()
    with torch.no_grad():
        return model.embed(g, x), state
