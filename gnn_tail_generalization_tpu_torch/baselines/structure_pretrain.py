"""Structural pretraining: link reconstruction + centrality ranking.

The port of ``gnn_tail_generalization_tpu/baselines/structure_pretrain.py``
(the reference's ``Link_prediction_baseline/models/structure_pretrain.py:
152-332``, Struct_Feat_Pretrain):
- a GIN stack returning per-layer embeddings, combined by a learnable
  softmax(psi) layer mixture scaled by alpha, one mixture per loss head;
- the link head: a Neural-Tensor-Network decoder over the masked graph's
  embeddings, BCE on 0/1 edge labels;
- the centrality head: one scalar Dense scorer per centrality, pairwise
  ranking pred = s[u] - s[v], pos-weighted BCE against the comparison
  labels. Centralities: in-degree and PageRank (host).

The JAX package has no training loop for it; neither has the port.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph.core import Graph
from ..nn.mlp import dense_layer
from .encoders import GINLayer


def xavier_uniform(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``xavier_uniform``: fans over the last two axes, times the
    product of the others (torch's counts another axis as the input)."""
    rf = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * rf))
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element BCE with logits, written as the JAX package writes it."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


class NeuralTensorLayer(nn.Module):
    """score_k = tanh(u^T W_k v + V [u; v] + b) (structure_pretrain.py:
    152-162); ``w`` [K, d, d], ``v`` [2d, K] and ``b`` [K] keep flax's
    names and layouts."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(xavier_uniform((out_dim, in_dim, in_dim), generator))
        self.v = nn.Parameter(xavier_uniform((2 * in_dim, out_dim), generator))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        bilinear = torch.einsum("bd,kde,be->bk", u, self.w, v)
        linear = torch.cat([u, v], dim=-1) @ self.v
        return torch.tanh(bilinear + linear + self.b)


class NTNDecoder(nn.Module):
    """NTN -> Dense(1) (structure_pretrain.py:227-240)."""

    def __init__(self, in_dim: int, tensor_dim: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ntn = NeuralTensorLayer(in_dim, tensor_dim, generator)
        self.out = dense_layer(tensor_dim, 1, generator)

    def forward(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.out(self.ntn(u, v))[..., 0]


class StructFeatPretrain(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 n_centralities: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.feature_mapping = dense_layer(in_dim, hidden_dim, generator)
        self.layers = nn.ModuleList(GINLayer(hidden_dim, hidden_dim, generator=generator)
                                    for _ in range(num_layers))
        self.link_psi = nn.Parameter(torch.rand(num_layers + 2, generator=generator))
        self.link_alpha = nn.Parameter(torch.ones(1))
        self.link_decoder = NTNDecoder(hidden_dim, generator=generator)
        self.cent_psi = nn.Parameter(torch.rand(num_layers + 2, generator=generator))
        self.cent_alpha = nn.Parameter(torch.ones(1))
        self.cent_decoders = nn.ModuleList(dense_layer(hidden_dim, 1, generator)
                                           for _ in range(n_centralities))

    def per_layer(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        """[L + 2, N, D]: the input padded or cut to D, the feature mapping,
        and each GIN layer's output."""
        h = torch.tanh(self.feature_mapping(x))
        d = self.hidden_dim
        outs = [F.pad(x, (0, d - x.shape[1])) if x.shape[1] < d else x[:, :d], h]
        for layer in self.layers:
            h = layer(g, h)
            outs.append(h)
        return torch.stack(outs)

    @staticmethod
    def _mix(stack: torch.Tensor, psi: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        return (torch.softmax(psi, dim=0)[:, None, None] * stack).sum(dim=0) * alpha[0]

    def embed(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self._mix(self.per_layer(g, x), self.link_psi, self.link_alpha)

    def forward(self, g: Graph, masked_g: Graph, x: torch.Tensor,
                link_edges: torch.Tensor, link_labels: torch.Tensor,
                cent_pairs: torch.Tensor, cent_labels: torch.Tensor) -> torch.Tensor:
        """``link_edges`` [B, 2] with 0/1 ``link_labels``; ``cent_pairs``
        [B2, 2] node pairs with per-centrality comparison labels
        ``cent_labels`` [B2, C]."""
        link_emb = self._mix(self.per_layer(masked_g, x), self.link_psi, self.link_alpha)
        link_edges, cent_pairs = link_edges.long(), cent_pairs.long()
        logits = self.link_decoder(link_emb[link_edges[:, 0]], link_emb[link_edges[:, 1]])
        link_loss = torch.mean(_bce_with_logits(logits, link_labels.float()))

        cent_emb = self._mix(self.per_layer(g, x), self.cent_psi, self.cent_alpha)
        cent_loss = 0.0
        for i, dec in enumerate(self.cent_decoders):
            score = dec(cent_emb)[..., 0]
            pred = score[cent_pairs[:, 0]] - score[cent_pairs[:, 1]]
            lab = cent_labels[:, i].float()
            pos = torch.clamp(lab.sum(), min=1.0)
            neg = torch.clamp(lab.shape[0] - lab.sum(), min=1.0)
            w = torch.where(lab > 0, neg / pos, 1.0)
            cent_loss = cent_loss + lab.shape[0] / neg * torch.mean(
                w * _bce_with_logits(pred, lab))
        return link_loss + cent_loss


def compute_centralities(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """[N, 2]: in-degree and PageRank (host-side)."""
    import scipy.sparse as ssp

    e = np.asarray(edge_index)
    deg = np.bincount(e[1], minlength=n_node).astype(np.float64)
    a = ssp.csr_matrix((np.ones(e.shape[1]), (e[0], e[1])),
                       shape=(n_node, n_node))
    from ..linkpred.heuristics import _pagerank_power

    pr = _pagerank_power(a, np.ones(n_node), p=0.85)
    return np.stack([deg, pr], axis=1)
