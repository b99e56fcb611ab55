"""Inputs made from the seed: graphs, features, labels, masks, splits and
weights. Frozen here so that a change to the program cannot move them.

- ``powerlaw_edges`` draws ``data/synthetic.py:fast_powerlaw_graph``'s
  graph (uniform sources, destinations of power-law popularity under a
  random relabelling), on the card from a ``torch.Generator``;
- ``features_labels`` draws what ``synthetic_features_labels`` draws (labels
  uniform over the classes, features N(0, 0.1) with a 1 added at column
  ``label % n_feat``), but on the card from a ``torch.Generator``;
- ``holdout_split`` is ``bench_linkpred_torch.build_split``'s permutation
  cut (valid, test, then train), without its sampled non-edges, the
  permutation drawn on the card;
- ``eval_negatives`` draws each held-out positive's uniform negative
  destinations, as ``ogb_eval_pairs`` does but never the positive's own,
  on the card;
- ``weights`` fills a state_dict's leaves from one seeded draw on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % 2**63)


def powerlaw_edges(n_node: int, n_edge: int, seed: int, device,
                   exponent: float = 0.5) -> np.ndarray:
    """[2, n_edge] int64 host array of sources and destinations: uniform
    sources, and destinations whose popularity goes as u^(1/(1-exponent)),
    under a random relabelling (``fast_powerlaw_graph``'s law, drawn on
    ``device``)."""
    g = generator(seed, device, 0)
    src = torch.randint(0, n_node, (n_edge,), generator=g, device=device)
    u = torch.rand(n_edge, generator=g, device=device, dtype=torch.float64)
    dst = torch.clamp((n_node * u ** (1.0 / (1.0 - exponent))).long(), max=n_node - 1)
    perm = torch.randperm(n_node, generator=g, device=device)
    return torch.stack([src, perm[dst]]).cpu().numpy()


def features_labels(n_node: int, n_feat: int, n_class: int, seed: int,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [N, F] f32, y [N] int64) on ``device``."""
    g = generator(seed, device, 1)
    y = torch.randint(0, n_class, (n_node,), generator=g, device=device)
    x = torch.randn(n_node, n_feat, generator=g, device=device) * 0.1
    x[torch.arange(n_node, device=device), y % n_feat] += 1.0
    return x, y


def train_mask(n_node: int, fraction: float, seed: int, device) -> torch.Tensor:
    """[N] bool: each node in train with probability ``fraction``."""
    g = generator(seed, device, 2)
    return torch.rand(n_node, generator=g, device=device) < fraction


def holdout_split(edges: np.ndarray, n_valid: int, n_test: int, seed: int, device
                  ) -> Dict[str, np.ndarray]:
    """The positives [m, 2] (host arrays) of valid, test and train: a seeded
    permutation of the edges, cut in that order."""
    perm = torch.randperm(edges.shape[1], generator=generator(seed, device, 6),
                          device=device).cpu().numpy()
    e = edges.T
    return {"valid": e[perm[:n_valid]], "test": e[perm[n_valid:n_valid + n_test]],
            "train": e[perm[n_valid + n_test:]]}


def eval_negatives(pos: torch.Tensor, n_node: int, n_neg: int, seed: int, stream: int
                   ) -> torch.Tensor:
    """[m * n_neg, 2] pairs on ``pos``'s device, grouped by positive: each
    positive's source with ``n_neg`` destinations uniform over the nodes
    other than the positive's own (OGB's citation2 layout; a negative never
    repeats its positive's pair), drawn on the card."""
    g = generator(seed, pos.device, stream)
    r = torch.randint(0, n_node - 1, (pos.shape[0] * n_neg,), generator=g, device=pos.device)
    own = pos[:, 1].repeat_interleave(n_neg)
    return torch.stack([pos[:, 0].repeat_interleave(n_neg), r + (r >= own).long()], dim=1)


#: how a leaf is drawn: ("normal", std), ("zeros",), ("ones",)
Init = Tuple


def weights(inits: Dict[str, Tuple[Tuple[int, ...], Init]], seed: int, device,
            stream: int = 3) -> Dict[str, torch.Tensor]:
    """A state_dict {name: tensor of ``shape``}: every "normal" leaf is a
    slice of one N(0, 1) draw on ``device`` times its std, the others
    constant."""
    normal = [(k, shape, init[1]) for k, (shape, init) in inits.items()
              if init[0] == "normal"]
    total = sum(int(np.prod(s)) for _, s, _ in normal)
    flat = torch.randn(total, generator=generator(seed, device, stream), device=device)
    out, at = {}, 0
    for k, shape, std in normal:
        n = int(np.prod(shape))
        out[k] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for k, (shape, init) in inits.items():
        if init[0] == "zeros":
            out[k] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[k] = torch.ones(shape, device=device)
        elif init[0] != "normal":
            raise ValueError(f"unknown init {init!r} for {k}")
    return {k: out[k] for k in inits}
