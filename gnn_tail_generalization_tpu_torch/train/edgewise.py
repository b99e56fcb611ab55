"""Edgewise (link-prediction) auxiliary loss of the teacher (I2-GTL).

The port of ``gnn_tail_generalization_tpu/train/edgewise.py`` (the
reference's ``trainer_node_classification.py:435-563`` and
``utils.py:754-791``):
- positive pairs sampled with replacement (``samp_size_p``) from the edges
  whose endpoints both lie in the split (train: both in ``train_mask``;
  test: both outside);
- negatives: uniform non-edges constrained to the split (train: both
  endpoints in train; test: not both in train), by a fixed number of redraw
  rounds and then a constrained fallback draw;
- DistMult scores ``sum(h_src * h_dst)``, mean BCE-with-logits over
  pos ++ neg, and the MRR of each positive against its group of negatives by
  the optimistic rank ``1 + #(neg > pos)``.

The loss is split into ``draw_pairs`` (the random part, from a
``torch.Generator`` on the device) and ``score_pairs`` (a function of the
embeddings and the pairs), so fixed pairs can be scored. The random streams
differ from ``jax.random``'s by design. On a ``DistGraph`` the pair rows are
gathered across the ranks (``score_pairs_sharded``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..data.datasets import PreparedData
from ..linkpred import sampling
from ..ops.sddmm import edge_dot
from ..parallel.distgraph import DistGraph, dist_take_rows

Pairs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class EdgewisePlan:
    """Host-prepared static data for the edgewise loss (the JAX package's
    arrays)."""

    train_edges: np.ndarray  # [2, Et] both endpoints in train
    test_edges: np.ndarray  # [2, Ev] both endpoints outside train
    keys_sorted: np.ndarray  # hashed edge set for negative rejection
    train_mask: np.ndarray
    n_node: int
    samp_size_p: int
    samp_size_n_train: int
    samp_size_n_test: int


def build_edgewise_plan(cfg: Config, data: PreparedData) -> EdgewisePlan:
    e = data.edge_index
    n_node = data.graph.n_node
    # from the host train_idx: a sharded PreparedData holds one rank's rows
    tm = np.zeros(n_node, bool)
    tm[np.asarray(data.train_idx)] = True
    both_train = tm[e[0]] & tm[e[1]]
    both_test = (~tm)[e[0]] & (~tm)[e[1]]
    return EdgewisePlan(
        train_edges=e[:, both_train],
        test_edges=e[:, both_test],
        keys_sorted=sampling.edge_keys(e, n_node),
        train_mask=tm,
        n_node=n_node,
        samp_size_p=cfg.samp_size_p,
        samp_size_n_train=cfg.samp_size_n_train,
        samp_size_n_test=cfg.samp_size_p * cfg.samp_size_n_test_times_p,
    )


def edgewise_consts(plan: EdgewisePlan, device) -> Dict[str, torch.Tensor]:
    """The plan's arrays as tensors on ``device``."""
    tm = plan.train_mask
    arrays = {"train_edges": plan.train_edges, "test_edges": plan.test_edges,
              "keys_sorted": plan.keys_sorted, "train_mask": tm,
              "train_idx": np.where(tm)[0], "test_idx": np.where(~tm)[0]}
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _sample_split_negatives(generator: torch.Generator, keys_sorted, train_mask,
                            train_idx, test_idx, n_node: int, count: int,
                            mode: str, rounds: int = 3):
    """(src, dst) [count] int64: uniform non-edges constrained to the split
    (trainer:534-563): train -> both endpoints in train; test -> not both in
    train. A few uniform redraw rounds, then a constrained draw from the
    split's index sets for any survivor (an edge hit after that is
    vanishingly rare)."""
    dev = generator.device

    def randint(high):
        return torch.randint(0, high, (count,), generator=generator, device=dev)

    def invalid(src, dst):
        bad = sampling._is_member(keys_sorted, src, dst)
        both_train = train_mask[src] & train_mask[dst]
        return bad | (~both_train if mode == "train" else both_train)

    src, dst = randint(n_node), randint(n_node)
    for _ in range(rounds):
        s2, d2 = randint(n_node), randint(n_node)
        bad = invalid(src, dst)
        src, dst = torch.where(bad, s2, src), torch.where(bad, d2, dst)
    if mode == "train":
        s2 = train_idx[randint(train_idx.shape[0])]
        d2 = train_idx[randint(train_idx.shape[0])]
    else:
        # dst in the non-train set guarantees "not both train"
        s2 = randint(n_node)
        d2 = test_idx[randint(test_idx.shape[0])]
    bad = invalid(src, dst)
    return torch.where(bad, s2, src), torch.where(bad, d2, dst)


def linkp_loss_eva(pos_score: torch.Tensor, neg_score: torch.Tensor):
    """(mean BCE-with-logits over pos ++ neg, MRR) (utils.py:759-791): the
    negatives' first ``npg * p`` form ``p`` groups of ``npg``, and each
    positive ranks ``1 + #(neg > pos)`` in its group."""
    score = torch.cat([pos_score, neg_score])
    label = torch.cat([torch.ones_like(pos_score), torch.zeros_like(neg_score)])
    loss = F.binary_cross_entropy_with_logits(score, label)
    p = pos_score.shape[0]
    npg = neg_score.shape[0] // p
    negs = neg_score[: npg * p].reshape(p, npg)
    rank = 1 + (negs > pos_score[:, None]).sum(dim=1)
    mrr = (1.0 / rank.float()).mean()
    return loss, mrr


def draw_pairs(plan: EdgewisePlan, ew: Dict[str, torch.Tensor],
               generator: torch.Generator, mode: str) -> Pairs:
    """(pos_src, pos_dst, neg_src, neg_dst) of one ``mode`` ('train' or
    'test') evaluation of the loss, on the generator's device."""
    edges = ew["train_edges"] if mode == "train" else ew["test_edges"]
    if edges.shape[1] == 0:
        raise ValueError(f"no {mode} edges with both endpoints in the split "
                         "to draw positive pairs from")
    n_neg = plan.samp_size_n_train if mode == "train" else plan.samp_size_n_test
    pick = torch.randint(0, edges.shape[1], (plan.samp_size_p,),
                         generator=generator, device=generator.device)
    neg_src, neg_dst = _sample_split_negatives(
        generator, ew["keys_sorted"], ew["train_mask"], ew["train_idx"],
        ew["test_idx"], plan.n_node, n_neg, mode)
    return edges[0][pick].long(), edges[1][pick].long(), neg_src, neg_dst


def score_pairs(h: torch.Tensor, pairs: Pairs):
    """(loss, MRR) of the DistMult scores of ``pairs`` on embeddings ``h``."""
    pos_src, pos_dst, neg_src, neg_dst = pairs
    return linkp_loss_eva(edge_dot(h[pos_src], h[pos_dst]),
                          edge_dot(h[neg_src], h[neg_dst]))


def score_pairs_sharded(g: DistGraph, h: torch.Tensor, pairs: Pairs):
    """``score_pairs`` on a row-sharded ``h`` (one rank's rows of a
    ``DistGraph``): the 2(p + n) pair rows are gathered by one
    ``dist_take_rows``, so every rank scores the same pairs whole
    (``edgewise.py:171-178``)."""
    p, n = pairs[0].shape[0], pairs[2].shape[0]
    rows = dist_take_rows(g, h, torch.cat(pairs))
    return linkp_loss_eva(edge_dot(rows[:p], rows[p: 2 * p]),
                          edge_dot(rows[2 * p: 2 * p + n], rows[2 * p + n:]))


def make_edgewise_loss_fn(plan: EdgewisePlan, device,
                          dist_graph: Optional[DistGraph] = None) -> Callable:
    """f(h, generator, mode) -> (loss, MRR) on ``device``: pairs drawn by
    ``draw_pairs`` and scored on ``h``, the full (unmasked) commonEmb
    (trainer:418). With ``dist_graph`` ``h`` is a rank's rows: every rank
    draws the same pairs (generators seeded alike) and scores them through
    ``score_pairs_sharded``."""
    ew = edgewise_consts(plan, device)

    def f(h: torch.Tensor, generator: torch.Generator, mode: str):
        pairs = draw_pairs(plan, ew, generator, mode)
        if dist_graph is not None:
            return score_pairs_sharded(dist_graph, h, pairs)
        return score_pairs(h, pairs)

    return f
