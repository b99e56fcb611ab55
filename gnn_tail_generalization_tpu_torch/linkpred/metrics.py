"""Link-prediction evaluators: hits@K, MRR, top-k recall.

The port of ``gnn_tail_generalization_tpu/linkpred/metrics.py`` (OGB
Evaluator semantics, the reference's ``Link_prediction_model/utils.py:43-91``,
and ``cal_recall``, ``utils.py:568-586``). Scores are tensors on any
device; hits@K and MRR are computed there and read back once as a float.
``cal_recall`` is a numpy copy of the original, on host copies of the
scores. Each read back is a ``gnn.link.metric.read`` span, counted in
``host_syncs``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import debug

READ = "gnn.link.metric.read"


def hits_at_k(pos_pred: torch.Tensor, neg_pred: torch.Tensor, k: int) -> float:
    """OGB hits@K: fraction of positives scoring above the K-th best
    negative."""
    if neg_pred.shape[0] < k:
        return 1.0
    thresh = torch.topk(neg_pred, k).values[k - 1]
    with debug.host_read(READ):
        return float((pos_pred > thresh).float().mean())


def evaluate_hits(pos_val, neg_val, pos_test, neg_test,
                  ks=(20, 50, 100)):
    return {
        f"Hits@{k}": (hits_at_k(pos_val, neg_val, k),
                      hits_at_k(pos_test, neg_test, k))
        for k in ks
    }


def mrr(pos_pred: torch.Tensor, neg_pred: torch.Tensor) -> float:
    """OGB mrr_list.mean(): per-positive rank among its own negatives,
    rank = mean(optimistic, pessimistic). neg_pred: [B, num_neg]."""
    pos = pos_pred.reshape(-1, 1)
    opt = (neg_pred > pos).sum(dim=1) + 1
    pess = (neg_pred >= pos).sum(dim=1) + 1
    rank = 0.5 * (opt + pess)
    with debug.host_read(READ):
        return float((1.0 / rank).mean())


def _group_negs(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """[n_neg]-flat negatives -> [n_pos, k] per-positive groups. Splits
    evenly when divisible (OGB layout); otherwise truncates to k =
    n_neg // n_pos groups, or — when there are fewer negatives than
    positives — ranks every positive against the SHARED pool (global-
    negatives MRR)."""
    n_pos = pos.shape[0]
    flat = neg.reshape(-1)
    n_neg = flat.shape[0]
    k = n_neg // max(n_pos, 1)
    if k >= 1:
        return flat[: n_pos * k].reshape(n_pos, k)
    return flat[None, :].expand(n_pos, n_neg)


def evaluate_mrr(pos_val, neg_val, pos_test, neg_test):
    return {"MRR": (mrr(pos_val, _group_negs(pos_val, neg_val)),
                    mrr(pos_test, _group_negs(pos_test, neg_test)))}


def _host(a) -> np.ndarray:
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    with debug.host_read(READ):
        return a.detach().cpu().numpy()


def cal_recall(pos_pred, neg_pred, topk=None) -> float:
    """utils.py:568-586 exactly:
    - topk None or 0: threshold at 0 — fraction of positives scoring > 0
    - topk > 5: absolute top-k count
    - otherwise: relative, k = topk * N_pos
    Positives with score <= 0 are dropped before the sort (force_greater_0)
    but N_pos_total keeps the full count."""
    pos = _host(pos_pred).reshape(-1)
    neg = _host(neg_pred).reshape(-1)
    n_pos = pos.shape[0]
    if topk is None or float(topk) == 0:
        return float((pos > 0).sum() / n_pos)
    k = int(topk) if float(topk) > 5 else int(float(topk) * n_pos)
    pos_f = pos[pos > 0]
    scores = np.concatenate([pos_f, neg])
    labels = np.concatenate(
        [np.ones(pos_f.shape[0]), np.zeros(neg.shape[0])]
    )
    order = np.argsort(-scores, kind="stable")
    k = min(max(k, 0), scores.shape[0])
    return float(labels[order[:k]].sum() / n_pos)


def evaluate_recall_my(pos_train, neg_train, pos_val, neg_val,
                       pos_test, neg_test, topk=None):
    return {"recall@100%": (cal_recall(pos_train, neg_train, topk),
                            cal_recall(pos_val, neg_val, topk),
                            cal_recall(pos_test, neg_test, topk))}
