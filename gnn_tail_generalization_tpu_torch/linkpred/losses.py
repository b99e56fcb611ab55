"""Link-prediction losses (the reference's Link_prediction_model/loss.py:4-30).

The port of ``gnn_tail_generalization_tpu/linkpred/losses.py``. Every loss
takes an optional ``valid`` weight vector (one per positive edge, broadcast
over that edge's negatives). The train loop uses it to zero out wrap-filled
entries of the final partial batch, so a positive edge never contributes
gradient twice per epoch; mean-type losses renormalize by the number of
valid rows, so the gradient scale matches a true partial batch.

The log-sigmoid terms keep the stable forms: ``log(sigmoid(x) + 1e-15)`` is
``logaddexp(logsigmoid(x), log 1e-15)`` and InfoNCE's softmax is taken in
log space. The naive forms give inf once |score| reaches a few hundred.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils import debug

_LOG_EPS = math.log(1e-15)


def _plus_eps(log_p: torch.Tensor) -> torch.Tensor:
    """log(p + 1e-15) from log(p). The constant's copy to the card waits
    for the card's queue (``gnn.link.loss.read``)."""
    with debug.host_read("gnn.link.loss.read"):
        eps = log_p.new_tensor(_LOG_EPS)
    return torch.logaddexp(log_p, eps)


def _log_sig_eps(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x) + 1e-15), stably."""
    return _plus_eps(F.logsigmoid(x))


def _valid_col(valid, pos: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(pos.shape[0], 1, device=pos.device)
    return valid.reshape(-1, 1)


def auc_loss(pos_out, neg_out, num_neg, valid=None):
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos)
    return torch.sum(v * torch.square(1 - (pos - neg)))


def adaptive_auc_loss(pos_out, neg_out, num_neg, weight, valid=None):
    w = weight.reshape(-1, 1)
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos)
    return torch.sum(v * w * torch.square(1 - (pos - neg)))


def log_rank_loss(pos_out, neg_out, num_neg, valid=None):
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos)
    terms = v * _log_sig_eps(pos - neg)
    return -torch.sum(terms) / torch.clamp(torch.sum(v) * num_neg, min=1.0)


def ce_loss(pos_out, neg_out, valid=None, num_neg: int = 1):
    # log(1 - sigmoid(x) + eps) == log(sigmoid(-x) + eps)
    pos = pos_out.reshape(-1)
    if valid is None:
        pos_loss = -torch.mean(_log_sig_eps(pos))
        neg_loss = -torch.mean(_log_sig_eps(-neg_out))
        return pos_loss + neg_loss
    v = valid.reshape(-1)
    denom = torch.clamp(torch.sum(v), min=1.0)
    pos_loss = -torch.sum(v * _log_sig_eps(pos)) / denom
    vneg = v.repeat_interleave(num_neg)
    neg = neg_out.reshape(-1)
    neg_loss = (-torch.sum(vneg * _log_sig_eps(-neg))
                / torch.clamp(torch.sum(vneg), min=1.0))
    return pos_loss + neg_loss


def info_nce_loss(pos_out, neg_out, num_neg, valid=None):
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos)
    # log(softmax_pos + eps), with the softmax in log space: exp(pos)
    # overflows f32 beyond score ~88
    lse = torch.logsumexp(torch.cat([pos, neg], dim=1), dim=1, keepdim=True)
    log_sm = pos - lse
    terms = v * _plus_eps(log_sm)
    return -torch.sum(terms) / torch.clamp(torch.sum(v), min=1.0)
