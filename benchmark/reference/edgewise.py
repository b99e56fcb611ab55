"""The plain reference of Cold Brew's teacher under I2-GTL's edgewise loss
(``exp_mode=I2_GTL``, ``task=nodeC``: the reference's
``trainer_node_classification.py:418-563`` and ``utils.py:754-791``).

The teacher is ``reference/coldbrew-arxiv.py``'s, loaded beside this file;
its logits are the common embedding h. Its loss is no NLL but

    BCE(pos ++ neg) + se_reg * sum_l ||E_l||_F,  score(s, d) = sum(h_s * h_d)

the mean binary cross-entropy with logits of DistMult scores, the
positives labelled 1 and the negatives 0. After each step's eval forward
(no dropout) come the eval's predictions and accuracies, as the teacher's,
and the MRR of the test pairs' scores on its h: the negatives' first
``npg * p`` cut into ``p`` groups of ``npg = n // p``, a positive's rank
``1 + #(negatives of its group above it)``. The train forward's MRR is
kept likewise. Which of two scores within rounding of each other is the
larger is not defined by the model, so each MRR comes with the range that
the ranks give when a negative whose score lies within ``TIE_TOL`` x
(|h_s| |h_d| + |h_s'| |h_d'|) of its positive's ranks on either side.

The pairs replay the port's stream: a ``torch.Generator`` on the device
seeded ``seed + 5`` draws each step's train pairs, then, after the step, its
test pairs. A draw: ``p`` positives uniform with replacement over the
graph's edges (``plain.node_graph``'s order) whose ends are both train
(train) or both not (test); ``n`` negatives, uniform sources, then
destinations; three rounds that draw ``n`` sources and destinations anew
and put them where the pair is invalid: an edge or a self loop by the
sampler's int32 hash, or outside the split (train: not both ends train;
test: both train); then one more draw from the split (train: both ends
from the train nodes; test: a uniform source and a non-train destination)
for the pairs still invalid.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from harness import spec
from reference import plain

REDRAWS = 3
#: score gaps this close, over the sum of the two pairs' norm products, are
#: ties to rounding: a sound run's pair scores lie within 3e-5 of |h_s| |h_d|
#: of the reference's, the TF32 control's 2e-4 to 6e-3 (max a forward)
TIE_TOL = 1e-4


def draw_pairs(gen: torch.Generator, edges, keys: torch.Tensor, train_mask: torch.Tensor,
               p: int, n: int, mode: str):
    """(pos_src, pos_dst, neg_src, neg_dst) of one draw (module docstring)."""
    link = spec.load_module("reference", "i2gtl-citation2-sage")
    dev = train_mask.device
    nodes = train_mask.numel()

    def randint(high, size):
        return torch.randint(0, high, (size,), generator=gen, device=dev)

    def invalid(s, d):
        both = train_mask[s] & train_mask[d]
        return link.is_member(keys, s, d) | (~both if mode == "train" else both)

    pick = randint(edges[0].numel(), p)
    s, d = randint(nodes, n), randint(nodes, n)
    for _ in range(REDRAWS):
        s2, d2 = randint(nodes, n), randint(nodes, n)
        bad = invalid(s, d)
        s, d = torch.where(bad, s2, s), torch.where(bad, d2, d)
    train_idx, test_idx = train_mask.nonzero()[:, 0], (~train_mask).nonzero()[:, 0]
    if mode == "train":
        s2 = train_idx[randint(train_idx.numel(), n)]
        d2 = train_idx[randint(train_idx.numel(), n)]
    else:
        s2 = randint(nodes, n)
        d2 = test_idx[randint(test_idx.numel(), n)]
    bad = invalid(s, d)
    return edges[0][pick], edges[1][pick], torch.where(bad, s2, s), torch.where(bad, d2, d)


def score(h: torch.Tensor, pairs, fault: Optional[str], mode: str):
    """(mean BCE, (MRR, its lowest, its highest)) of the pairs' DistMult
    scores on ``h``. ``fault``: ``"half"`` scores the first half of the
    positives and of the negatives alone; ``"score_alter"`` lowers every
    other test positive's score by 1."""
    if fault == "half":
        pairs = [t[: t.numel() // 2] for t in pairs]
    ps, pd, ns, nd = pairs
    pos = (h[ps] * h[pd]).sum(-1)
    neg = (h[ns] * h[nd]).sum(-1)
    if fault == "score_alter" and mode == "test":
        pos = pos.clone()
        pos[::2] -= 1.0
    bce = (F.softplus(-pos).sum() + F.softplus(neg).sum()) / (pos.numel() + neg.numel())
    p = pos.numel()
    npg = neg.numel() // p
    negs = neg[: npg * p].reshape(p, npg)
    norms = h.norm(dim=1)
    tol = TIE_TOL * ((norms[ps] * norms[pd])[:, None]
                     + (norms[ns] * norms[nd])[: npg * p].reshape(p, npg))
    ranks = [1 + (negs > pos[:, None] + d).sum(1) for d in (0.0, -tol, tol)]
    return bce, tuple(float((1.0 / r.double()).mean()) for r in ranks)


def teacher_steps(graph: Dict[str, torch.Tensor], x, y, train_mask,
                  init: Dict[str, torch.Tensor], conf: Dict, seed: int, steps: int, *,
                  tf32: bool = False, fault: Optional[str] = None):
    """(losses, parameters after ``steps``, first gradient norms, each
    step's eval accuracies, each eval forward's predicted classes, each
    step's ``{"linkp_train", "linkp_test"}``: (MRR, lowest, highest)) of
    the teacher from
    ``init`` on ``graph`` (``plain.node_graph``'s, on the device).
    ``conf`` is the configuration's teacher with the cell's edgewise keys
    (``samp_size_p``, ``samp_size_n_train``, ``samp_size_n_test_times_p``).
    ``fault``: ``"half"``, ``"score_alter"`` (``score``), ``"eval_alter"``
    (the teacher reference's ``predict``)."""
    cb = spec.load_module("reference", "coldbrew-arxiv")
    link = spec.load_module("reference", "i2gtl-citation2-sage")
    mm = plain.matmul_fn(tf32)
    n = x.shape[0]
    src, dst = graph["src"], graph["dst"]
    s_out, s_in = cb.degree_scales(src, dst, n)
    both_train = train_mask[src] & train_mask[dst]
    both_test = ~train_mask[src] & ~train_mask[dst]
    split = {"train": (src[both_train], dst[both_train]),
             "test": (src[both_test], dst[both_test])}
    keys = link.edge_hashes({"src": src, "dst": dst}, n)
    p = conf["samp_size_p"]
    n_neg = {"train": conf["samp_size_n_train"], "test": p * conf["samp_size_n_test_times_p"]}
    drop_gen = torch.Generator(device=x.device).manual_seed(seed)
    pair_gen = torch.Generator(device=x.device).manual_seed(seed + 5)
    rate = conf["dropout"]
    subsets = cb.eval_subsets(graph, train_mask)
    evals: List[Dict] = []
    preds: List[torch.Tensor] = []
    mrrs: List[Dict[str, tuple]] = []

    def pairs(mode):
        return draw_pairs(pair_gen, split[mode], keys, train_mask, p, n_neg[mode], mode)

    def loss(params, step):
        logits, se_sum = cb.teacher_logits(params, x, src, dst, s_out, s_in, conf, mm,
                                           lambda t: plain.dropout(t, rate, drop_gen))
        bce, mrr = score(logits, pairs("train"), fault, "train")
        mrrs.append({"linkp_train": mrr})
        return bce + conf["se_reg"] * se_sum

    def evaluate(params):
        logits, _ = cb.teacher_logits(params, x, src, dst, s_out, s_in, conf, mm, lambda t: t)
        preds.append(cb.predict(logits, fault))
        evals.append(cb.accuracies(preds[-1], y, subsets))
        mrrs[-1]["linkp_test"] = score(logits, pairs("test"), fault, "test")[1]

    losses, after, first = plain.train_steps(init, loss, steps, conf["lr"],
                                             conf["weight_decay"], each_step=evaluate)
    return losses, after, first, evals, preds, mrrs
