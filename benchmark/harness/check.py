"""The numbers that decide ``correct``, and how they are taken.

A training cell compares, for its first steps, each step's loss and the
norm of each parameter's change over those steps: the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger, by the worst leaf
(``change_gap``) and by the median leaf (``median_gap``, steady where one
small leaf's rounding swings the worst). Leaves whose reference gradient is
nought to rounding (under a thousandth of the median leaf's gradient norm)
are left out of the change. A cell whose steps also evaluate compares each
eval forward's predicted classes (``eval_flips``: rows that differ) and
each step's accuracies as the rows they count (``eval_gap``). An
evaluation cell compares each positive's rank and each split's MRR
(``ranking``).
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch

#: a leaf takes part in the change when its reference gradient's norm is at
#: least this share of the median leaf's
MOVING_LEAF = 1e-3


@dataclass
class Compared:
    """One number compared with its limit: correct where ``value <= limit``."""

    name: str
    value: float
    limit: float
    where: str = ""  # what gave the value, e.g. the worst leaf
    detail: Optional[Dict[str, float]] = None  # e.g. every leaf's gap

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def max_rel_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """The largest |p - r| / |r| over the pairs."""
    return float(max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)))


def moving_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= MOVING_LEAF * med]


def leaf_gaps(prog_norms: Dict[str, float], ref_norms: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """{leaf: |p - r| / max(r, median r)} over ``leaves``."""
    med = statistics.median(ref_norms[k] for k in leaves)
    return {k: abs(prog_norms[k] - ref_norms[k]) / max(ref_norms[k], med, 1e-30)
            for k in leaves}


def change_norms(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor],
                 leaves: Iterable[str]) -> Dict[str, float]:
    """{leaf: ||after - before||} in float64."""
    return {k: float(torch.linalg.vector_norm(
        after[k].double() - before[k].to(after[k].device).double())) for k in leaves}


def training(prog, ref, init: Dict[str, torch.Tensor],
             limits: Dict[str, float]) -> List[Compared]:
    """The compared numbers of a training cell: ``prog`` (each step's loss,
    the parameters after the steps) against ``ref`` (the same and the first
    step's gradient norms), both from the parameters ``init``."""
    leaves = moving_leaves(ref[2])
    gaps = leaf_gaps(change_norms(prog[1], init, leaves), change_norms(ref[1], init, leaves),
                     leaves)
    leaf = max(gaps, key=gaps.get)
    return [Compared("loss_gap", max_rel_gap(prog[0], ref[0]), limits["loss_gap"]),
            Compared("change_gap", gaps[leaf], limits["change_gap"], leaf, gaps),
            Compared("median_gap", statistics.median(gaps.values()), limits["median_gap"])]


def eval_gap(prog: List[Dict[str, float]], ref: List[Dict[str, Tuple[float, int]]],
             limit: float) -> Compared:
    """The largest gap, in rows, between an accuracy the program reports
    (in %) and the reference's (``{name: (accuracy in %, rows)}`` a step),
    over the steps and accuracies; inf where the program lacks one."""
    gaps = {}
    for step, r in enumerate(ref):
        p = prog[step] if step < len(prog) else {}
        for name, (acc, rows) in r.items():
            got = p.get(name)
            got = got[0] if isinstance(got, tuple) else got
            gaps[f"{name}@{step}"] = (float("inf") if got is None
                                      else abs(got - acc) * rows / 100.0)
    worst = max(gaps, key=gaps.get)
    return Compared("eval_gap", gaps[worst], limit, worst)


def eval_flips(prog: List[torch.Tensor], ref: List[torch.Tensor], limit: float) -> Compared:
    """The most rows, over the eval forwards, whose predicted class differs
    between the program and the reference; inf where the program made
    another number of forwards or of rows."""
    flips = [float("inf") if p.shape != r.shape else float((p.to(r.device) != r).sum())
             for p, r in zip(prog, ref)]
    if len(prog) != len(ref) or not flips:
        flips.append(float("inf"))
    i = max(range(len(flips)), key=flips.__getitem__)
    return Compared("eval_flips", flips[i], limit, f"forward {i}")


def ranking(prog, ref, reciprocal_ranks, limits: Dict[str, float]) -> List[Compared]:
    """An evaluation's numbers, each split's ``{"mrr", "pos", "neg"}`` on
    either side (the reference's also with each positive's rank range
    ``"opt"``, ``"pess"``): ``rank_flips``, the most positives of a split
    whose rank among their own negatives by the program's scores (optimistic
    to pessimistic) leaves the reference's range; ``mrr_gap``, the largest
    gap between a split's MRR as the program reports it and the mean of
    ``reciprocal_ranks`` (the reference's) of the program's scores; inf
    where the program's scores are missing or of another shape."""
    inf = float("inf")
    flips, gaps = {}, {}
    for split, r in ref.items():
        p = prog.get(split)
        if p is None or p["neg"] is None or p["neg"].shape != r["neg"].shape:
            flips[split] = gaps[split] = inf
            continue
        pos, neg = p["pos"].to(r["neg"].device), p["neg"].to(r["neg"].device)
        opt = (neg > pos[:, None]).sum(1) + 1
        pess = (neg >= pos[:, None]).sum(1) + 1
        flips[split] = float(((opt < r["opt"]) | (pess > r["pess"])).sum())
        got = p["mrr"]
        gaps[split] = (abs(got - float(reciprocal_ranks(pos, neg).mean())) if got == got
                       else inf)
    fw, gw = max(flips, key=flips.get), max(gaps, key=gaps.get)
    return [Compared("rank_flips", flips[fw], limits["rank_flips"], fw),
            Compared("mrr_gap", gaps[gw], limits["mrr_gap"], gw)]


def report(compared: List[Compared]) -> Dict[str, Dict[str, float]]:
    return {c.name: {"value": c.value, "limit": c.limit} for c in compared}
