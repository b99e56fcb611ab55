"""The plain reference of the ``i2gtl-citation2-sage`` configuration: the
I2-GTL link predictor of ``Link_prediction_model/`` (a trained node
embedding, a two-layer GraphSAGE encoder with mean aggregation, relu and
dropout between the layers, the dot-product predictor, the binary
cross-entropy of the positives against ``num_neg`` uniform negatives each,
gradients clipped to a global norm, Adam).

SAGE layer: ``h' = W_r h + b_r + W_n (A h / deg_in)``, A the message
edges (the train positives and their reverses, without duplicates). The
train stream is the trainer's: a ``torch.Generator`` on the device seeded
``seed + 1`` draws a slice's permutation, then its negatives (uniform
pairs, and three rounds that redraw the pairs whose hash hits the hashed
edge set), then one dropout mask a step.

The evaluation (``model.test`` under ``eval_metric=mrr``, OGB's protocol):
the eval-mode encode, each positive's dot-product score and those of its
own negatives, and the mean reciprocal rank, a rank the mean of the
optimistic and the pessimistic one. Which of two scores within rounding
of each other is larger is not defined by the model, so ``evaluate``
gives each positive's rank as a range: a negative whose score lies within
``TIE_TOL`` x |h_src| |h_dst| of its positive's may rank on either side.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reference import plain

H1, H2 = -1640531527, 97  # the sampler's int32 multiplicative hash
#: scores this close, over the product of the two rows' norms, are ties to
#: rounding: f32 encodes differ by under 2e-7 of it, TF32 ones by 3e-5 (median)
TIE_TOL = 4e-6
LOG_EPS = -34.538776394910684  # log(1e-15)


def hash32(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The int32 value, with wraparound, of src * H1 + dst * H2, as int64."""
    v = (src.long() * H1 + dst.long() * H2) & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v)


def message_graph(train_pos: torch.Tensor, n: int) -> Dict[str, torch.Tensor]:
    """src, dst (sorted by destination) and 1 / max(in-degree, 1) of the
    train positives [m, 2] and their reverses, without duplicates."""
    e = torch.cat([train_pos, train_pos.flip(1)]).long()
    keys = torch.unique(e[:, 1] * n + e[:, 0])
    src, dst = keys % n, keys // n
    inv_deg = 1.0 / torch.bincount(dst, minlength=n).float().clamp(min=1.0)
    return {"src": src, "dst": dst, "inv_deg": inv_deg}


def edge_hashes(g: Dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """Sorted hashes of the message edges and of every self loop."""
    loops = torch.arange(n, device=g["src"].device)
    return torch.unique(torch.cat([hash32(g["src"], g["dst"]), hash32(loops, loops)]))


def is_member(keys: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    c = hash32(src, dst)
    pos = torch.searchsorted(keys, c).clamp_(max=keys.numel() - 1)
    return keys[pos] == c


def negatives(gen: torch.Generator, keys: torch.Tensor, n: int, count: int, num_neg: int,
              rounds: int = 3) -> torch.Tensor:
    """[count, num_neg, 2] uniform pairs, each redrawn up to ``rounds``
    times while its hash is an edge's."""
    dev = keys.device
    src, dst = torch.randint(0, n, (2, count * num_neg), generator=gen, device=dev)
    for _ in range(rounds):
        bad = is_member(keys, src, dst)
        s2, d2 = torch.randint(0, n, (2, count * num_neg), generator=gen, device=dev)
        src, dst = torch.where(bad, s2, src), torch.where(bad, d2, dst)
    return torch.stack([src, dst], dim=-1).reshape(count, num_neg, 2)


def encode(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor], layers: int, mm, *,
           gen: Optional[torch.Generator] = None, rate: float = 0.0) -> torch.Tensor:
    """Every node's embedding; with ``gen``, train mode (dropout drawn)."""
    h = p["node_emb"]
    n = h.shape[0]
    for i in range(layers):
        agg = plain.aggregate(g["src"], g["dst"], h, n, g["inv_deg"])
        h = (mm(h, p[f"encoder.layers.{i}.root.weight"].T) + p[f"encoder.layers.{i}.root.bias"]
             + mm(agg, p[f"encoder.layers.{i}.neigh.weight"].T))
        if i < layers - 1:
            h = torch.relu(h)
            if gen is not None:
                h = plain.dropout(h, rate, gen)
    return h


def log_sig_eps(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x) + 1e-15)."""
    return torch.logaddexp(F.logsigmoid(x), x.new_tensor(LOG_EPS))


def train_steps(g, pos: torch.Tensor, init: Dict[str, torch.Tensor], conf: Dict, seed: int,
                steps: int, *, tf32: bool = False, fault: Optional[str] = None):
    """(losses, parameters after ``steps``, first gradient norms) over the
    train positives ``pos`` [steps * batch, 2]; ``fault="half"`` scores the
    first half of each batch alone."""
    mm = plain.matmul_fn(tf32)
    n, bsz, k = init["node_emb"].shape[0], conf["batch_size"], conf["num_neg"]
    gen = torch.Generator(device=pos.device).manual_seed(seed + 1)
    n_draw = steps * bsz
    perm = torch.randperm(n_draw, generator=gen, device=pos.device)
    neg_all = negatives(gen, edge_hashes(g, n), n, n_draw, k).reshape(steps, bsz, k, 2)
    keep = bsz // 2 if fault == "half" else bsz

    def loss(p, s):
        h = encode(p, g, conf["gnn_num_layers"], mm, gen=gen, rate=conf["dropout"])
        pe = pos[perm[s * bsz + torch.arange(bsz, device=pos.device)]][:keep]
        ne = neg_all[s][:keep].reshape(-1, 2)
        pos_out = (h[pe[:, 0]] * h[pe[:, 1]]).sum(-1)
        neg_out = (h[ne[:, 0]] * h[ne[:, 1]]).sum(-1)
        return -log_sig_eps(pos_out).mean() - log_sig_eps(-neg_out).mean()

    return plain.train_steps(init, loss, steps, conf["lr"], 0.0, clip=conf["grad_clip_norm"])


@torch.no_grad()
def evaluate(g: Dict[str, torch.Tensor], p: Dict[str, torch.Tensor],
             split_edge: Dict[str, Dict[str, torch.Tensor]], conf: Dict, *,
             tf32: bool = False, fault: Optional[str] = None, chunk: int = 512
             ) -> Dict[str, Dict[str, object]]:
    """{split: {"mrr", "pos", "neg", "opt", "pess"}} of the valid and test
    positives [m, 2] (``edge``) against their own negatives [m * k, 2]
    (``edge_neg``, grouped by positive), ``chunk`` positives at a time: OGB's
    MRR, the scores ([m], [m, k]), and each positive's best and worst rank
    where negatives within rounding of it (module docstring) may lie on
    either side. ``fault``: ``"half"`` takes the MRR over the first half of
    the positives alone; ``"score_alter"`` lowers every other positive's
    score by 1."""
    mm = plain.matmul_fn(tf32)
    h = encode(p, g, conf["gnn_num_layers"], mm)
    out = {}
    for split in ("valid", "test"):
        pos, neg = split_edge[split]["edge"].long(), split_edge[split]["edge_neg"].long()
        m = pos.shape[0]
        k = neg.shape[0] // m
        parts = {"pos": [], "neg": [], "opt": [], "pess": []}
        for s in range(0, m, chunk):
            ps, nd = pos[s:s + chunk], neg[s * k:(s + chunk) * k, 1].view(-1, k)
            hs = h[ps[:, 0]]
            pos_s = (hs * h[ps[:, 1]]).sum(-1, keepdim=True)
            if fault == "score_alter":
                pos_s[(torch.arange(s, s + ps.shape[0], device=pos.device) % 2) == 0] -= 1.0
            hn = h[nd]
            neg_s = (hn * hs[:, None, :]).sum(-1)
            tol = TIE_TOL * hs.norm(dim=1, keepdim=True) * hn.norm(dim=2)
            clear = (neg_s - pos_s > tol).sum(1)
            parts["opt"].append(clear + 1)
            parts["pess"].append(clear + ((neg_s - pos_s).abs() <= tol).sum(1) + 1)
            parts["pos"].append(pos_s[:, 0])
            parts["neg"].append(neg_s)
        r = {key: torch.cat(v) for key, v in parts.items()}
        rr = ogb_reciprocal_ranks(r["pos"], r["neg"])
        r["mrr"] = float((rr[: m // 2] if fault == "half" else rr).mean())
        out[split] = r
    return out


def ogb_reciprocal_ranks(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Each positive's 1 / rank in float64, OGB's rank: the mean of the
    optimistic and the pessimistic one among its own negatives."""
    above = (neg > pos[:, None]).sum(1).double()
    level = (neg == pos[:, None]).sum(1).double()
    return 1.0 / (above + 0.5 * level + 1.0)
