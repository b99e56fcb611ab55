"""The plain reference of the ``coldbrew-arxiv`` configuration: Cold Brew's
teacher (a GCN with structural embeddings and the initial connection) and
its student's second part (SEMLP: the latent-neighbour replacement and the
classifier MLP), each trained by Adam from given weights.

The teacher (the reference's ``GNN_model/GCN.py``, ``res_tricks.py`` and
``trainer_node_classification.py``; the ``InitialBatchNorm`` trick builds
its batch norms but applies none):

    h = relu(W_in drop(x) + b_in);  x0 = h
    for each layer l: t = (D_out^-1/2 drop(h)) W_l + E_l
                      h = (1 - a) relu(D_in^-1/2 A t + b_l) + a x0
    logits = W_out drop(h) + b_out
    loss = NLL over the train rows + se_reg * sum_l ||E_l||_F

on ``reference.plain.node_graph``'s graph, D the in- and out-degrees of
its edges. Dropout follows the teacher's stream: a ``torch.Generator`` on
the device seeded with the run's seed, one ``torch.rand`` an activation in
forward order, train steps only.

The student (``MLP_model/__init__.py``): part 1 (fixed weights, train mode)
maps a batch's features to p1 = W2 drop(gelu(LN(W1 x + b1))) + b2; part 2
scales it by alpha_0, finds in the teacher's SE table the top-K rows by
dot product, weights them by the softmax of their scores, scales that by
alpha_1, and classifies [x, replaced, alpha_0 p1] with W4 drop(gelu(LN(W3
. + b3))) + b4 under cross-entropy. Its stream: a generator on the device
seeded ``seed + 2`` draws, each epoch, the train batch, part 1's and part
2's dropout, and the test batch; part 2's initial weights are flax's
lecun-normal (a normal truncated at two standard deviations) drawn in
order by a CPU generator seeded ``seed + 2``, biases 0, LayerNorm 1 and 0,
alphas 1e-4.

After each step of either model comes its eval forward, without dropout:
each row's predicted class and the accuracies that the port's records hold.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference import plain

TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2
LN_EPS = 1e-6


def degree_scales(src: torch.Tensor, dst: torch.Tensor, n: int):
    deg_out = torch.bincount(src, minlength=n).float().clamp(min=1.0)
    deg_in = torch.bincount(dst, minlength=n).float().clamp(min=1.0)
    return deg_out.pow(-0.5), deg_in.pow(-0.5)


def teacher_logits(p: Dict[str, torch.Tensor], x: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, s_out: torch.Tensor, s_in: torch.Tensor, conf: Dict,
                   mm, drop):
    """(logits of every node, sum of the SE norms) of the teacher; ``drop``
    applies dropout (train) or nothing (eval)."""
    alpha = conf["res_alpha"]
    h = torch.relu(mm(drop(x), p["backbone.input_dense.weight"].T)
                   + p["backbone.input_dense.bias"])
    x0, se_sum = h, 0.0
    for i in range(conf["num_layers"]):
        t = mm(drop(h) * s_out[:, None], p[f"backbone.convs.{i}.weight"]) + p[
            f"backbone.convs.{i}.se"]
        se_sum = se_sum + torch.linalg.vector_norm(p[f"backbone.convs.{i}.se"])
        hl = torch.relu(plain.aggregate(src, dst, t, x.shape[0], s_in)
                        + p[f"backbone.convs.{i}.bias"])
        h = (1 - alpha) * hl + alpha * x0
    logits = mm(drop(h), p["backbone.out_mlp.weight"].T) + p["backbone.out_mlp.bias"]
    return logits, se_sum


def eval_subsets(graph: Dict[str, torch.Tensor], train_mask: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The rows of each accuracy the teacher's eval reports: the train
    rows, the test rows (all others), and the head, tail and isolation
    subsets' test rows."""
    n = train_mask.numel()
    out = {"acc_train": train_mask, "acc_test": ~train_mask}
    for name in ("head", "tail", "iso"):
        m = torch.zeros(n, dtype=torch.bool, device=train_mask.device)
        m[graph[name]] = True
        out[name] = m & ~train_mask
    return {k: v.nonzero()[:, 0] for k, v in out.items()}


def predict(logits: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    """Each row's predicted class; ``fault="eval_alter"`` rolls every other
    row's logits by one class first (an answer altered where it is
    produced)."""
    if fault == "eval_alter":
        logits = logits.clone()
        logits[::2] = logits[::2].roll(1, dims=1)
    return logits.argmax(dim=1)


def accuracies(pred: torch.Tensor, y: torch.Tensor, rows: Dict[str, torch.Tensor]
               ) -> Dict[str, Tuple[float, int]]:
    """{name: (accuracy in %, rows)} of the predictions over each row set."""
    hit = pred == y
    return {k: (float(hit[r].double().mean()) * 100.0 if r.numel() else 0.0, r.numel())
            for k, r in rows.items()}


def teacher_steps(graph: Dict[str, torch.Tensor], x, y, train_mask,
                  init: Dict[str, torch.Tensor], conf: Dict, seed: int, steps: int, *,
                  tf32: bool = False, fault: Optional[str] = None):
    """(losses, parameters after ``steps``, first gradient norms, each
    step's eval accuracies, each eval forward's predicted classes) of the
    teacher from ``init`` on ``graph`` (``plain.node_graph``'s, on the
    device). After each step the eval forward (no dropout, the full graph)
    predicts every node, and gives the accuracies of ``eval_subsets``.
    ``fault="half"`` takes the NLL over the first half of the train rows
    alone; ``"eval_alter"``: see ``predict``."""
    mm = plain.matmul_fn(tf32)
    n = x.shape[0]
    src, dst = graph["src"], graph["dst"]
    s_out, s_in = degree_scales(src, dst, n)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    rate = conf["dropout"]
    rows = train_mask.nonzero()[:, 0]
    if fault == "half":
        rows = rows[: rows.numel() // 2]
    subsets = eval_subsets(graph, train_mask)
    evals: List[Dict[str, Tuple[float, int]]] = []
    preds: List[torch.Tensor] = []

    def loss(p, step):
        logits, se_sum = teacher_logits(p, x, src, dst, s_out, s_in, conf, mm,
                                        lambda t: plain.dropout(t, rate, gen))
        nll = -torch.log_softmax(logits[rows], dim=1).gather(1, y[rows, None]).mean()
        return nll + conf["se_reg"] * se_sum

    def evaluate(p):
        logits, _ = teacher_logits(p, x, src, dst, s_out, s_in, conf, mm, lambda t: t)
        preds.append(predict(logits, fault))
        evals.append(accuracies(preds[-1], y, subsets))

    losses, after, first = plain.train_steps(init, loss, steps, conf["lr"],
                                             conf["weight_decay"], each_step=evaluate)
    return losses, after, first, evals, preds


def lecun_trunc(shape, gen: torch.Generator) -> torch.Tensor:
    w = torch.empty(shape)
    std = (1.0 / shape[1]) ** 0.5 / TRUNC_STD
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    return w


def student_init(seed: int, d_in: int, hidden: int, n_class: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Part 2's initial weights (module docstring)."""
    gen = torch.Generator().manual_seed(seed + 2)
    w3 = lecun_trunc((hidden, d_in), gen)
    w4 = lecun_trunc((n_class, hidden), gen)
    p = {"alphas": torch.tensor([1e-4, 1e-4]),
         "net.dense.0.weight": w3, "net.dense.0.bias": torch.zeros(hidden),
         "net.dense.1.weight": w4, "net.dense.1.bias": torch.zeros(n_class),
         "net.norms.0.weight": torch.ones(hidden), "net.norms.0.bias": torch.zeros(hidden)}
    return {k: v.to(device) for k, v in p.items()}


def mlp2(p: Dict[str, torch.Tensor], prefix: str, x, rate: float, gen, mm, train: bool):
    h = mm(x, p[f"{prefix}dense.0.weight"].T) + p[f"{prefix}dense.0.bias"]
    h = plain.gelu_tanh(plain.layer_norm(h, p[f"{prefix}norms.0.weight"],
                                         p[f"{prefix}norms.0.bias"], LN_EPS))
    if train:
        h = plain.dropout(h, rate, gen)
    return mm(h, p[f"{prefix}dense.1.weight"].T) + p[f"{prefix}dense.1.bias"]


@torch.no_grad()
def replace(le: torch.Tensor, se: torch.Tensor, k: int, mm, chunk: int = 8192) -> torch.Tensor:
    """softmax(top-K of le @ se^T) @ se[top-K], ``chunk`` rows at a time;
    the K ordered by score, then by the lower index."""
    out = torch.empty(le.shape[0], se.shape[1], device=le.device)
    for s in range(0, le.shape[0], chunk):
        scores = mm(le[s:s + chunk], se.T)
        vals, idx = torch.topk(scores, k, dim=1)
        idx, order = torch.sort(idx, dim=1)
        vals = vals.gather(1, order)
        vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
        idx = idx.gather(1, order)
        out[s:s + chunk] = torch.einsum("bk,bkd->bd", torch.softmax(vals, dim=-1), se[idx])
    return out


def student_logits(p: Dict[str, torch.Tensor], part1: Dict[str, torch.Tensor], xb, se,
                   conf: Dict, mm, gen, train: bool):
    """Part 2's logits of the rows ``xb`` (module docstring); ``train``:
    dropout from ``gen`` in part 1 and part 2, else none."""
    rate = conf["dropout_MLP"]
    with torch.no_grad():
        p1 = mlp2(part1, "net.", xb, rate, gen, mm, train)
    p1s = p1 * p["alphas"][0]
    rep = replace(p1s.detach(), se, conf["top_k"], mm) * p["alphas"][1]
    return mlp2(p, "net.", torch.cat([xb, rep, p1s], dim=-1), rate, gen, mm, train)


def student_steps(x, y, train_idx, test_idx, subsets: Dict[str, torch.Tensor], se, part1,
                  conf: Dict, seed: int, steps: int, *, tf32: bool = False,
                  fault: Optional[str] = None):
    """(losses, parameters after ``steps``, first gradient norms, each
    step's eval accuracies, each eval forward's predicted classes, initial
    parameters) of part 2. After each step the eval forwards (no dropout)
    of the epoch's test batch and of each of ``subsets`` (head, tail, iso:
    node indices) predict their rows; the accuracies are over the test
    batch and each subset's test rows. ``fault="half"`` takes the cross-entropy over the first
    half of the batch alone; ``"eval_alter"``: see ``predict``."""
    mm = plain.matmul_fn(tf32)
    dev = x.device
    init = student_init(seed, x.shape[1] + 2 * se.shape[1], conf["hidden"],
                        conf["n_class"], dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    bsz = min(conf["batch_size"], train_idx.numel())
    is_test = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    is_test[train_idx] = False
    evals: List[Dict[str, Tuple[float, int]]] = []
    preds: List[torch.Tensor] = []

    def loss(p, step):
        bidx = train_idx[torch.randint(0, train_idx.numel(), (bsz,), generator=gen, device=dev)]
        logits = student_logits(p, part1, x[bidx], se, conf, mm, gen, True)
        keep = slice(0, bsz // 2) if fault == "half" else slice(None)
        return F.cross_entropy(logits[keep], y[bidx][keep])

    def evaluate(p):
        # the epoch's test batch, drawn after the step
        tidx = test_idx[torch.randint(0, test_idx.numel(), (bsz,), generator=gen, device=dev)]
        preds.append(predict(student_logits(p, part1, x[tidx], se, conf, mm, None, False),
                             fault))
        out = accuracies(preds[-1], y[tidx], {"acc_test": torch.arange(bsz, device=dev)})
        for name, idx in subsets.items():
            preds.append(predict(student_logits(p, part1, x[idx], se, conf, mm, None, False),
                                 fault))
            out.update(accuracies(preds[-1], y[idx], {name: is_test[idx].nonzero()[:, 0]}))
        evals.append(out)

    losses, after, first = plain.train_steps(init, loss, steps, conf["lr"],
                                             conf["weight_decay"], each_step=evaluate)
    return losses, after, first, evals, preds, init
