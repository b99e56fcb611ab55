"""The plain reference of the ``i2gtl-citation2-transformer`` configuration:
the I2-GTL link predictor of ``Link_prediction_model/`` with its graph
transformer encoder (``layer.py:77-83``: PyG's ``TransformerConv``, UniMP,
arXiv:2009.03509, one head, the root weight, attention dropout 0), two
layers with relu and dropout between them, a trained node embedding, the
dot-product predictor, the binary cross-entropy of the positives against
``num_neg`` uniform negatives each, gradients clipped to a global norm,
Adam.

Layer: ``h'_r = sum_e alpha_e (W_v h_src + b_v) + W_s h_r + b_s`` over the
message edges ``e`` into ``r``, ``alpha_e`` the softmax over those edges of
``(W_q h_r + b_q) . (W_k h_src + b_k) / sqrt(d)``; a node with no in-edge
gets the skip term alone. The attention runs over blocks of whole
destination rows, each block under ``torch.utils.checkpoint``, so that no
``[E, d]`` tensor outlives its block and autograd derives every gradient.
The weights' ``exp`` is taken in float64 and rounded, as the port's plain
version takes it. ``attention_probe`` runs the attention alone, forward and
backward, on given operands (the check's second part: at the model's
initial scale the weights are uniform to about 1e-5, so the training steps
cannot see them).

Faults for calibration (``fault=``): ``"half"`` scores half of each batch;
``"uniform"`` gives each in-edge of a row the weight 1 / in-degree;
``"nods"`` keeps the weights but drops the softmax's row sum from the
logits' gradient (``ds_e = alpha_e dp_e``, without ``- alpha_e D_r``).

The message graph, the hashed negatives, the loss and the train stream are
the SAGE configuration's (``i2gtl-citation2-sage.py``, loaded by name).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from harness import spec
from reference import plain

sage = spec.load_module("reference", "i2gtl-citation2-sage")
message_graph = sage.message_graph

#: edges of one block of destination rows (rows are never split)
BLOCK_EDGES = 1 << 21
#: rows of one block of the Dense layers' GEMM
DENSE_ROWS = 1 << 18


def row_blocks(dst: torch.Tensor, n: int, block_edges: int = BLOCK_EDGES):
    """[(r0, r1, e0, e1)]: blocks of whole destination rows of the
    destination-sorted edges ``dst``, each of about ``block_edges`` edges
    (one row alone where it has more)."""
    ptr = torch.zeros(n + 1, dtype=torch.long, device=dst.device)
    ptr[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)
    ptr = ptr.cpu()
    out, r0 = [], 0
    while r0 < n:
        r1 = int(torch.searchsorted(ptr, ptr[r0] + block_edges, right=True)) - 1
        r1 = min(n, max(r1, r0 + 1))
        out.append((r0, r1, int(ptr[r0]), int(ptr[r1])))
        r0 = r1
    return out


def _block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor, rows: int, fault: Optional[str] = None) -> torch.Tensor:
    """The attention output of one block's ``rows`` rows; ``dst`` local."""
    s = torch.sum(q[dst] * k[src], dim=-1) / float(q.shape[1]) ** 0.5
    m = torch.full((rows,), float("-inf"), device=q.device
                   ).scatter_reduce(0, dst, s.detach(), "amax")
    ex = torch.exp((s - m[dst]).double()).float()  # one rounding, whatever the thread split
    if fault == "uniform":
        ex = torch.ones_like(s)
    den = torch.zeros(rows, device=q.device).index_add(0, dst, ex)
    if fault == "nods":
        den = den.detach()
    return torch.zeros(rows, v.shape[1], device=v.device).index_add(
        0, dst, v[src] * (ex / den[dst])[:, None])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              g: Dict[str, torch.Tensor], fault: Optional[str] = None) -> torch.Tensor:
    """[N, d]: every node's attention-weighted sum of its in-neighbours' v."""
    n = q.shape[0]
    if "blocks" not in g:
        g["blocks"] = row_blocks(g["dst"], n)
    parts = []
    for r0, r1, e0, e1 in g["blocks"]:
        if e1 == e0:
            parts.append(v.new_zeros(r1 - r0, v.shape[1]))
            continue
        parts.append(checkpoint(_block, q[r0:r1], k, v, g["src"][e0:e1], g["dst"][e0:e1] - r0,
                                r1 - r0, fault, use_reentrant=False))
    return torch.cat(parts)


def attention_probe(g: Dict[str, torch.Tensor], q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, d_out: torch.Tensor, proj: torch.Tensor,
                    fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The attention of ``q``, ``k``, ``v`` over ``g`` and its gradients by
    them under the output gradient ``d_out``, each projected by ``proj``
    [d, c]: {"out", "dq", "dk", "dv"}, [N, c] each."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = attention(q, k, v, g, fault)
    grads = torch.autograd.grad(out, (q, k, v), d_out, allow_unused=True)  # "uniform": no dq
    grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip((q, k, v), grads)]
    return {name: (t.detach() @ proj) for name, t in zip(("out", "dq", "dk", "dv"),
                                                          (out, *grads))}


def dense4(h: torch.Tensor, p: Dict[str, torch.Tensor], i: int, mm) -> torch.Tensor:
    """[N, 4d]: layer ``i``'s query, key, value and skip Dense layers as one
    GEMM over blocks of ``DENSE_ROWS`` rows, so that the control keeps one
    rounded copy of the layer's input (not four) and rounds a block of the
    gradient at a time."""
    names = [f"encoder.layers.{i}.{m}" for m in ("query", "key", "value", "skip")]
    w = torch.cat([p[f"{m}.weight"] for m in names]).T
    b = torch.cat([p[f"{m}.bias"] for m in names])
    out = h.new_empty(h.shape[0], w.shape[1])
    for r0 in range(0, h.shape[0], DENSE_ROWS):
        out[r0:r0 + DENSE_ROWS] = mm(h[r0:r0 + DENSE_ROWS], w) + b
    return out


def encode(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor], layers: int, mm, *,
           gen: Optional[torch.Generator] = None, rate: float = 0.0,
           fault: Optional[str] = None) -> torch.Tensor:
    """Every node's embedding; with ``gen``, train mode (dropout drawn). Each
    layer's Dense layers and attention run under ``checkpoint`` too, so that
    a layer keeps only its input for the backward."""
    def layer(h, i):
        q, k, v, skip = dense4(h, p, i, mm).chunk(4, dim=1)
        return attention(q, k, v, g, fault) + skip

    h = p["node_emb"]
    for i in range(layers):
        h = checkpoint(layer, h, i, use_reentrant=False)
        if i < layers - 1:
            h = torch.relu(h)
            if gen is not None:
                h = plain.dropout(h, rate, gen)
    return h


def train_steps(g, pos: torch.Tensor, init: Dict[str, torch.Tensor], conf: Dict, seed: int,
                steps: int, *, tf32: bool = False, fault: Optional[str] = None):
    """(losses, parameters after ``steps``, first gradient norms) over the
    train positives ``pos`` [steps * batch, 2], drawn as the SAGE
    reference draws them, with a calibration fault (module docstring)."""
    mm = plain.matmul_fn(tf32)
    n, bsz, k = init["node_emb"].shape[0], conf["batch_size"], conf["num_neg"]
    gen = torch.Generator(device=pos.device).manual_seed(seed + 1)
    n_draw = steps * bsz
    perm = torch.randperm(n_draw, generator=gen, device=pos.device)
    neg_all = sage.negatives(gen, sage.edge_hashes(g, n), n, n_draw, k).reshape(steps, bsz, k, 2)
    keep = bsz // 2 if fault == "half" else bsz

    def loss(p, s):
        h = encode(p, g, conf["gnn_num_layers"], mm, gen=gen, rate=conf["dropout"],
                   fault=fault)
        pe = pos[perm[s * bsz + torch.arange(bsz, device=pos.device)]][:keep]
        ne = neg_all[s][:keep].reshape(-1, 2)
        pos_out = (h[pe[:, 0]] * h[pe[:, 1]]).sum(-1)
        neg_out = (h[ne[:, 0]] * h[ne[:, 1]]).sum(-1)
        return -sage.log_sig_eps(pos_out).mean() - sage.log_sig_eps(-neg_out).mean()

    return plain.train_steps(init, loss, steps, conf["lr"], 0.0, clip=conf["grad_clip_norm"])
