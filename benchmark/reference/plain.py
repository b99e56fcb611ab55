"""Plain building blocks of the references: host graph pipelines in numpy,
aggregation by ``index_add``, Adam, dropout and the TF32 control.

Nothing here imports the port. Random draws follow the port's documented
streams (a ``torch.Generator`` seeded as its trainers say, drawn with the
same calls in the same order), so that a reference step sees the same
dropout masks, batches and negatives as the program's step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

EDGE_CHUNK = 1 << 22  # edges an ``index_add`` takes at a time


def sorted_unique(a: np.ndarray) -> np.ndarray:
    s = np.sort(a)
    keep = np.empty(s.shape[0], bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def symmetric_dedup(raw: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) of A + A^T without duplicates, sorted by (dst, src)."""
    e = np.asarray(raw, np.int64)
    keys = sorted_unique(np.concatenate([e[1] * n + e[0], e[0] * n + e[1]]))
    return keys % n, keys // n


def median_halving(arr: np.ndarray, halvings: int, top: bool) -> np.ndarray:
    """Indices kept after ``halvings`` cuts at the median: the smaller
    values (``top``) or the larger ones, ties kept."""
    idx = np.arange(arr.size)
    for _ in range(halvings):
        med = np.median(arr[idx])
        idx = np.where(arr <= med)[0] if top else np.where(arr >= med)[0]
    return idx


def node_graph(raw: np.ndarray, n: int) -> Dict[str, np.ndarray]:
    """Cold Brew's node-classification graph from raw directed edges: A +
    A^T without duplicates or self loops, then a self loop on every node;
    the head / tail / isolation split by in-degree (head: five halvings
    from the top; the lowest sixteenth, sorted by degree with numpy's
    default argsort, split into the isolation and the tail halves); then
    every edge other than a self loop that touches the isolation half
    removed. Returns src, dst, and the head, tail and iso index arrays."""
    src, dst = symmetric_dedup(raw, n)
    keep = src != dst
    loops = np.arange(n, dtype=np.int64)
    src = np.concatenate([src[keep], loops])
    dst = np.concatenate([dst[keep], loops])
    deg = np.bincount(dst, minlength=n)
    low = median_halving(deg, 4, top=True)
    low = low[np.argsort(deg[low])]
    iso, tail = low[: len(low) // 2], low[len(low) // 2:]
    head = median_halving(deg, 5, top=False)
    iso_mask = np.zeros(n, bool)
    iso_mask[iso] = True
    keep = (src == dst) | ~(iso_mask[src] | iso_mask[dst])
    return {"src": src[keep], "dst": dst[keep], "head": head, "tail": tail, "iso": iso}


def _sum_into(rows: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, n_rows: int
              ) -> torch.Tensor:
    """out[rows[e]] += x[cols[e]] over the edges, EDGE_CHUNK at a time."""
    out = x.new_zeros(n_rows, x.shape[1])
    for s in range(0, rows.numel(), EDGE_CHUNK):
        out.index_add_(0, rows[s:s + EDGE_CHUNK], x[cols[s:s + EDGE_CHUNK]])
    return out


class _Aggregate(torch.autograd.Function):
    """y[dst] += x[src]; its backward is the same sum over the reversed
    edges, so no gathered rows are kept for it."""

    @staticmethod
    def forward(ctx, x, src, dst, n_rows):
        ctx.save_for_backward(src, dst)
        ctx.n_src = x.shape[0]
        return _sum_into(dst, src, x, n_rows)

    @staticmethod
    def backward(ctx, g):
        src, dst = ctx.saved_tensors
        return _sum_into(src, dst, g.contiguous(), ctx.n_src), None, None, None


def aggregate(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor, n_rows: int,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[dst] += x[src] (times ``scale`` a row of y); differentiable in x."""
    y = _Aggregate.apply(x, src, dst, n_rows)
    return y if scale is None else y * scale[:, None]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with every GEMM operand rounded to TF32, forward and
    backward, summed in f32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return torch.matmul(g, b.T), torch.matmul(a.T, g)


def matmul_fn(tf32: bool) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``a @ b`` (2-D) in f32; the control (``tf32``) as a TF32 GEMM computes
    it, forward and backward."""
    return _TF32MatMul.apply if tf32 else torch.matmul


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn as one ``torch.rand`` of
    x's shape."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class Adam:
    """Adam (L2 weight decay added to the gradient), step by step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            if self.wd:
                g = g + self.wd * p
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(self.lr / bc1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(bc2) + self.eps))


def grad_norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}


def train_steps(params: Dict[str, torch.Tensor], loss_fn, steps: int, lr: float,
                wd: float = 0.0, clip: Optional[float] = None,
                each_step: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None
                ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, float]]:
    """``steps`` Adam steps of ``loss_fn(params, step)`` from ``params``
    (cloned): (each step's loss, the parameters after the last, the first
    step's gradient norms as the optimizer gets them). ``clip``: every
    gradient times clip / (global norm) where that norm is at least
    ``clip``. ``each_step(params)`` runs after each step, without grad."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = Adam(p, lr, wd)
    losses, first = [], None
    for s in range(steps):
        loss = loss_fn(p, s)
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
        g = {k: torch.zeros_like(p[k]) if v is None else v for k, v in g.items()}
        if clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(v) for v in g.values()]))
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            g = {k: v * scale for k, v in g.items()}
        if first is None:
            first = grad_norms(g)
        opt.step(p, g)
        losses.append(float(loss.detach()))
        if each_step is not None:
            with torch.no_grad():
                each_step(p)
    return losses, {k: v.detach() for k, v in p.items()}, first
