"""Edge-softmax attention over a graph's in-neighbourhoods: the single-head
graph transformer aggregation (UniMP; PyG ``TransformerConv``), as one
differentiable op.

``edge_attention(g, q, k, v)`` gives ``out_r = sum_e alpha_e v[src_e]`` over
the in-edges ``e`` of node ``r`` (row ``r`` of the forward CSR), with
``alpha_e = softmax_{e into r}(q_r . k[src_e] / sqrt(d))``; a node with no
in-edge gets 0. Its backward:
``dv = A_alpha^T dO``, ``ds_e = alpha_e (dO_r . v[src_e] - D_r) / sqrt(d)``
with ``D_r = sum_e alpha_e dO_r . v[src_e]``, ``dq = A_ds k`` and
``dk = A_ds^T q``.

The per-edge scalars (``alpha``, ``ds``) come from ``edge_attn_rows``: on a
CUDA tensor the kernels of ``csrc/edge_attention.cu`` (that file's header
says what bounds them and how the design answers it), on a CPU tensor the
plain version ``edge_attn_rows_plain``. The four weighted aggregations are
``ops/spmm.py``'s one-device SpMM with the scalars as per-call edge weights
(B1 ``spmm_csr_f32`` on the card, counted in ``spmm.calls``), on the forward
CSR or the transposed one (``Graph.with_edge_weight`` gives both orders;
the forward's ``alpha`` is kept in both for ``dv``). So no ``[E, d]`` tensor is made on the card; everything is f32.

``ops/_build.py:LAUNCHES`` counts the kernel calls and the plain
version's. The recorder (``utils/debug.py``)
sees a ``gnn.attn`` span around each forward, ``gnn.attn.backward`` around
each backward, and ``attn.calls``, one a forward.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.core import Graph, RowSchedule, build_schedule, edge_rows
from ..utils import debug
from . import _build
from . import spmm as _spmm
from .spmm_kernels import PLAIN_EDGE_CHUNK, vec_width

MODES = {"softmax": 0, "grad": 1}


def edge_attn_rows_plain(mode: str, indptr: torch.Tensor, indices: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, scale: float,
                         alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``edge_attn_rows``: each edge's dot product
    ``a[row_e] . b[src_e]``, ``PLAIN_EDGE_CHUNK`` edges at a time, then the
    segment softmax (``mode="softmax"``; the row maximum is a shift and
    takes no part in the result) or the softmax's gradient by the logit
    times ``scale`` (``"grad"``, from ``alpha``)."""
    _build.LAUNCHES["edge_attn_rows_plain"] += 1
    n_rows, n_edge = indptr.numel() - 1, indices.numel()
    rows = edge_rows(indptr, n_edge)
    p = torch.empty(n_edge, dtype=torch.float32, device=a.device)
    for s in range(0, n_edge, PLAIN_EDGE_CHUNK):
        e = slice(s, s + PLAIN_EDGE_CHUNK)
        p[e] = torch.sum(a[rows[e]] * b[indices[e].long()], dim=-1)
    if mode == "softmax":
        logits = p * scale
        seg_max = torch.full((n_rows,), float("-inf"), device=a.device
                             ).scatter_reduce(0, rows, logits, "amax")
        # in f64, then rounded: the CPU's f32 exp rounds an element by the
        # path (vector or scalar) that the thread split gives it
        expd = torch.exp((logits - seg_max[rows]).double()).float()
        denom = torch.zeros(n_rows, device=a.device).index_add(0, rows, expd)
        return expd / denom[rows]
    d_row = torch.zeros(n_rows, device=a.device).index_add(0, rows, alpha * p)
    return alpha * (p - d_row[rows]) * scale


def _launch(mode: str, indptr, indices, a, b, scale: float, alpha,
            schedule: Optional[RowSchedule]) -> torch.Tensor:
    n_rows, d = indptr.numel() - 1, a.shape[1]
    s = schedule if schedule is not None else build_schedule(indptr.cpu().numpy()).to(a.device)
    s.check(n_rows, indices.numel(), a.device)
    out = torch.empty(indices.numel(), dtype=torch.float32, device=a.device)
    partial = torch.empty(s.n_chunks, 2, dtype=torch.float32, device=a.device)
    vec = min(vec_width(d, a, (4, 2, 1)), vec_width(d, b, (4, 2, 1)))
    nv = 1 if d // vec <= 32 else 2
    _build.launch("edge_attn_rows_f32", a.device, MODES[mode], indptr.data_ptr(),
                  indices.data_ptr(), a.data_ptr(), b.data_ptr(),
                  0 if alpha is None else alpha.data_ptr(), out.data_ptr(), n_rows, d, vec, nv,
                  scale, s.hub_rows.data_ptr(), s.hub_chunk_ptr.data_ptr(), s.n_hub,
                  s.chunk_bounds.data_ptr(), s.n_chunks, s.threshold, partial.data_ptr())
    return out


def _check(indptr, indices, a, b, alpha) -> None:
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError(f"indptr and indices must be int32, got {indptr.dtype} and "
                        f"{indices.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape != b.shape or a.shape[0] != indptr.numel() - 1:
        raise ValueError(f"a and b must both be [{indptr.numel() - 1}, d], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    tensors = {"indptr": indptr, "indices": indices, "a": a, "b": b}
    if alpha is not None:
        if alpha.shape != indices.shape:
            raise ValueError(f"alpha must be [{indices.numel()}], got {tuple(alpha.shape)}")
        tensors["alpha"] = alpha
    for name, t in tensors.items():
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.is_floating_point() and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if indices.numel() >= 2**31:
        raise ValueError("sizes outside the kernel's int32 edge indexing")


def edge_attn_rows(mode: str, indptr: torch.Tensor, indices: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, scale: float, alpha: Optional[torch.Tensor] = None,
                   schedule: Optional[RowSchedule] = None) -> torch.Tensor:
    """[E] f32 over the edges of a CSR whose rows are the destinations:
    ``mode="softmax"`` the attention weights ``alpha`` of ``a = q``,
    ``b = k``; ``mode="grad"`` the logits' gradient times ``scale``, ``ds``,
    of ``a = dO``, ``b = v`` and ``alpha``. ``schedule``: the CSR's
    ``RowSchedule`` on the tensors' device (built from ``indptr`` where
    None). The CUDA kernels on a CUDA tensor, the plain version on a CPU
    one."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose one of {sorted(MODES)}")
    if (mode == "grad") != (alpha is not None):
        raise ValueError("alpha is given with mode 'grad' and only then")
    _check(indptr, indices, a, b, alpha)
    if not _build.on_cuda(a, "SpMM"):
        if schedule is not None:
            schedule.check(indptr.numel() - 1, indices.numel(), a.device)
        return edge_attn_rows_plain(mode, indptr, indices, a, b, scale, alpha)
    return _launch(mode, indptr, indices, a, b, scale, alpha, schedule)


class _EdgeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g):
        with debug.span("gnn.attn"):
            debug.count("attn.calls")
            scale = q.shape[1] ** -0.5
            alpha = edge_attn_rows("softmax", g.indptr, g.indices, q, k, scale,
                                   schedule=g.schedule)
            ga = g.with_edge_weight(alpha)  # its transposed order serves dv
            out = _spmm.spmm_impl(ga, v, "pallas")
        ctx.ga, ctx.scale = ga, scale
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        ga, need = ctx.ga, ctx.needs_input_grad
        dq = dk = dv = None
        with debug.span("gnn.attn.backward"):
            d_out = d_out.contiguous()
            if need[2]:
                dv = _spmm.spmm_impl(ga.transpose(), d_out, "pallas")
            if need[0] or need[1]:
                ds = edge_attn_rows("grad", ga.indptr, ga.indices, d_out, v, ctx.scale,
                                    alpha=ga.weight, schedule=ga.schedule)
                gd = ga.with_edge_weight(ds)
                if need[0]:
                    dq = _spmm.spmm_impl(gd, k, "pallas")
                if need[1]:
                    dk = _spmm.spmm_impl(gd.transpose(), q, "pallas")
        return dq, dk, dv, None


def edge_attention(g: Graph, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """[N, d] f32: each node's attention-weighted sum of its in-neighbours'
    ``v`` rows (module docstring), differentiable in ``q``, ``k`` and ``v``
    ([N, d] f32 each); the graph gets no gradient. Raises unless each has
    one row per node of ``g``, as the CUDA kernels read rows unchecked."""
    if not isinstance(g, Graph):
        raise TypeError(f"edge_attention takes a one-device Graph, got {type(g).__name__}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 2 or t.shape != q.shape or t.shape[0] != g.n_node:
            raise ValueError(f"{name} must be [{g.n_node}, d] as q, got {tuple(t.shape)}")
    return _EdgeAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), g)
