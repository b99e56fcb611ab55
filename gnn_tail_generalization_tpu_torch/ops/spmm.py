"""Sparse neighborhood aggregation (SpMM): ``y[dst] = sum_e w_e * x[src_e]``.

The port of ``gnn_tail_generalization_tpu/ops/spmm.py``. One differentiable
entry point, ``spmm(g, x, method)``, with the JAX package's method names:

``dense``        ``dense_adj @ x`` (small graphs, ``prepare``'s threshold).
``gather``       the plain PyTorch version (``ops/spmm_kernels.py``).
``pallas``       the f32 CUDA CSR kernel.
``pallas_bf16``  the bf16-operand, f32-accumulate CUDA CSR kernel.
``auto``         ``dense`` when ``g.dense_adj`` exists, else ``pallas``.

``pallas``/``pallas_bf16`` on a graph without plans (``Graph.has_plans``
false) fall back as the JAX package does: to the dense product where the
graph carries ``dense_adj`` (under ``pallas_bf16`` with its operands rounded
to bf16, the product computed and kept in f32), else to the f32 CSR kernel
under either name. So masked graphs and the propagation adjacencies never
round to bf16. On a CPU tensor the kernel paths run the kernels' plain
versions.

The backward is the same aggregation on the transposed CSR (dx = A^T dy);
the graph gets no gradient. ``spmm_edge_grad`` is the variant whose edge
weights train (their gradient an SDDMM), and ``spmm_normalized`` the
degree-normalized aggregation.
"""
from __future__ import annotations

import torch

from ..graph.core import Graph, edge_rows
from . import spmm_kernels
from .sddmm import edge_dot

METHODS = ("auto", "dense", "gather", "pallas", "pallas_bf16")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (RTNE) and held in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _spmm_impl(g: Graph, x: torch.Tensor, method: str) -> torch.Tensor:
    if method == "auto":
        method = "dense" if g.dense_adj is not None else "pallas"
    if method == "dense":
        if g.dense_adj is None:
            raise ValueError("spmm method 'dense' needs a graph with dense_adj")
        return torch.matmul(g.dense_adj, x)
    if method == "gather":
        return spmm_kernels.spmm_csr_plain(g.indptr, g.indices, g.weight, x)
    if method in ("pallas", "pallas_bf16"):
        bf16 = method == "pallas_bf16"
        if not g.has_plans:
            if g.dense_adj is not None:
                if bf16:
                    return torch.matmul(round_bf16(g.dense_adj), round_bf16(x))
                return torch.matmul(g.dense_adj, x)
            bf16 = False  # the JAX package's gather fallback runs in f32
        kernel = spmm_kernels.spmm_csr_bf16 if bf16 else spmm_kernels.spmm_csr_f32
        return kernel(g.indptr, g.indices, g.weight, x, schedule=g.schedule)
    raise ValueError(f"unknown spmm method {method!r}; choose one of {METHODS}")


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, method):
        ctx.g, ctx.method, ctx.x_dtype = g, method, x.dtype
        return _spmm_impl(g, x, method)

    @staticmethod
    def backward(ctx, dy):
        dx = _spmm_impl(ctx.g.transpose(), dy.contiguous(), ctx.method)
        return dx.to(ctx.x_dtype), None, None


def spmm(g: Graph, x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """y = A @ x with A[dst, src] = w_e. ``x``: [N, d] f32, or bf16 (the
    link-prediction GCN's bf16 Dense output under ``pallas_bf16``) ->
    ``y``: [N, d] f32; the gradient of ``x`` takes ``x``'s dtype.
    Raises unless ``x`` has one row per node of ``g``: the CUDA kernels read
    ``x[indices_e]`` unchecked."""
    if x.dim() != 2 or x.shape[0] != g.n_node:
        raise ValueError(f"x must be [{g.n_node}, d] for a graph of "
                         f"{g.n_node} nodes, got {tuple(x.shape)}")
    return _SpMM.apply(x.contiguous(), g, method)


class _SpMMEdgeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, method):
        gw = g.with_edge_weight(w, rebuild_dense=method == "dense")
        ctx.save_for_backward(x)
        ctx.gw, ctx.method, ctx.w_dtype = gw, method, w.dtype
        return _spmm_impl(gw, x, method)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        gw, dy = ctx.gw, dy.contiguous()
        dx = _spmm_impl(gw.transpose(), dy, ctx.method)
        # forward-CSR order: edge e of row r carries dy[r] . x[indices_e]
        rows = edge_rows(gw.indptr, gw.n_edge)
        dw = edge_dot(dy[rows], x[gw.indices.long()]).to(ctx.w_dtype)
        return dx, dw, None, None


def spmm_edge_grad(g: Graph, x: torch.Tensor, w: torch.Tensor,
                   method: str = "auto") -> torch.Tensor:
    """SpMM with differentiable edge weights ``w`` ([E] f32, forward-CSR
    order, the JAX package's dst-sorted order): ``y = A_w @ x``, with
    ``dx = A_w^T dy`` on the reweighted transposed CSR and
    ``dw_e = dy[dst_e] . x[src_e]`` (SDDMM). The reweighted graph has no
    plans, so ``pallas``/``pallas_bf16`` compute in f32 as in the JAX
    package; ``dense`` rebuilds the dense adjacency from ``w``."""
    if x.dim() != 2 or x.shape[0] != g.n_node:
        raise ValueError(f"x must be [{g.n_node}, d] for a graph of "
                         f"{g.n_node} nodes, got {tuple(x.shape)}")
    return _SpMMEdgeGrad.apply(x.contiguous(), w, g, method)


def spmm_normalized(g: Graph, x: torch.Tensor, norm: str = "both",
                    method: str = "auto") -> torch.Tensor:
    """DGL-style degree-normalized aggregation: ``D_in^-1/2 A D_out^-1/2 x``
    for 'both', degrees clamped to >= 1; 'left' / 'right' scale by 1/deg on
    one side. (The JAX package's baked ``plans_norm`` form computes the same
    function and is not carried over.)"""
    if norm not in ("both", "left", "right"):
        raise ValueError(f"unknown norm {norm!r}")
    if norm in ("left", "both"):
        d = g.deg_out.clamp(min=1.0)
        scale = d ** -0.5 if norm == "both" else 1.0 / d
        x = x * scale[:, None].to(x.dtype)
    y = spmm(g, x, method)
    if norm in ("right", "both"):
        d = g.deg_in.clamp(min=1.0)
        scale = d ** -0.5 if norm == "both" else 1.0 / d
        y = y * scale[:, None].to(y.dtype)
    return y
