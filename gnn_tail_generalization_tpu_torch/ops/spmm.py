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
the graph gets no gradient.
"""
from __future__ import annotations

import torch

from ..graph.core import Graph
from . import spmm_kernels

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
