"""Peaks of the chip and the least time of the work a step needs.

The peaks are NVIDIA's data-sheet rates for one H100 SXM at its full 700 W
power limit. The SpMM byte rule is a frozen copy of the port's
``ops/spmm_kernels.py:spmm_bound``: every source row some edge reads, the
output in f32, the column indices, the weights and the row pointers, each
once. FLOPs count a dense GEMM ``[m, k] x [k, n]`` as 2mkn and an
aggregation as 2 x nnz x d.
"""
from __future__ import annotations

F32_FLOPS = 67e12  # f32 outside the tensor cores (TF32 is off)
HBM_BYTES_PER_S = 3.35e12


def spmm_bytes(n_rows: int, n_src: int, nnz: int, d: int, elem: int = 4) -> int:
    """Bytes one SpMM ``y = A x`` must move: the ``n_src`` source rows of x
    that some edge reads, y's ``n_rows`` rows in f32, the indices and the
    weights of ``nnz`` edges, the row pointers."""
    return n_src * d * elem + n_rows * d * 4 + nnz * (4 + elem) + (n_rows + 1) * 4


def spmm_flops(nnz: int, d: int) -> float:
    return 2.0 * nnz * d


def spmm_least_s(n_rows: int, n_src: int, nnz: int, d: int, elem: int = 4) -> float:
    """The least time of one SpMM: the larger of its bytes over the HBM
    rate and its operations over the f32 rate."""
    return max(spmm_bytes(n_rows, n_src, nnz, d, elem) / HBM_BYTES_PER_S,
               spmm_flops(nnz, d) / F32_FLOPS)


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n
