"""The least time of the edge-softmax attention rows (the port's
``csrc/edge_attention.cu``), a frozen byte rule beside ``roofline.py``'s.

One call over a CSR whose ``n_rows`` rows are the destinations of ``nnz``
edges from ``n_src`` distinct sources, at width ``d`` in f32, must read the
row operand's rows (q forward, dO backward), each source row of the source
operand once (k forward, v backward), the column indices and the row
pointers, the backward also the [E] attention weights, and write its [E]
scalars; it does 2 x nnz x d operations (one dot product an edge). The
least time is the larger of the bytes over the HBM rate and the operations
over the f32 rate.
"""
from __future__ import annotations

from harness.roofline import F32_FLOPS, HBM_BYTES_PER_S


def attn_rows_bytes(n_rows: int, n_src: int, nnz: int, d: int, backward: bool) -> int:
    reads = n_rows * d * 4 + n_src * d * 4 + nnz * 4 + (n_rows + 1) * 4
    return reads + nnz * 4 * (2 if backward else 1)


def attn_rows_flops(nnz: int, d: int) -> float:
    return 2.0 * nnz * d


def attn_rows_least_s(n_rows: int, n_src: int, nnz: int, d: int, backward: bool) -> float:
    return max(attn_rows_bytes(n_rows, n_src, nnz, d, backward) / HBM_BYTES_PER_S,
               attn_rows_flops(nnz, d) / F32_FLOPS)
