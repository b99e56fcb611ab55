"""CSR SpMM kernels and their plain PyTorch version.

``y[r, :] = sum_{e in indptr[r]..indptr[r+1]} w_e * x[indices_e, :]``, with
``indptr`` int32 ``[n_rows + 1]``, ``indices`` int32 ``[E]`` (source rows of
``x``, each ``< x.shape[0]``), ``w`` ``[E]`` and ``x`` ``[n_src, d]``; ``y`` is
``[n_rows, d]`` float32.

- ``spmm_csr_f32`` replaces the f32 Pallas kernel
  ``gnn_tail_generalization_tpu/ops/spmm_pallas.py:_segment_matmul_kernel``.
- ``spmm_csr_bf16`` replaces the bf16 one, ``_segment_matmul_packed_kernel``:
  ``x`` and ``w`` are rounded to bf16 (RTNE), products and sums are f32, and
  ``y`` is f32.

Both kernels live in ``csrc/spmm_csr.cu``; that file's header says what bounds
them on the card and how the design answers it. A CUDA call runs up to three
kernels (light rows; hub-row chunks and their reduction) on a
``graph.core.RowSchedule``, which ``ops/spmm.py`` passes from the graph; a
direct call without one builds it from ``indptr`` (a host copy). A schedule
passed with a CSR of other row or edge counts than it was built for raises
``ValueError`` on either route. On a CPU tensor each wrapper runs the plain
version (``spmm_csr_plain``); on a CUDA tensor it launches its kernels or
raises. ``ops/_build.py:LAUNCHES`` counts one per wrapper call that
launched, and calls of the plain version, so a run can show which one it
went through.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.core import RowSchedule, build_schedule, edge_rows
from . import _build

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet), at 700 W
F32_FLOPS = 67e12  # f32 outside the tensor cores, the same sheet


def spmm_bound(g, d: int, bf16: bool) -> tuple:
    """(ms, what bounds it): the least time an H100 could take for
    y = A @ x on ``g``'s CSR at width d. Bytes: every x row some edge reads
    (bf16 where the kernel reads bf16), y in f32, indices, weights and
    indptr, each once, over the HBM rate; operations: 2 flops an edge and
    column over the f32 rate. The larger of the two."""
    elem = 2 if bf16 else 4
    n_src = int(torch.unique(g.indices).numel())
    nbytes = (n_src * d * elem + g.n_node * d * 4 + g.n_edge * (4 + elem)
              + (g.n_node + 1) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * g.n_edge * d / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: edges per ``index_add_`` of the plain version: its [chunk, d] gathered
#: rows stay a few GB at d = 256 where the whole [E, d] stream of a 30M-edge
#: graph would not fit on the card
PLAIN_EDGE_CHUNK = 1 << 22


def spmm_csr_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   weight: torch.Tensor, x: torch.Tensor, *,
                   bf16: bool = False) -> torch.Tensor:
    """The plain version: expand ``indptr`` to row ids and ``index_add_``
    the weighted source rows, ``PLAIN_EDGE_CHUNK`` edges at a time.
    ``bf16=True`` rounds ``x`` and ``w`` to bf16 first, as the bf16 kernel
    does; the product of two bf16 values is exact in f32, so the two differ
    only in the order of the sums."""
    _build.LAUNCHES["spmm_csr_plain"] += 1
    n_rows = indptr.numel() - 1
    if bf16:
        x = x.to(torch.bfloat16)
        weight = weight.to(torch.bfloat16)
    x = x.float()
    weight = weight.float()
    rows = edge_rows(indptr, indices.numel())
    y = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    for s in range(0, indices.numel(), PLAIN_EDGE_CHUNK):
        e = slice(s, s + PLAIN_EDGE_CHUNK)
        y.index_add_(0, rows[e], weight[e, None] * x[indices[e].long()])
    return y


def _check(indptr, indices, weight, x) -> None:
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError(f"indptr and indices must be int32, got "
                        f"{indptr.dtype} and {indices.dtype}")
    if indptr.dim() != 1 or indices.dim() != 1 or weight.shape != indices.shape:
        raise ValueError(f"bad CSR shapes: indptr {tuple(indptr.shape)}, "
                         f"indices {tuple(indices.shape)}, "
                         f"weight {tuple(weight.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("weight", weight), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if indptr.numel() < 1 or indices.numel() >= 2**31 or x.shape[1] >= 2**31:
        raise ValueError("sizes outside the kernel's int32 indexing")


def vec_width(d: int, x: torch.Tensor, widths) -> int:
    """The widest vector (elements per lane load) that divides ``d`` and
    keeps every row of ``x`` aligned to it."""
    for v in widths:
        if d % v == 0 and x.data_ptr() % (v * x.element_size()) == 0:
            return v
    return 1


def lane_layout(d: int, x: torch.Tensor, widths) -> tuple:
    """(vec, nv, group) of the light-row kernel for rows of width ``d``:
    each lane loads ``nv`` vectors of ``vec`` elements per edge (two where a
    row has more than 32 vectors, so a warp covers d = 256 f32 in one pass),
    and a row gets the smallest power-of-two group of lanes that covers it,
    at most a warp; narrower rows share a warp."""
    vec = vec_width(d, x, widths)
    n_vec = d // vec
    nv = 1 if n_vec <= 32 else 2
    lanes = max(1, -(-n_vec // nv))
    return vec, nv, min(32, 1 << (lanes - 1).bit_length())


def _launch(name: str, indptr, indices, weight, x, widths,
            schedule: Optional[RowSchedule]) -> torch.Tensor:
    n_rows, d = indptr.numel() - 1, x.shape[1]
    s = schedule if schedule is not None else build_schedule(indptr.cpu().numpy()).to(x.device)
    s.check(n_rows, indices.numel(), x.device)
    y = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    partial = torch.empty(s.n_chunks, d, dtype=torch.float32, device=x.device)
    vec, nv, group = lane_layout(d, x, widths)
    _build.launch(name, x.device, indptr.data_ptr(), indices.data_ptr(), weight.data_ptr(),
                  x.data_ptr(), y.data_ptr(), n_rows, d, vec, nv, group,
                  s.hub_rows.data_ptr(), s.hub_chunk_ptr.data_ptr(), s.n_hub,
                  s.chunk_bounds.data_ptr(), s.n_chunks, s.threshold, partial.data_ptr())
    return y


def _plain(indptr, indices, weight, x, schedule: Optional[RowSchedule],
           bf16: bool) -> torch.Tensor:
    """The CPU route: the plain version, after the same schedule check as
    the CUDA route, so that a schedule of another CSR is refused here too."""
    if schedule is not None:
        schedule.check(indptr.numel() - 1, indices.numel(), x.device)
    return spmm_csr_plain(indptr, indices, weight, x, bf16=bf16)


def spmm_csr_f32(indptr: torch.Tensor, indices: torch.Tensor,
                 weight: torch.Tensor, x: torch.Tensor,
                 schedule: Optional[RowSchedule] = None) -> torch.Tensor:
    """f32 CSR SpMM: the CUDA kernels on a CUDA tensor, the plain version on
    a CPU one. ``schedule``: the CSR's ``RowSchedule`` on x's device."""
    if not _build.on_cuda(x, "SpMM"):
        return _plain(indptr, indices, weight, x, schedule, bf16=False)
    _check(indptr, indices, weight, x)
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"spmm_csr_f32 takes float32 x and weight, got "
                        f"{x.dtype} and {weight.dtype}")
    return _launch("spmm_csr_f32", indptr, indices, weight, x, (4, 2, 1), schedule)


def spmm_csr_bf16(indptr: torch.Tensor, indices: torch.Tensor,
                  weight: torch.Tensor, x: torch.Tensor,
                  schedule: Optional[RowSchedule] = None) -> torch.Tensor:
    """bf16-operand CSR SpMM with f32 accumulation and f32 output: the CUDA
    kernels on a CUDA tensor, the plain version on a CPU one."""
    if not _build.on_cuda(x, "SpMM"):
        return _plain(indptr, indices, weight, x, schedule, bf16=True)
    _check(indptr, indices, weight, x)
    if not (x.is_floating_point() and weight.is_floating_point()):
        raise TypeError(f"spmm_csr_bf16 takes floating x and weight, got "
                        f"{x.dtype} and {weight.dtype}")
    xb = x.to(torch.bfloat16)  # RTNE, as the TPU kernel's cast
    wb = weight.to(torch.bfloat16)
    return _launch("spmm_csr_bf16", indptr, indices, wb, xb, (8, 4, 2, 1), schedule)
