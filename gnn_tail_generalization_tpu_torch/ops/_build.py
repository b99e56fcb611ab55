"""Build and load the CUDA kernels of ``csrc/`` as a plain-C shared library.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
``gnn_tail_generalization_tpu_torch/_build/`` at first use; the file name
carries a hash of every source in ``csrc/`` (``*.cu`` and ``*.cuh``) and of
the flags, so an edited source builds anew. The library is loaded with
``ctypes`` and its functions get their argument types here. Nothing is
built or loaded when the module is imported.

This module is the one seam between the port and the library. Every
wrapper (``ops/spmm_kernels.py``, ``topk_kernels.py``, ``edge_attention.py``,
``pair_score.py``) takes its device from ``on_cuda`` and launches through
``launch``, which counts each launch in ``LAUNCHES`` under the entry point's
name; the plain versions of the SpMM and of the attention rows count their
calls there too, under ``PLAIN``'s names. ``reset_launch_counts`` zeroes
them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import torch

from ..utils import debug

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# indptr, indices, w, x, y, n_rows, d, vec, nv, group, hub_rows,
# hub_chunk_ptr, n_hub, chunk_bounds, n_chunks, threshold, partial, stream
_SPMM = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P]
#: the library's entry points and their argument types; each returns a
#: CUDA error code (0 on success) and takes the stream last
ENTRY_POINTS = {
    "spmm_csr_f32": _SPMM,
    "spmm_csr_bf16": _SPMM,
    # scores, n_rows, n_cols, ld, k, out_vals, out_idx, stream
    "topk_rows_f32": [_P, _I, _I, _LL, _I, _P, _P, _P],
    # mode, indptr, indices, a, b, alpha, out, n_rows, d, vec, nv, scale,
    # hub_rows, hub_chunk_ptr, n_hub, chunk_bounds, n_chunks, threshold,
    # partial, stream
    "edge_attn_rows_f32": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                           _P, _P, _I, _P, _I, _I, _P, _P],
    # h, pairs, out, n, m, d, stream
    "pair_dot_f32": [_P, _P, _P, _LL, _LL, _I, _P],
}
#: the plain versions whose calls are counted beside the kernels'
PLAIN = ("spmm_csr_plain", "edge_attn_rows_plain")
#: launches of each entry point, and calls of each counted plain version,
#: since the last ``reset_launch_counts``
LAUNCHES = dict.fromkeys((*ENTRY_POINTS, *PLAIN), 0)

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts(prefix: str = "") -> dict:
    """A copy of the counts whose names start with ``prefix``: ``"spmm_csr"``
    the SpMM kernels' and their plain version's, ``"edge_attn_rows"`` the
    attention rows', and so on; every count by default."""
    return {k: v for k, v in LAUNCHES.items() if k.startswith(prefix)}


def sources() -> List[Path]:
    """Every kernel source and header, in a fixed order."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), its
    ``ENTRY_POINTS`` typed."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a loaded kernel library's entry points their argument types."""
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_cuda(t: torch.Tensor, kernel: str) -> bool:
    """The device rule of every wrapper: False for a CPU tensor (the plain
    version runs), True for a CUDA one (the kernel launches); raises for any
    other device, naming ``kernel``."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no {kernel} kernel for device {t.device}")


def launch(name: str, device: torch.device, *args, counter: Optional[str] = None) -> None:
    """Launch entry point ``name`` with ``args`` on ``device``'s current
    stream: one count in ``LAUNCHES[name]``, and one in the recorder's
    ``counter`` (``utils/debug.py``) where given. Raises ``RuntimeError`` on
    a non-zero CUDA error code."""
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        LAUNCHES[name] += 1
        if counter is not None:
            debug.count(counter)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
