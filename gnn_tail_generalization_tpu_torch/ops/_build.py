"""Build and load the CUDA kernels of ``csrc/`` as a plain-C shared library.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
``gnn_tail_generalization_tpu_torch/_build/`` at first use; the file name
carries a hash of every source in ``csrc/`` (``*.cu`` and ``*.cuh``) and of
the flags, so an edited source builds anew. The library is loaded with
``ctypes`` and its functions get their argument types here. Nothing is
built or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None


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
    """The loaded kernel library (built first if needed), with typed entry
    points ``spmm_csr_f32``, ``spmm_csr_bf16``, ``topk_rows_f32``,
    ``edge_attn_rows_f32`` and ``pair_dot_f32``."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a loaded kernel library's entry points their argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spmm_csr_f32, lib.spmm_csr_bf16):
        # indptr, indices, w, x, y, n_rows, d, vec, nv, group, hub_rows,
        # hub_chunk_ptr, n_hub, chunk_bounds, n_chunks, threshold, partial,
        # stream
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, i, p, i, i, p, p]
        fn.restype = i
    # scores, n_rows, n_cols, ld, k, out_vals, out_idx, stream
    lib.topk_rows_f32.argtypes = [p, i, i, ctypes.c_longlong, i, p, p, p]
    lib.topk_rows_f32.restype = i
    # mode, indptr, indices, a, b, alpha, out, n_rows, d, vec, nv, scale,
    # hub_rows, hub_chunk_ptr, n_hub, chunk_bounds, n_chunks, threshold,
    # partial, stream
    lib.edge_attn_rows_f32.argtypes = [i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float,
                                       p, p, i, p, i, i, p, p]
    lib.edge_attn_rows_f32.restype = i
    # h, pairs, out, n, m, d, stream
    ll = ctypes.c_longlong
    lib.pair_dot_f32.argtypes = [p, p, p, ll, ll, i, p]
    lib.pair_dot_f32.restype = i
    return lib
