"""Time the port's CSR SpMM kernels on one CUDA card against their bound, one
PyTorch call and another kernel source, and sweep their tuning choices.

    python3 profile_spmm.py [--baseline OLD.cu] [--citation2]
        [--thresholds 32,64,256] [--variant NAME=-DFLAG=V ...]

For every graph (the bench-shape power-law graph of ``chip_smoke.py`` phase 2
and the slice's own graph; with ``--citation2`` also phase 7's message
graph), forward and transposed, f32 and bf16, at d = 256 (the bench graph
also at d = 40) it prints:

- ``ms``: the port's wrapper through ``ops/spmm.py:spmm_impl`` (the bf16
  time includes its rounding of x and w), median of CUDA-event timed calls;
- ``base_ms``: with ``--baseline``, the same function through a kernel
  library built from another source with the one-kernel C interface
  (``spmm_csr_{f32,bf16}(indptr, indices, w, x, y, n_rows, d, vec, stream)``),
  timed in turns with the port's: base, port, port, base (such a source is
  ``csrc/spmm_csr.cu`` of a commit before the row schedule, taken out with
  ``git show``);
- ``plain_ms``: the plain version (``spmm_csr_plain``, the bf16 one with
  its rounding) on the same inputs;
- ``library_ms`` and ``bound_ms``: ``chip_smoke.library_fn`` (torch.sparse.mm
  of a CSR tensor, cuSPARSE; x already in the working type, so its bf16
  time has no rounding pass) and ``ops/spmm_kernels.py:spmm_bound``;
- ``gather_ms``: the time HBM takes to read one source row per edge (E x d
  elements of the working type, no reuse in L2), and ``share_of_gather``,
  gather_ms / ms.

On the bench graph it also times the kernels on the graph's light rows alone
(in-degree <= HUB_DEGREE, the other rows' edges removed) and on its hub rows
alone. On each forward graph it then sweeps the tuning choices, each alone
against the defaults: ``--thresholds`` (the row schedule's hub threshold,
``graph/core.py:build_schedule``) and ``--variant`` (the kernel library built
with extra nvcc flags, e.g. ``L4=-DSPMM_LOADS=4``). The last
line is one JSON object with every number and the card's name and power
limit. Exits non-zero without a CUDA card.
"""
import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke

#: rows above this in-degree are timed apart from the others; the
#: one-warp-a-row kernel walked each of them with a single warp
HUB_DEGREE = 256
D = 256
METHODS = {"f32": "pallas", "bf16": "pallas_bf16"}


def nvcc_library(srcs, flags, tag: str) -> str:
    """Build ``srcs`` with the port's nvcc flags plus ``flags`` into the
    port's build directory; return the library's path."""
    from gnn_tail_generalization_tpu_torch.ops import _build

    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(open(s, "rb").read())
    out = _build.BUILD_DIR / f"libspmm_{tag}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
                        *map(str, srcs)], check=True)
    return str(out)


def load_baseline(src: str):
    """A library built from ``src`` with the one-kernel argument types."""
    lib = ctypes.CDLL(nvcc_library([src], [], "baseline"))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spmm_csr_f32, lib.spmm_csr_bf16):
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
        fn.restype = i
    return lib


def baseline_fn(lib, g, x, bf16: bool):
    """The one-kernel wrapper's work on ``lib``: round x and w for bf16, pick the
    vector width, launch."""
    widths = (8, 4, 2, 1) if bf16 else (4, 2, 1)
    name = "spmm_csr_bf16" if bf16 else "spmm_csr_f32"
    d = x.shape[1]

    def run():
        xx = x.to(torch.bfloat16) if bf16 else x
        w = g.weight.to(torch.bfloat16) if bf16 else g.weight
        vec = next(v for v in widths if d % v == 0
                   and xx.data_ptr() % (v * xx.element_size()) == 0)
        y = torch.empty(g.n_node, d, device=x.device)
        rc = getattr(lib, name)(g.indptr.data_ptr(), g.indices.data_ptr(),
                                w.data_ptr(), xx.data_ptr(), y.data_ptr(),
                                g.n_node, d, vec,
                                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"baseline {name}: CUDA error {rc}"
        return y
    return run


def time_case(tag, g, x, base, card_name, reps=20) -> dict:
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm_impl

    rows = {}
    for name, method in METHODS.items():
        bf16 = name == "bf16"
        fn = lambda: spmm_impl(g, x, method)  # noqa: E731
        y = fn()
        y_ref = K.spmm_csr_plain(g.indptr, g.indices, g.weight, x, bf16=bf16)
        rel = chip_smoke.rel_err(y, y_ref)
        del y, y_ref
        r = {"rel_err": rel}
        extra = ""
        if base is not None:
            bfn = baseline_fn(base, g, x, bf16)
            r["base_rel_err"] = chip_smoke.rel_err(bfn(), fn())
            b1 = chip_smoke.median_ms(bfn, reps)
            k1 = chip_smoke.median_ms(fn, reps)
            k2 = chip_smoke.median_ms(fn, reps)
            b2 = chip_smoke.median_ms(bfn, reps)
            r["ms_turns"], r["base_ms_turns"] = [k1, k2], [b1, b2]
            r["ms"], r["base_ms"] = min(k1, k2), min(b1, b2)
            extra = (f" base_ms={r['base_ms']:.4f} (turns {b1:.4f} {k1:.4f} {k2:.4f} "
                     f"{b2:.4f})")
        else:
            r["ms"] = chip_smoke.median_ms(fn, reps)
        r["plain_ms"] = chip_smoke.median_ms(lambda: K.spmm_csr_plain(
            g.indptr, g.indices, g.weight, x, bf16=bf16), reps)
        r["library_ms"] = chip_smoke.median_ms(chip_smoke.library_fn(g, x, bf16), reps)
        r["bound_ms"], r["bound_by"] = K.spmm_bound(g, x.shape[1], bf16)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["gather_ms"] = (g.n_edge * x.shape[1] * (2 if bf16 else 4)
                          / K.HBM_BYTES_PER_S * 1e3)
        r["share_of_gather"] = r["gather_ms"] / r["ms"]
        rows[name] = r
        chip_smoke.log(
            f"  {tag:24s} {name:4s} d={x.shape[1]} E={g.n_edge} ms={r['ms']:.4f}"
            f"{extra} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) share={r['share_of_bound']:.3f} "
            f"gather_ms={r['gather_ms']:.4f} share_of_gather={r['share_of_gather']:.3f} "
            f"rel_err={rel:.2e} [{card_name}]")
        assert rel <= chip_smoke.REL_TOL, (tag, name, rel)
    return rows


@contextlib.contextmanager
def with_threshold(g, t: int):
    from gnn_tail_generalization_tpu_torch.graph.core import build_schedule

    yield dataclasses.replace(
        g, schedule=build_schedule(g.indptr.cpu().numpy(), t).to(g.indptr.device))


@contextlib.contextmanager
def with_library(g, lib):
    from gnn_tail_generalization_tpu_torch.ops import _build

    saved = _build.load()
    _build._lib = lib
    try:
        yield g
    finally:
        _build._lib = saved


def sweep(tag, g, x, settings, card_name, reps=20) -> dict:
    """ms of the port's kernels on ``g`` under each (label, context) setting."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm_impl

    out = {}
    for label, setting in settings:
        row = {}
        with setting(g) as gg:
            for name, method in METHODS.items():
                y = spmm_impl(gg, x, method)
                ref = K.spmm_csr_plain(gg.indptr, gg.indices, gg.weight, x,
                                       bf16=name == "bf16")
                assert chip_smoke.rel_err(y, ref) <= chip_smoke.REL_TOL, (tag, label)
                del y, ref
                row[name] = chip_smoke.median_ms(lambda: spmm_impl(gg, x, method), reps)
        out[label] = row
        chip_smoke.log(f"  {tag:24s} {label:18s} f32 {row['f32']:.4f} ms, bf16 "
                       f"{row['bf16']:.4f} ms [{card_name}]")
    return out


def split_rows(g, hub_degree: int):
    """(light-rows graph, hub-rows graph): ``g``'s edges into rows of
    in-degree <= / > ``hub_degree``, each over all of ``g``'s nodes."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    ip = g.indptr.cpu().numpy().astype(np.int64)
    deg = np.diff(ip)
    dst = np.repeat(np.arange(g.n_node), deg)
    src = g.indices.cpu().numpy()
    w = g.weight.cpu().numpy()
    hub = deg[dst] > hub_degree
    out = []
    for keep in (~hub, hub):
        out.append(build_graph(np.stack([src[keep], dst[keep]]), g.n_node,
                               w[keep], with_dense=False, with_plans=True))
    return out, int((deg > hub_degree).sum()), int(hub.sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a CUDA source with the one-kernel C interface, timed in turns")
    ap.add_argument("--citation2", action="store_true",
                    help="also phase 7's citation2-shape message graph")
    ap.add_argument("--thresholds", default="",
                    help="comma-separated hub thresholds to sweep")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAG[,FLAG...]: the kernels built with extra nvcc flags")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_spmm: torch finds no CUDA device", file=sys.stderr)
        return 2
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import (
        build_graph, standard_pipeline)
    from gnn_tail_generalization_tpu_torch.ops import _build
    from gnn_tail_generalization_tpu_torch.utils.device import card

    card_name = card()
    dev = torch.device("cuda")
    base = load_baseline(args.baseline) if args.baseline else None
    settings = [(f"T={t}", lambda g, t=int(t): with_threshold(g, t))
                for t in args.thresholds.split(",") if t]
    for v in args.variant:
        name, flags = v.split("=", 1)
        lib = _build.bind(ctypes.CDLL(nvcc_library(
            [s for s in _build.sources() if s.suffix == ".cu"], flags.split(","), name)))
        settings.append((name, lambda g, lib=lib: with_library(g, lib)))
    report = {"card": card_name, "baseline": args.baseline, "cases": {}, "sweep": {}}
    gen = torch.Generator(device=dev).manual_seed(0)

    n = chip_smoke.BENCH_NODES
    gb = build_graph(standard_pipeline(fast_powerlaw_graph(n, chip_smoke.BENCH_EDGES, 0), n),
                     n, with_dense=False, with_plans=True)
    _, pd = chip_smoke.slice_data()
    for tag, g in (("bench fwd", gb), ("bench transposed", gb.transpose()),
                   ("slice fwd", pd.graph)):
        g = g.to(dev)
        x = torch.randn(g.n_node, D, generator=gen, device=dev)
        report["cases"][tag] = time_case(tag, g, x, base, card_name)
        if tag == "bench fwd":
            x40 = torch.randn(g.n_node, 40, generator=gen, device=dev)
            report["cases"]["bench fwd d=40"] = time_case(
                "bench fwd", g, x40, base, card_name)
            report["sweep"]["bench fwd d=40"] = sweep(
                "bench fwd d=40", g, x40, settings, card_name)
        if "fwd" in tag:
            report["sweep"][tag] = sweep(tag, g, x, settings, card_name)

    (light, hub), n_hub, e_hub = split_rows(gb, HUB_DEGREE)
    chip_smoke.log(f"bench graph: {n_hub} rows of in-degree > {HUB_DEGREE} hold "
                   f"{e_hub} of {gb.n_edge} edges")
    report["bench_split"] = {"hub_degree": HUB_DEGREE, "hub_rows": n_hub,
                             "hub_edges": e_hub}
    x = torch.randn(n, D, generator=gen, device=dev)
    for tag, g in (("bench light rows only", light), ("bench hub rows only", hub)):
        report["cases"][tag] = time_case(tag, g.to(dev), x, base, card_name)

    if args.citation2:
        from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

        t0 = time.perf_counter()
        _, msg, _ = chip_smoke.lp_split(chip_smoke.C2_NODES, chip_smoke.C2_EDGES)
        g2 = lpm.link_graph(lpm.LinkPredConfig(), msg, chip_smoke.C2_NODES)
        chip_smoke.log(f"citation2 graph: E={g2.n_edge} built in "
                       f"{time.perf_counter() - t0:.1f} s")
        for tag, g in (("citation2 fwd", g2), ("citation2 transposed", g2.transpose())):
            g = g.to(dev)
            x = torch.randn(g.n_node, D, generator=gen, device=dev)
            report["cases"][tag] = time_case(tag, g, x, base, card_name, reps=5)
            if "fwd" in tag:
                report["sweep"][tag] = sweep(tag, g, x, settings, card_name, reps=5)
            del g, x
            torch.cuda.empty_cache()
    print(card_name)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
