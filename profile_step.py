"""Where the device time of the port's TeacherGNN epoch goes, on one CUDA card.

    python3 profile_step.py [--epochs 6] [--out chiprun_out/profile]

For each SpMM route of the slice (``--spmm_method=auto``: the f32 kernel;
``pallas_bf16``: the bf16 kernel), with the node-classification loss and
with the I2-GTL edgewise loss (``--exp_mode=I2_GTL --task=nodeC``), this
calls the port's ``main`` on ogbn-arxiv's shape (the synthetic stand-in that
``chip_smoke.py`` trains) twice in one process: 3 unprofiled epochs to warm CUDA, cuBLAS and the
kernel build, then ``--epochs`` epochs under ``torch.profiler``. Each epoch
is one train step (forward, backward, Adam) and one eval-mode forward.

From the profiled run's device events (the chrome trace, written to
``--out``) it prints, per cell:

- device ms by class: the SpMM kernels (every kernel the SpMM wrappers
  launch: light rows, hub chunks, their reduction), GEMMs, host<->device
  copies, and all other kernels (elementwise passes, reductions, casts),
  with their shares of the device time, and the SpMM launches by kernel;
- the busy share of the device over the training loop, from its first
  kernel to its last device event (the set-up copies of ``train_teacher``
  come before that window); the idle share is one minus it;
- the kernels that took the most device time, and the host step ms.

The last line is one JSON object with these numbers and the card's name and
power limit. Exits non-zero without a CUDA card or when the trace holds no
device events.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

import torch

SLICE_ARGS = ["--dataset=ogbn-arxiv", "--train_which=TeacherGNN",
              "--device=cuda", "--log_every=0"]
#: cell name -> its flags: each SpMM route, with either teacher loss
CELLS = {f"{loss}{method}": [f"--spmm_method={method}"] + flags
         for loss, flags in (("", []), ("I2_GTL ", ["--exp_mode=I2_GTL",
                                                    "--task=nodeC"]))
         for method in ("auto", "pallas_bf16")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the SpMM wrappers' kernels (csrc/spmm_csr.cu): light rows, hub chunks and
#: their reduction
SPMM_KERNEL = re.compile(r"\bspmm_\w+_kernel\b")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def op_class(cat: str, name: str) -> str:
    if cat != "kernel":
        return "copies" if cat == "gpu_memcpy" else "memset"
    if SPMM_KERNEL.search(name):
        return "spmm"
    if re.search(r"gemm|cutlass|cublas", name, re.I):
        return "gemm"
    return "other kernels"


def busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals, in ms (trace is in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def summarize(trace_path: str) -> dict:
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not any(e["cat"] == "kernel" for e in events):
        raise RuntimeError(f"{trace_path} holds no device kernels: the "
                           "profiler did not trace the card")
    by_class = collections.Counter()
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for e in events:
        by_class[op_class(e["cat"], e["name"])] += e["dur"] / 1e3
        by_kernel[e["name"]] += e["dur"] / 1e3
        launches[e["name"]] += 1
    spmm_launches = collections.Counter()  # by kernel, over its instances
    for k, n in launches.items():
        m = SPMM_KERNEL.search(k)
        if m:
            spmm_launches[m.group(0)] += n
    total = sum(by_class.values())
    t0 = min(e["ts"] for e in events if e["cat"] == "kernel")
    loop = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["ts"] >= t0]
    span = (max(end for _, end in loop) - t0) / 1e3
    busy = busy_ms(loop)
    return {
        "device_ms": total,
        "by_class_ms": dict(by_class),
        "share": {k: v / total for k, v in by_class.items()},
        "loop_span_ms": span,
        "loop_busy_ms": busy,
        "loop_idle_share": 1.0 - busy / span,
        "spmm_launches": dict(spmm_launches),
        "top_kernels": [(k[:70], v, launches[k])
                        for k, v in by_kernel.most_common(12)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: torch finds no CUDA device", file=sys.stderr)
        return 2
    from gnn_tail_generalization_tpu_torch import main as port_main

    card_name = card()
    os.makedirs(args.out, exist_ok=True)
    report = {"card": card_name, "epochs": args.epochs, "cells": {}}
    for cell, flags in CELLS.items():
        argv = SLICE_ARGS + flags
        port_main.main(argv + ["--epochs=3"])  # warm-up, not profiled
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = port_main.main(argv + [f"--epochs={args.epochs}"])
        trace = os.path.join(args.out, f"trace_{cell.replace(' ', '_')}.json")
        prof.export_chrome_trace(trace)
        s = summarize(trace)
        s["step_ms"] = res[0].step_ms
        report["cells"][cell] = s
        print(f"== {' '.join(flags)}: {args.epochs} epochs, {card_name}")
        print(f"  device ms {s['device_ms']:.3f}; loop span "
              f"{s['loop_span_ms']:.3f} ms, busy {s['loop_busy_ms']:.3f} ms, "
              f"idle share {s['loop_idle_share']:.4f}")
        for k, v in sorted(s["by_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {k:14s} {v:9.3f} ms  {100 * s['share'][k]:5.1f}%")
        print(f"  spmm launches {s['spmm_launches']}")
        for name, ms, n in s["top_kernels"]:
            print(f"    {ms:9.3f} ms {n:5d}x  {name}")
        print(f"  step_ms {[round(t, 3) for t in s['step_ms']]}")
    print(card_name)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
