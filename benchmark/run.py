"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

``NAME`` is a ``workloads`` entry of ``BENCHMARK.json``. The run makes its
inputs and weights from ``--seed``, builds the cell (set-up, counted in
``setup_s``), drives the cell's entry for whole units until ``--seconds``
have passed, checks what the timed path produced against the plain
reference, and prints one JSON line last on stdout: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checked``, each number compared beside its
limit (also the last lines on stderr). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of a window of at most the traffic's
``trace_seconds``.

Exit codes: 0 with a result; 1 without a CUDA card (or fewer than the cell
asks for), or when a module of JAX or of the JAX package was loaded; 2 for
an unknown workload. Everything the run builds stays inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402
from harness.check import report  # noqa: E402

#: modules that no run may load, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_tail_generalization_tpu")
#: fixed cache directories inside the checkout, so that a second run there
#: finds what the first one built
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
OUT_DIR = BENCH / "_out"


def use_checkout_caches() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(BENCH / "_cache" / sub)


def apply_precision(config: Dict[str, Any]) -> None:
    """TF32 on or off for float32 GEMMs and convolutions, as the
    configuration's ``precision`` block states it."""
    import torch

    tf32 = bool(config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What an entry's ``build`` gets: the configuration file, the traffic
    parameters, the seed, the device, and ``stage(name)``, which times a
    set-up stage (``prep`` is the port's preparation: ``prep_s``) under a
    span of the same name."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any], seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.stages: Dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        import torch

        t = time.perf_counter()
        with torch.profiler.record_function(f"setup.{name}"):
            yield
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t


def run_window(cell, seconds: float):
    """Whole units of the cell's entry until ``seconds`` have passed:
    (steps, failed, host seconds, ending in a synchronize)."""
    import torch

    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    steps = failed = 0
    while True:
        with torch.profiler.record_function("window.unit"):
            s, f = cell.unit()
        steps, failed = steps + s, failed + f
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return steps, failed, time.perf_counter() - t0


class Readings:
    """What a per-layer reader gets: ``summary`` (the traced window's
    ``harness.trace.Summary``, None on the CPU), ``work`` (the cell's
    work a step from its shapes) and ``stages`` (set-up seconds)."""

    def __init__(self, summary, work: Dict[str, float], stages: Dict[str, float]):
        self.summary, self.work, self.stages = summary, work, stages


def deep_update(base: Dict[str, Any], over: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = deep_update(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def run_cell(bench: Dict[str, Any], cell_spec: Dict[str, Any], seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = T_START,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of a cell: the result line's dict. ``overrides``
    {"config": ..., "traffic": ...} replace values of the two files (the
    CPU tests shrink the sizes)."""
    import torch

    from harness import trace as T

    overrides = overrides or {}
    device = torch.device(device)
    config = deep_update(spec.config(bench, cell_spec["config"]), overrides.get("config"))
    traffic = deep_update(spec.traffic(cell_spec["traffic"]), overrides.get("traffic"))
    apply_precision(config)
    entry = spec.load_module("entries", traffic["entry"])  # imports the port
    stages: Dict[str, float] = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    stages["cuda_init"] = time.perf_counter() - t
    ctx = Ctx(config, traffic, seed, device)
    ctx.stages.update(stages)
    cell = entry.build(ctx)
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    print("[bench] setup stages (s): " + json.dumps({**ctx.stages, "setup_s": setup_s}),
          file=sys.stderr, flush=True)

    summary = None
    if trace and on_card:
        box = {}

        def window():
            box["r"] = run_window(cell, min(seconds, traffic["trace_seconds"]))
            return box["r"][0], box["r"][2]
        summary = T.traced(window, OUT_DIR / f"{cell_spec['name']}.trace.json")
        steps, failed, window_s = box["r"]
    else:
        steps, failed, window_s = run_window(
            cell, min(seconds, traffic["trace_seconds"]) if trace else seconds)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    work = cell.work()
    cell.release()
    if on_card:
        torch.cuda.empty_cache()
    compared = cell.check()
    correct = all(c.ok for c in compared) and failed == 0

    reported = [traffic["step_metric"], "setup_s", "peak_gib"]
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = {traffic["step_metric"]: window_s * 1e3 / steps, "setup_s": setup_s,
                  "peak_gib": window_peak / 2**30}
        for m in spec.end_to_end_for(bench, cell_spec):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        r = Readings(summary, work, ctx.stages)
        for m in spec.per_layer_for(bench, cell_spec, reported):
            v = spec.load_module("metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                           "count": cell_spec["chips"],
                           "memory_peak_bytes": max(setup_peak, window_peak)}
    out: Dict[str, Any] = {"correct": correct, "attempted": steps, "failed": failed,
                           "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                            "idle_gaps": [list(x) for x in summary.idle_gaps]}
    out["checked"] = report(compared)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    bench = spec.load_benchmark()
    try:
        cell_spec = spec.workload(bench, args.workload)
    except spec.UnknownName as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_spec["chips"]:
        print(f"benchmark: {args.workload} needs {cell_spec['chips']} CUDA card(s); torch "
              f"finds {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = run_cell(bench, cell_spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 1
    for name, c in out["checked"].items():
        print(f"checked {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
