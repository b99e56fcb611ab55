"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 [--control] \
        [--faults half,eval_alter]

For each seed: the cell's set-up (as a run makes it, with no window), then
the compared numbers of the program against the plain reference (the lower
readings), and with ``--control`` of the control (the reference in TF32 in
the program's place), of each fault planted in the reference
(``--faults``) and, for a training cell, of a step that leaves its state
unchanged, against the same reference (the upper readings). One JSON
line a seed and kind on stdout.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    import torch

    run.use_checkout_caches()
    bench = spec.load_benchmark()
    cell_spec = spec.workload(bench, args.workload)
    conf = spec.config(bench, cell_spec["config"])
    traffic = spec.traffic(cell_spec["traffic"])
    run.apply_precision(conf)
    entry = spec.load_module("entries", traffic["entry"])
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = run.Ctx(conf, traffic, seed, device)
        cell = entry.build(ctx)
        cell.release()
        torch.cuda.empty_cache()
        ref = cell.reference()
        kinds = [("program", cell.program_outputs())]
        if args.control:
            kinds.append(("control", cell.reference(tf32=True)))
        if hasattr(cell, "frozen"):
            kinds.append(("fault:frozen", cell.frozen(ref)))
        for f in filter(None, args.faults.split(",")):
            kinds.append((f"fault:{f}", cell.reference(fault=f)))
        for kind, out in kinds:
            cmp = cell.compare(out, ref)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              **{c.name: c.value for c in cmp},
                              "where": {c.name: c.where for c in cmp if c.where},
                              "detail": {c.name: c.detail for c in cmp if c.detail}}),
                  flush=True)
        print(f"[calibrate] seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
