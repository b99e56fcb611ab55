"""A configuration, a cell and a per-layer metric that reads one kernel by
name are added by new files and entries in ``BENCHMARK.json`` alone: in a
copy of the benchmark, with nothing that was there edited, the new cell is
covered, the file keeps the contract's shape, and the new cell's tiny run
on the CPU is correct."""
import json
import os
import shutil
import subprocess
import sys

import run

CELL = "coldbrew-copy.teacher-copy"


def _add_files(bench):
    conf = json.loads((bench / "configs" / "coldbrew-arxiv.json").read_text())
    conf["name"] = "coldbrew-copy"
    (bench / "configs" / "coldbrew-copy.json").write_text(json.dumps(conf))
    (bench / "reference" / "coldbrew-copy.py").write_text(
        '"""The reference of coldbrew-copy: coldbrew-arxiv\'s."""\n'
        "from harness import spec\n\n"
        'teacher_steps = spec.load_module("reference", "coldbrew-arxiv").teacher_steps\n')
    shutil.copy(bench / "traffic" / "teacher.json", bench / "traffic" / "teacher-copy.json")
    (bench / "metrics" / "gemm_kernel_ms.py").write_text(
        '"""gemm_kernel_ms.*: device ms a step of the kernels named like a GEMM."""\n'
        "from harness import readers\n\n\n"
        "def read(r):\n"
        '    return readers.kernel_ms(r, r"gemm")\n')
    shutil.copy(bench / "tests" / "cells" / "coldbrew-arxiv.teacher.py",
                bench / "tests" / "cells" / f"{CELL}.py")


def _add_entries(path):
    b = json.loads(path.read_text())
    b["configs"].append({"name": "coldbrew-copy", "source": b["configs"][0]["source"],
                         "file": "benchmark/configs/coldbrew-copy.json", "reduced": [],
                         "why": "a copy of coldbrew-arxiv under a new name"})
    b["workloads"].append({"name": CELL, "config": "coldbrew-copy", "traffic": "teacher-copy",
                           "chips": 1, "why": "a copy of coldbrew-arxiv.teacher"})
    step = next(m for m in b["end_to_end"] if m["name"] == "epoch_ms")
    step["workloads"].append(CELL)
    b["per_layer"].append({"name": "gemm_kernel_ms.epoch", "unit": "ms/step",
                           "better": "lower", "source": "device_trace",
                           "layer": "model and nn", "moves": "epoch_ms", "workloads": [CELL]})
    path.write_text(json.dumps(b, indent=1))


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(run.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "_out", "_cache"))
    shutil.copy(run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    _add_files(bench)
    _add_entries(root / "BENCHMARK.json")

    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "tests/test_bench_cells.py::test_every_cell_is_covered",
         f"tests/test_bench_cells.py::test_tiny_run_is_correct[{CELL}]",
         "tests/test_bench_readers.py::test_benchmark_json_has_the_contracts_shape"],
        cwd=bench, env={**os.environ, "PYTHONPATH": str(run.ROOT)},
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
    assert "3 passed" in res.stdout
    assert [p for p, data in before.items() if p.read_bytes() != data] == []
