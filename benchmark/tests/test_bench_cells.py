"""Every cell on the CPU at a tiny size: one run against its plain
reference, the control and the planted faults coming out not correct, and
the run's exits. A cell's tiny sizes (``TINY``) and faults (``FAULTS``,
``EVAL_FAULTS``: functions of ``monkeypatch``) are in its own file,
``cells/<cell>.py``, found here by its name."""
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import run
from harness import spec

CELLS_DIR = Path(__file__).resolve().parent / "cells"
SEED = 2**31 + 12345  # seeds run past 32 signed bits


def _load_cell(path):
    mod_spec = importlib.util.spec_from_file_location(
        "bench_cell_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


CELLS = {p.name[:-len(".py")]: _load_cell(p) for p in sorted(CELLS_DIR.glob("*.py"))}
TINY = {name: cell.TINY for name, cell in CELLS.items()}
FAULTS = [(name, f) for name, cell in CELLS.items() for f in getattr(cell, "FAULTS", ())]
EVAL_FAULTS = [(name, f) for name, cell in CELLS.items()
               for f in getattr(cell, "EVAL_FAULTS", ())]


def tiny_run(name, trace=False):
    bench = spec.load_benchmark()
    return run.run_cell(bench, spec.workload(bench, name), SEED, 0.01, trace, device="cpu",
                        overrides=TINY[name])


def tiny_cell(name):
    bench = spec.load_benchmark()
    cell_spec = spec.workload(bench, name)
    conf = run.deep_update(spec.config(bench, cell_spec["config"]), TINY[name].get("config"))
    traffic = run.deep_update(spec.traffic(cell_spec["traffic"]), TINY[name].get("traffic"))
    entry = spec.load_module("entries", traffic["entry"])
    cell = entry.build(run.Ctx(conf, traffic, SEED, torch.device("cpu")))
    cell.release()
    return cell


def test_every_cell_is_covered():
    """One test file a cell of ``BENCHMARK.json``, and none for another."""
    assert sorted(CELLS) == sorted(w["name"] for w in spec.load_benchmark()["workloads"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_run_is_correct(name):
    out = tiny_run(name)
    assert out["correct"] is True, out["checked"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checked"
    bench = spec.load_benchmark()
    e2e = {m["name"] for m in spec.end_to_end_for(bench, spec.workload(bench, name))}
    assert set(out["metrics"]) == e2e
    assert all(v["value"] > 0 for k, v in out["metrics"].items() if k != "peak_gib")


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name):
    """The reference in TF32 in the program's place reads a hundred times
    the program's worst number or more and fails a limit; the program
    passes every one."""
    cell = tiny_cell(name)
    ref = cell.reference()
    prog = cell.compare(cell.program_outputs(), ref)
    ctrl = cell.compare(cell.reference(tf32=True), ref)
    assert all(c.ok for c in prog)
    assert max(c.value for c in ctrl) > 100 * max(c.value for c in prog)
    assert not all(c.ok for c in ctrl)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct_at_the_cells_size(card, name):
    """On the card at the cell's own size, three seeds: the program passes
    every limit, the control fails one (``calibrate.py --control``)."""
    res = subprocess.run([sys.executable, str(run.BENCH / "calibrate.py"), "--workload", name,
                          "--seeds", "101,102,103", "--control"],
                         capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-2000:]
    bench = spec.load_benchmark()
    limits = spec.traffic(spec.workload(bench, name)["traffic"])["limits"]
    rows = [json.loads(line) for line in res.stdout.splitlines()]
    for row in (r for r in rows if r["kind"] in ("program", "control")):
        over = [k for k in limits if row[k] > limits[k]]
        assert bool(over) == (row["kind"] == "control"), row


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_in_the_timed_path_is_not_correct(monkeypatch, name, fault):
    """A run whose timed path is broken underneath: a step that leaves its
    state unchanged, half of each batch left out, an answer altered where
    it is produced."""
    fault(monkeypatch)
    assert tiny_run(name)["correct"] is False


@pytest.mark.parametrize("name,fault", EVAL_FAULTS, ids=[n for n, _ in EVAL_FAULTS])
def test_fault_in_the_eval_alone_is_not_correct(monkeypatch, name, fault):
    """A run whose eval forwards alter half their rows' answers, the train
    step sound: the eval's numbers fail and the training numbers pass."""
    fault(monkeypatch)
    out = tiny_run(name)
    assert out["correct"] is False
    over = {k for k, c in out["checked"].items() if not c["value"] <= c["limit"]}
    assert "eval_flips" in over and not over & {"loss_gap", "change_gap", "median_gap"}


def test_unknown_workload_exits_2(capsys):
    assert run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"]) == 2
    assert "unknown workload" in capsys.readouterr().err


def test_no_card_exits_1_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "coldbrew-arxiv.teacher", "--seed", "1",
                     "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process leaves no module of JAX or of the JAX
    package in ``sys.modules`` (top-level names compared whole)."""
    over = json.dumps(TINY["i2gtl-citation2-sage.train"])
    code = (f"import json, sys; sys.path[:0] = [{str(run.BENCH)!r}, {str(run.ROOT)!r}]\n"
            "import run\n"
            "from harness import spec\n"
            "b = spec.load_benchmark()\n"
            "run.run_cell(b, spec.workload(b, 'i2gtl-citation2-sage.train'), 5, 0.01, False, "
            f"device='cpu', overrides=json.loads({over!r}))\n"
            "print(run.forbidden_modules())")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(run.BENCH))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_reads_no_forbidden_name_by_prefix():
    """The check compares whole top-level names: the port's name begins
    with the JAX package's."""
    saved = dict(sys.modules)
    try:
        sys.modules["gnn_tail_generalization_tpu_torch_x"] = types.ModuleType("x")
        assert "gnn_tail_generalization_tpu" not in run.forbidden_modules()
        sys.modules["jax"] = types.ModuleType("jax")
        assert "jax" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.card
def test_card_run_of_the_teacher_is_correct(card):
    """One short run of the teacher cell at its own size on the card."""
    res = subprocess.run([sys.executable, str(run.BENCH / "run.py"), "--workload",
                          "coldbrew-arxiv.teacher", "--seed", "7", "--seconds", "2"],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] is True
