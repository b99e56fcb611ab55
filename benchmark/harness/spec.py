"""Where the harness finds what a name in ``BENCHMARK.json`` stands for.

Every configuration, traffic mix, cell entry, reference and per-layer
metric is a file of its own, found by its name:

- ``benchmark/configs/<config>.json``: the configuration (the ``file`` of
  its ``configs`` entry);
- ``benchmark/traffic/<traffic>.json``: a traffic mix's parameters, among
  them ``entry``, the name of the code that drives the window;
- ``benchmark/entries/<entry>.py``: that code (``build(ctx)``);
- ``benchmark/reference/<config>.py``: the configuration's plain
  reference;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader
  (``read(ctx)``); a metric ``<family>.<suffix>`` without a file of its
  own is read by its family's ``<family>.py``; one that reads a single
  kernel calls ``harness/readers.py:kernel_ms`` or ``kernel_roofline`` with
  a pattern of its name;
- ``benchmark/tests/cells/<cell>.py``: a cell's tiny sizes and planted
  faults for the CPU tests (``tests/test_bench_cells.py`` finds it).

So a cell, a configuration or a metric is added by adding files and
entries, never by editing one (``tests/test_bench_files_alone.py``).
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class UnknownName(KeyError):
    """A name that ``BENCHMARK.json`` or the benchmark's folders lack."""


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(e["name"] for e in entries)
    raise UnknownName(f"unknown {what} {name!r}; known: {known}")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: Dict[str, Any], name: str, root: Path = ROOT) -> Dict[str, Any]:
    entry = _by_name(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> Dict[str, Any]:
    path = BENCH_DIR / "traffic" / f"{name}.json"
    if not path.is_file():
        raise UnknownName(f"no traffic file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold ``-`` and
    ``.``, so it is loaded by its path); for a metric ``<family>.<suffix>``
    without a file of its own, ``<family>.py``."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file() and kind == "metrics" and "." in name:
        name = name.split(".")[0]
        path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise UnknownName(f"no {kind} file {path}")
    mod_name = f"bench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def per_layer_for(bench: Dict[str, Any], cell: Dict[str, Any],
                  reported: List[str]) -> List[Dict[str, Any]]:
    """The per-layer metrics that a cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def end_to_end_for(bench: Dict[str, Any], cell: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]
