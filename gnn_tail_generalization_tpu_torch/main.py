"""Experiment CLI of the PyTorch port.

Takes the flags of the root ``main.py`` (every field of ``Config``, plus
``--data_root``, ``--log_every``, ``--epoch_block``, ``--n_devices`` and
``--hier_mesh``) and prints the same per-epoch and mean ± std lines.
``--train_which`` is TeacherGNN, one of the Cold Brew students: SEMLP
(teacher, SE table, part 1, part 2), StudentBaseMLP or GraphMLP, or LP
(label propagation, which prints one JSON line of accuracies and ends the
seed loop). ``--exp_mode=I2_GTL --task=nodeC`` trains the teacher with the
edgewise loss; with another ``--task`` it trains link prediction on the
transfer split (``run_i2gtl``) and prints its stats as one JSON line.
Raw dataset files under ``--data_root`` are read where present, else a
synthetic stand-in with the preset shapes is used. ``--N_exp > 1`` under
TeacherGNN goes through ``train/multiseed.py``; ``--prog`` resumes a batch
grid through ``utils/records.py:TensorRex``, and ``--records_path`` /
``--records_desc`` save each column's curves.

``--n_devices=S`` runs ``--train_which`` row-sharded over S ranks
(``parallel/``; every value: TeacherGNN, SEMLP, StudentBaseMLP, GraphMLP,
LP, and the I2-GTL teacher): S local processes started by
``parallel/launch.py``, or, when ``WORLD_SIZE`` is set, the processes
torchrun started. The collectives go over NCCL when every rank has a card
of its own, over gloo with ``--dist_transport=gloo`` (host-staged, so
several ranks may share one card; NCCL refuses two ranks on one card) and
on the CPU. Rank 0 prints the lines a one-device run prints; seeds run one
after another. Link
prediction (``--exp_mode=I2_GTL --task=linkp``) is not sharded here, as in
the JAX CLI; ``linkpred/model.py:train_linkpred(comm=...)`` shards it.

``--hier_mesh=HxC`` trains the TeacherGNN on the two-level (host x card)
layout (``parallel/hier.py``, ``data/datasets.py:prepare_hier``): H x C
local ranks on a ``(host, chip)`` mesh, or torchrun's world with C ranks a
node, the transport as for ``--n_devices``; rank 0 prints the one-device
lines. It refuses another ``--train_which`` and graph dropout, as the JAX
CLI does. The 2-D graph x model mesh has no flag here, as in the JAX CLI:
it is the library path ``prepare_sharded(..., model_axis=...)``.

Usage:
  python -m gnn_tail_generalization_tpu_torch.main --dataset=ogbn-arxiv \
      --train_which=SEMLP --whetherHasSE=111 --epochs=3 --device=cuda
  python -m gnn_tail_generalization_tpu_torch.main --exp_mode=I2_GTL \
      --task=linkp --device=cuda
  python -m gnn_tail_generalization_tpu_torch.main --dataset=ogbn-arxiv \
      --n_devices=2 --epochs=3 --device=cuda       # add --dist_transport=gloo
                                                    # on a host with one card
  python -m gnn_tail_generalization_tpu_torch.main --dataset=TEXAS \
      --train_which=SEMLP --n_devices=4 --epochs=2 --device=cpu
  torchrun --nproc_per_node=4 -m gnn_tail_generalization_tpu_torch.main \
      --dataset=ogbn-arxiv --epochs=3
  python -m gnn_tail_generalization_tpu_torch.main --dataset=TEXAS \
      --hier_mesh=2x2 --epochs=2 --device=cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import Config, apply_arch_configs, build_config
from .data.datasets import (PreparedData, load_dataset, prepare, prepare_hier,
                            prepare_sharded)
from .data.synthetic import fast_powerlaw_graph
from .parallel.comm import TRANSPORTS, Comm
from .parallel.launch import spawn
from .parallel.mesh import HOST_CHIP, DeviceMesh, parse_hier_mesh
from .parallel.multihost import initialize_multihost
from .train.loops import TrainResult, run_experiment
from .utils.device import resolve_device


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Tail and cold start generalization (PyTorch/CUDA port)")
    for f in dataclasses.fields(Config):
        if f.name in ("TeacherGNN", "StudentBaseMLP", "preStep", "midStep",
                      "lpStep"):
            continue  # derived sub-configs
        default = f.default if f.default is not dataclasses.MISSING else None
        optional_types = {"skip_weight": float, "num_groups": int}
        if isinstance(default, bool):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        elif f.name in optional_types:
            parser.add_argument(f"--{f.name}", type=optional_types[f.name],
                                default=None)
        elif isinstance(default, (int, float, str)) or default is None:
            cast = type(default) if default is not None else str
            parser.add_argument(f"--{f.name}", type=cast, default=None)
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--epoch_block", type=int, default=0,
                        help="accepted and ignored: in the JAX package it "
                             "scans blocks of epochs in one jitted call to "
                             "save TPU host syncs, and its records are "
                             "bitwise-identical across block sizes; here "
                             "each epoch is one eager step")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="row shards of the run, one local process each "
                             "(under torchrun: its WORLD_SIZE)")
    parser.add_argument("--dist_transport", choices=TRANSPORTS, default=None,
                        help="collectives of a sharded run: nccl (one card a "
                             "rank; the default on the card) or gloo (staged "
                             "through the host, so ranks may share a card; "
                             "the CPU's)")
    parser.add_argument("--hier_mesh", type=str, default=None,
                        help="HxC (e.g. 2x4): the two-level (host x card) "
                             "layout, a ring within each host and only the "
                             "halo across hosts (parallel/hier.py); H x C "
                             "ranks. TeacherGNN only")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    ns = parser.parse_args(argv)
    cli_only = ("data_root", "log_every", "epoch_block", "n_devices",
                "dist_transport", "hier_mesh", "device")
    overrides = {k: v for k, v in vars(ns).items()
                 if v is not None and k not in cli_only}
    for f in dataclasses.fields(Config):  # int-encoded bools back to bool
        if f.name in overrides and isinstance(f.default, bool):
            overrides[f.name] = bool(overrides[f.name])
    return overrides, ns


def _torchrun_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def _sharded(ns) -> bool:
    return ns.n_devices > 1 or _torchrun_world() > 1 or bool(ns.hier_mesh)


SHARDED_TRAIN_WHICH = ("TeacherGNN", "SEMLP", "StudentBaseMLP", "GraphMLP", "LP")


def _check_supported(cfg: Config, ns) -> None:
    if ns.hier_mesh:
        h, c = parse_hier_mesh(ns.hier_mesh)
        if cfg.train_which != "TeacherGNN" or (cfg.exp_mode == "I2_GTL"
                                               and cfg.task != "nodeC"):
            raise ValueError(f"--hier_mesh trains the TeacherGNN (as the JAX CLI "
                             f"does), not {cfg.train_which!r} / task {cfg.task!r}")
        if cfg.apply_graph_dropout:
            raise ValueError("--hier_mesh: graph-dropout tricks need the DistGraph "
                             "edge view; use --n_devices for them")
        if ns.n_devices > 1:
            raise ValueError("--hier_mesh and --n_devices name two layouts; give one")
        if _torchrun_world() > 1 and _torchrun_world() != h * c:
            raise ValueError(f"--hier_mesh={ns.hier_mesh} under torchrun's "
                             f"WORLD_SIZE={_torchrun_world()}")
        return
    if not _sharded(ns):
        return
    if cfg.exp_mode == "I2_GTL" and cfg.task != "nodeC":
        raise ValueError("--n_devices>1 does not shard link prediction on the "
                         "CLI (nor does the JAX CLI); call linkpred/model.py:"
                         "train_linkpred(comm=...) on each rank")
    if cfg.train_which not in SHARDED_TRAIN_WHICH:
        raise ValueError(f"--n_devices>1 runs train_which in {SHARDED_TRAIN_WHICH}, "
                         f"not {cfg.train_which!r}")
    if _torchrun_world() > 1 and ns.n_devices not in (1, _torchrun_world()):
        raise ValueError(f"--n_devices={ns.n_devices} under torchrun's "
                         f"WORLD_SIZE={_torchrun_world()}")


def run_i2gtl(data_root: str, log_every: int, device) -> Dict[str, float]:
    """exp_mode=I2_GTL: link-prediction transfer learning (the reference's
    trainer_link_prediction.py standalone mode): the default
    ``LinkPredConfig``, 2 runs of 5 epochs on the i2t transfer split of
    ogbl-citation2 read from ``data_root`` (``data/ogb.py:load_ogbl_graph``)
    or, with no raw files, of a 2,000-node synthetic stand-in. Prints and
    returns the stats."""
    from .data.ogb import load_ogbl_graph
    from .linkpred import model as lpm
    from .linkpred import surgery

    try:
        g, _ = load_ogbl_graph(data_root, "ogbl-citation2")
        g2, se = surgery.transfer_surgery_node_year(g, "i2t")
    except FileNotFoundError:
        print("NOTE: no ogbl raw files; synthetic transfer stand-in.")
        rng = np.random.default_rng(0)
        n = 2000
        g = surgery.GraphData(
            x=rng.normal(size=(n, 64)).astype(np.float32),
            edge_index=fast_powerlaw_graph(n, 10000, 0),
            node_year=rng.integers(2010, 2019, n),
            keys=np.arange(n),
        )
        g2, se = surgery.transfer_surgery_node_year(g, "i2t", drop_rate=0.0)
    out = lpm.train_linkpred(lpm.LinkPredConfig(), g2.x, g2.edge_index,
                             g2.n_node, epochs=5, runs=2, split_edge=se,
                             log_every=log_every, device=device)
    print(json.dumps(out["stats"]))
    return out["stats"]


def open_rex(cfg: Config):
    """(TensorRex, cell) of ``--prog``: "i-j-k" or "i-j-k/Si-Sj-Sk" (the
    reference's prog string carries the grid shape, main.py:29-31). Without
    an explicit shape an existing rex file defines it, and a fresh one is
    sized to contain the cell."""
    from .utils.records import TensorRex

    spec = cfg.prog.replace(",", "-")
    shape = None
    if "/" in spec:
        cell_s, shape_s = spec.split("/")
        cell = tuple(int(v) for v in cell_s.split("-"))
        shape = tuple(int(v) for v in shape_s.split("-"))
    else:
        cell = tuple(int(v) for v in spec.split("-"))
    rex = TensorRex(f"{cfg.records_path}/{cfg.rexName}",
                    grid_shape=shape or tuple(c + 1 for c in cell),
                    record_len=8, grow_to_fit=shape is None)
    return rex, cell


def fitted_to(cfg: Config, data) -> Config:
    """``cfg`` with the node, feature and class counts of ``data`` (a
    ``NodeData`` or ``PreparedData``)."""
    return apply_arch_configs(dataclasses.replace(
        cfg, N_nodes=data.x.shape[0], num_feats=data.x.shape[1],
        num_classes=int(data.y.max()) + 1))


def load_prepared(cfg: Config, data_root: str,
                  comm: Union[Comm, DeviceMesh, None] = None,
                  rb: int = 128) -> Tuple[Config, PreparedData]:
    """The dataset prepared for ``cfg``, and ``cfg`` fitted to the synthetic
    stand-in's shapes when no raw files were found. With ``comm``, rank
    ``comm.shard``'s part (``prepare_sharded``, shards of ``rb``-row
    multiples; a ``(host, chip)`` ``DeviceMesh``: ``prepare_hier``), and
    only rank 0 prints."""
    data = load_dataset(cfg, data_root)
    if data.name.startswith("synthetic"):
        if comm is None or comm.rank == 0:
            print(f"NOTE: no raw dataset files found under {data_root!r}; "
                  f"running on a synthetic stand-in with the preset shapes.")
        cfg = fitted_to(cfg, data)
    if comm is None:
        return cfg, prepare(data, cfg)
    if isinstance(comm, DeviceMesh):
        return cfg, prepare_hier(data, cfg, comm, rb=rb)
    return cfg, prepare_sharded(data, cfg, comm, rb=rb)


def _full_f32_matmuls() -> None:
    # f32 matmuls in full f32, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv: Optional[List[str]] = None
         ) -> List[Union[TrainResult, Dict[str, float]]]:
    """Runs the experiment; returns one result per seed (a ``TrainResult``,
    or LP's dict of accuracies), or none when ``--prog`` finds its cell
    done. A sharded run returns rank 0's results."""
    overrides, ns = parse_args(argv)
    cfg = build_config(**overrides)
    _check_supported(cfg, ns)
    if _sharded(ns):
        transport = ns.dist_transport or ("gloo" if ns.device == "cpu" else "nccl")
        world, mesh = ns.n_devices, None
        if ns.hier_mesh:
            h, c = parse_hier_mesh(ns.hier_mesh)
            world, mesh = h * c, ((h, c), HOST_CHIP)
        if _torchrun_world() > 1:
            return sharded_main(initialize_multihost(transport, ns.device, mesh=mesh),
                                argv)
        return spawn(sharded_main, world, transport, ns.device, argv, mesh=mesh)[0]
    device = resolve_device(ns.device)
    _full_f32_matmuls()
    if cfg.exp_mode == "I2_GTL" and cfg.task != "nodeC":
        return [run_i2gtl(ns.data_root, ns.log_every, device)]
    return _run(cfg, overrides, ns, device)


def sharded_main(comm: Union[Comm, DeviceMesh], argv: Optional[List[str]]
                 ) -> List[Union[TrainResult, Dict[str, float]]]:
    """One rank of ``main`` under ``--n_devices``, or under ``--hier_mesh``
    with its ``(host, chip)`` mesh (``parallel/launch.py`` starts it; under
    torchrun ``main`` calls it)."""
    overrides, ns = parse_args(argv)
    _full_f32_matmuls()
    return _run(build_config(**overrides), overrides, ns, comm.device, comm)


def _run(cfg: Config, overrides: dict, ns, device,
         comm: Union[Comm, DeviceMesh, None] = None
         ) -> List[Union[TrainResult, Dict[str, float]]]:
    """The experiment on this process, on one device or as one rank
    (``comm``), where rank 0 prints and records."""
    say = comm is None or comm.rank == 0
    if say:
        print(f"Configs:\n  dataset={cfg.dataset} train_which={cfg.train_which} "
              f"type_trick={cfg.type_trick} num_layers={cfg.num_layers} "
              f"dim_hidden={cfg.dim_hidden}")
    rex = cell = None
    if cfg.prog:
        # tensorRex batch-grid resumption (main.py:54-124): skip a done
        # cell, record the final row when the cell completes
        rex, cell = open_rex(cfg)
        if rex.is_done(cell):
            if say:
                print(f"rex cell {cell} already done; skipping")
            return []
    cfg, pd = load_prepared(cfg, ns.data_root, comm)

    if cfg.train_which == "TeacherGNN" and cfg.N_exp > 1 and comm is None:
        from .train.multiseed import train_teacher_multiseed

        seeds = [cfg.random_seed + s for s in range(cfg.N_exp)]
        results = train_teacher_multiseed(cfg, pd, seeds, log_every=ns.log_every,
                                          device=device)
        for seed, res in enumerate(results):
            print(f"seed {seed}: " + " ".join(
                f"{c}={res.records[-1, i]:.2f}" for i, c in enumerate(res.columns)))
    else:
        results = []
        for seed in range(cfg.N_exp):
            res = run_experiment(cfg, pd, seed=cfg.random_seed + seed,
                                 log_every=ns.log_every, device=device)
            results.append(res)
            if isinstance(res, dict):  # pure LP
                if not say:
                    return results
                print(json.dumps(res))
                if rex is not None:
                    rex.record(cell, list(res.values()))
                    print(f"rex cell {cell} recorded")
                return results
            if say:
                print(f"seed {seed}: " + " ".join(
                    f"{c}={res.records[-1, i]:.2f}" for i, c in enumerate(res.columns)),
                    flush=True)
    if not say:
        return results

    stacked = np.stack([r.records for r in results])  # [seeds, epochs, cols]
    cols = results[-1].columns
    if overrides.get("records_path") or overrides.get("records_desc"):
        # wzRec-style persistence (utils.py:1005-1051): one npy per column
        from .utils.records import save_curve

        rdir = f"{cfg.records_path}/{cfg.records_desc or cfg.dataset}"
        for i, c in enumerate(cols):
            save_curve(stacked[:, :, i], f"{c}@{cfg.train_which}", rdir)
        print(f"records saved under {rdir}")
    final = stacked[:, -1, :]
    print("=== mean ± std over seeds (final epoch) ===")
    for i, c in enumerate(cols):
        print(f"  {c}: {final[:, i].mean():.2f} ± {final[:, i].std():.2f}")
    best_i = cols.index("acc_test") if "acc_test" in cols else 0
    print(f"best acc_test over epochs, per seed: "
          f"{stacked[:, :, best_i].max(axis=1)}")
    if rex is not None:
        rex.record(cell, final.mean(axis=0))
        print(f"rex cell {cell} recorded to {cfg.records_path}/{cfg.rexName}")
    return results


if __name__ == "__main__":
    main()
