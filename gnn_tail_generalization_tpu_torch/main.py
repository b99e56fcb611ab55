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
``--records_desc`` save each column's curves. Only the multi-device flags
(``--n_devices > 1``, ``--hier_mesh``) are not ported.

Usage:
  python -m gnn_tail_generalization_tpu_torch.main --dataset=ogbn-arxiv \
      --train_which=SEMLP --whetherHasSE=111 --epochs=3 --device=cuda
  python -m gnn_tail_generalization_tpu_torch.main --exp_mode=I2_GTL \
      --task=linkp --device=cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import Config, apply_arch_configs, build_config
from .data.datasets import PreparedData, load_dataset, prepare
from .data.synthetic import fast_powerlaw_graph
from .train.loops import TrainResult, run_experiment


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
                        help="only 1: the multi-device layer is not ported "
                             "yet (ROADMAP A12)")
    parser.add_argument("--hier_mesh", type=str, default=None,
                        help="not ported yet (ROADMAP A12)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    ns = parser.parse_args(argv)
    cli_only = ("data_root", "log_every", "epoch_block", "n_devices",
                "hier_mesh", "device")
    overrides = {k: v for k, v in vars(ns).items()
                 if v is not None and k not in cli_only}
    for f in dataclasses.fields(Config):  # int-encoded bools back to bool
        if f.name in overrides and isinstance(f.default, bool):
            overrides[f.name] = bool(overrides[f.name])
    return overrides, ns


def _check_supported(ns) -> None:
    if ns.n_devices > 1 or ns.hier_mesh:
        raise NotImplementedError(
            "--n_devices>1 / --hier_mesh: the multi-device layer is not "
            "ported yet (ROADMAP A12)")


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


def load_prepared(cfg: Config, data_root: str) -> Tuple[Config, PreparedData]:
    """The dataset prepared for ``cfg``, and ``cfg`` fitted to the synthetic
    stand-in's shapes when no raw files were found."""
    data = load_dataset(cfg, data_root)
    if data.name.startswith("synthetic"):
        print(f"NOTE: no raw dataset files found under {data_root!r}; "
              f"running on a synthetic stand-in with the preset shapes.")
        cfg = fitted_to(cfg, data)
    return cfg, prepare(data, cfg)


def main(argv: Optional[List[str]] = None
         ) -> List[Union[TrainResult, Dict[str, float]]]:
    """Runs the experiment; returns one result per seed (a ``TrainResult``,
    or LP's dict of accuracies), or none when ``--prog`` finds its cell
    done."""
    overrides, ns = parse_args(argv)
    cfg = build_config(**overrides)
    _check_supported(ns)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda, but torch finds no CUDA device")
    # f32 matmuls in full f32, as the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.exp_mode == "I2_GTL" and cfg.task != "nodeC":
        return [run_i2gtl(ns.data_root, ns.log_every, device)]

    print(f"Configs:\n  dataset={cfg.dataset} train_which={cfg.train_which} "
          f"type_trick={cfg.type_trick} num_layers={cfg.num_layers} "
          f"dim_hidden={cfg.dim_hidden}")
    rex = cell = None
    if cfg.prog:
        # tensorRex batch-grid resumption (main.py:54-124): skip a done
        # cell, record the final row when the cell completes
        rex, cell = open_rex(cfg)
        if rex.is_done(cell):
            print(f"rex cell {cell} already done; skipping")
            return []
    cfg, pd = load_prepared(cfg, ns.data_root)

    if cfg.train_which == "TeacherGNN" and cfg.N_exp > 1:
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
                print(json.dumps(res))
                if rex is not None:
                    rex.record(cell, list(res.values()))
                    print(f"rex cell {cell} recorded")
                return results
            print(f"seed {seed}: " + " ".join(
                f"{c}={res.records[-1, i]:.2f}" for i, c in enumerate(res.columns)))

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
