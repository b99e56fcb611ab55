"""Experiment CLI of the PyTorch port.

Takes the config flags of the root ``main.py`` (every field of ``Config``)
and prints the same per-epoch and mean ± std lines. ``--train_which`` is
TeacherGNN, one of the Cold Brew students: SEMLP (teacher, SE table,
part 1, part 2), StudentBaseMLP or GraphMLP, or LP (label propagation,
which prints one JSON line of accuracies and ends the seed loop).
``--exp_mode=I2_GTL`` with a ``--task`` other than nodeC trains link
prediction on the transfer split (``run_i2gtl``) and prints its stats as
one JSON line.

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
import os
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
    parser.add_argument("--n_devices", type=int, default=1,
                        help="only 1: the multi-device layer is not ported "
                             "yet (ROADMAP A12)")
    parser.add_argument("--hier_mesh", type=str, default=None,
                        help="not ported yet (ROADMAP A12)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    ns = parser.parse_args(argv)
    cli_only = ("data_root", "log_every", "n_devices", "hier_mesh", "device")
    overrides = {k: v for k, v in vars(ns).items()
                 if v is not None and k not in cli_only}
    for f in dataclasses.fields(Config):  # int-encoded bools back to bool
        if f.name in overrides and isinstance(f.default, bool):
            overrides[f.name] = bool(overrides[f.name])
    return overrides, ns


def _check_supported(cfg: Config, overrides: dict, ns) -> None:
    if ns.n_devices > 1 or ns.hier_mesh:
        raise NotImplementedError(
            "--n_devices>1 / --hier_mesh: the multi-device layer is not "
            "ported yet (ROADMAP A12)")
    if cfg.prog or "records_path" in overrides or "records_desc" in overrides:
        raise NotImplementedError(
            "--prog / --records_path / --records_desc: utils/records.py is "
            "not ported yet (ROADMAP A11)")


def run_i2gtl(data_root: str, log_every: int, device) -> Dict[str, float]:
    """exp_mode=I2_GTL: link-prediction transfer learning (the reference's
    trainer_link_prediction.py standalone mode): the default
    ``LinkPredConfig``, 2 runs of 5 epochs on the i2t transfer split of
    ogbl-citation2 or, with no raw files, of a 2,000-node synthetic
    stand-in. Prints and returns the stats."""
    from .linkpred import model as lpm
    from .linkpred import surgery

    if any(os.path.isdir(os.path.join(data_root, d))
           for d in ("ogbl-citation2", "ogbl_citation2")):
        raise NotImplementedError(
            f"raw ogbl-citation2 files found under {data_root!r}, but the "
            "port has no ogbl reader yet (ROADMAP A0b, dataset readers)")
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
    overrides, ns = parse_args(argv)
    cfg = build_config(**overrides)
    _check_supported(cfg, overrides, ns)
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
    cfg, pd = load_prepared(cfg, ns.data_root)

    results = []
    for seed in range(cfg.N_exp):
        res = run_experiment(cfg, pd, seed=cfg.random_seed + seed,
                             log_every=ns.log_every, device=device)
        results.append(res)
        if isinstance(res, dict):  # pure LP
            print(json.dumps(res))
            return results
        print(f"seed {seed}: " + " ".join(
            f"{c}={res.records[-1, i]:.2f}" for i, c in enumerate(res.columns)))

    stacked = np.stack([r.records for r in results])  # [seeds, epochs, cols]
    final = stacked[:, -1, :]
    cols = results[-1].columns
    print("=== mean ± std over seeds (final epoch) ===")
    for i, c in enumerate(cols):
        print(f"  {c}: {final[:, i].mean():.2f} ± {final[:, i].std():.2f}")
    best_i = cols.index("acc_test")
    print(f"best acc_test over epochs, per seed: "
          f"{stacked[:, :, best_i].max(axis=1)}")
    return results


if __name__ == "__main__":
    main()
