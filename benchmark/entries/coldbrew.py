"""What the Cold Brew cells share: the port's ``Config`` for a configuration
file, the node inputs made from the seed, and the node graph's shapes."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from gnn_tail_generalization_tpu_torch.config import apply_arch_configs, build_config
from gnn_tail_generalization_tpu_torch.data.datasets import NodeData
from harness import check, gen

#: configuration-file keys that the port's config must hold as given
TEACHER_KEYS = ("type_trick", "num_layers", "dim_hidden", "dropout", "weight_decay",
                "lr", "res_alpha", "activation", "spmm_method", "se_reg")
STUDENT_KEYS = ("studentMLP__skip_conn_T_and_res_blks", "StudentMLP__dim_model",
                "SEMLP_topK_2_replace", "SEMLP_part1_arch", "dropout_MLP", "lr",
                "weight_decay")


def port_config(conf: Dict[str, Any], part: str):
    """The port's ``Config`` of ``part`` ("teacher" or "student"), built as
    its ``main`` builds it (dataset preset, best config), at the file's
    dataset sizes; raises where a key of the file differs from it."""
    d, t = conf["dataset"], conf["teacher"]
    cfg = build_config(dataset=d["name"], train_which=conf[part]["train_which"],
                       whetherHasSE=t["whetherHasSE"], se_reg=t["se_reg"],
                       spmm_method=t["spmm_method"])
    cfg = apply_arch_configs(dataclasses.replace(
        cfg, N_nodes=d["n_node"], num_feats=d["n_feat"], num_classes=d["n_class"],
        batch_size=conf["student"]["batch_size"]))
    keys = TEACHER_KEYS if part == "teacher" else STUDENT_KEYS
    for k in keys:
        if getattr(cfg, k) != conf[part][k]:
            raise ValueError(f"the port's {part} config has {k}={getattr(cfg, k)!r}, "
                             f"the configuration file {conf[part][k]!r}")
    return cfg


@dataclasses.dataclass
class NodeInputs:
    edges: np.ndarray  # [2, E] raw directed edges
    x: torch.Tensor  # [N, F] on the device
    y: torch.Tensor  # [N]
    train_mask: torch.Tensor  # [N] bool
    _graph: Optional[Dict[str, np.ndarray]] = None

    def graph(self) -> Dict[str, np.ndarray]:
        """The reference's node graph (``reference.plain.node_graph``, host
        arrays), made once, after the window."""
        if self._graph is None:
            from reference import plain

            self._graph = plain.node_graph(self.edges, self.x.shape[0])
        return self._graph


def node_inputs(conf: Dict[str, Any], seed: int, device) -> NodeInputs:
    d = conf["dataset"]
    x, y = gen.features_labels(d["n_node"], d["n_feat"], d["n_class"], seed, device)
    return NodeInputs(edges=gen.powerlaw_edges(d["n_node"], d["n_raw_edge"], seed, device),
                      x=x, y=y, train_mask=gen.train_mask(d["n_node"], d["train_fraction"],
                                                          seed, device))


def port_node_data(inp: NodeInputs, name: str):
    """The inputs as the port's ``NodeData`` (host arrays)."""
    mask = inp.train_mask.cpu().numpy()
    return NodeData(x=inp.x.cpu().numpy(), y=inp.y.cpu().numpy(), edge_index=inp.edges,
                    train_mask=mask, val_mask=None, test_mask=~mask, name=name)


def program_outputs(res, preds):
    """(each epoch's loss, the parameters after, None, each epoch's
    accuracies {name: %}, each eval forward's predicted classes) of a
    ``TrainResult``: the layout of the reference's outputs, whose third
    entry (gradient norms) the program does not report."""
    cols = res.columns
    loss = list(res.records[:, cols.index("loss_train")])
    evals = [{c: float(row[i]) for i, c in enumerate(cols) if c != "loss_train"}
             for row in res.records]
    return loss, {k: v.detach().clone() for k, v in res.state_dict.items()}, None, evals, preds


def compare(prog, ref, init, limits):
    """The training numbers (``check.training``), ``eval_flips`` and
    ``eval_gap``."""
    return check.training(prog, ref, init, limits) + [
        check.eval_flips(prog[4], ref[4], limits["eval_flips"]),
        check.eval_gap(prog[3], ref[3], limits["eval_gap"])]


def graph_shapes(g: Dict[str, np.ndarray], n: int, train_mask: np.ndarray) -> Dict[str, int]:
    """Edge and row counts of the node graph ``g`` (``reference.plain.
    node_graph``) and of its loss-masked view (the edges into train rows)."""
    src, dst = g["src"], g["dst"]
    m = train_mask[dst]

    def distinct(a):
        return int(np.count_nonzero(np.bincount(a, minlength=n)))
    return {"n": n, "nnz": int(src.size), "n_src": distinct(src),
            "nnz_masked": int(m.sum()), "n_src_masked": distinct(src[m]),
            "n_dst_masked": distinct(dst[m])}
