"""What the link-prediction cells share: the port's ``LinkPredConfig`` for a
configuration file, the citation2-shaped inputs made from the seed, the
port's preparation of the message graph, and the model with the
benchmark's weights."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from gnn_tail_generalization_tpu_torch.graph.core import symmetrize
from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
from gnn_tail_generalization_tpu_torch.linkpred import sampling
from harness import gen, roofline, spec


def port_config(conf: Dict[str, Any]):
    return lpm.LinkPredConfig(**conf["model"])


@dataclasses.dataclass
class LinkInputs:
    n_node: int
    split: Dict[str, np.ndarray]  # valid / test / train positives [m, 2]
    reference: Any = None  # the configuration's reference module
    _graph: Optional[Dict[str, torch.Tensor]] = None

    def graph(self, device) -> Dict[str, torch.Tensor]:
        """The reference's message graph on ``device``, made once, after
        the window."""
        if self._graph is None:
            train = torch.as_tensor(self.split["train"], device=device)
            self._graph = self.reference.message_graph(train, self.n_node)
        return self._graph


def inputs(conf: Dict[str, Any], seed: int, device) -> LinkInputs:
    d = conf["dataset"]
    edges = gen.powerlaw_edges(d["n_node"], d["n_raw_edge"], seed, device)
    return LinkInputs(d["n_node"], gen.holdout_split(edges, d["n_valid"], d["n_test"], seed,
                                                     device),
                      spec.load_module("reference", conf["name"]))


def port_message_graph(cfg, inp: LinkInputs, device, with_keys: bool):
    """The port's preparation: the message edges (the train positives
    symmetrized), their graph on the card and, for training, the
    membership table of the negative sampler."""
    msg = symmetrize(inp.split["train"].T, inp.n_node)
    g = lpm.link_graph(cfg, msg, inp.n_node).to(device)
    keys = (sampling.build_membership(sampling.edge_keys(msg, inp.n_node)).to(device)
            if with_keys else None)
    return g, keys


def model_inits(cfg, n_node: int):
    """(shape, init) of every leaf of the port's link model: the node
    embedding of xavier variance, Dense kernels ``[out, in]`` of lecun
    variance, biases 0."""
    with torch.device("meta"):
        state = lpm.LinkPredModel(cfg, n_node, 0).state_dict()
    inits = {}
    for k, t in state.items():
        shape = tuple(t.shape)
        if k == "node_emb":
            inits[k] = (shape, ("normal", (2.0 / sum(shape)) ** 0.5))
        elif k.endswith(".weight") and len(shape) == 2:
            inits[k] = (shape, ("normal", shape[1] ** -0.5))
        elif k.endswith(".bias"):
            inits[k] = (shape, ("zeros",))
        else:
            raise ValueError(f"no initialiser for the link model's leaf {k} {shape}")
    return inits


def port_model(cfg, n_node: int, init: Dict[str, torch.Tensor], seed: int, device):
    """The port's ``LinkPredModel`` (built as ``train_linkpred`` builds it)
    holding the benchmark's weights, and its step constants."""
    with torch.device(device):
        model = lpm.LinkPredModel(cfg, n_node, 1,
                                  generator=torch.Generator(device=device).manual_seed(seed))
    model.load_state_dict(init)
    return model


def encode_flops(cfg, n_node: int) -> float:
    """The forward GEMMs of the SAGE encoder: a root and a neighbour Dense a
    layer over every node."""
    d = cfg.gnn_hidden_channels
    return cfg.gnn_num_layers * 2 * roofline.gemm_flops(n_node, d, d)
