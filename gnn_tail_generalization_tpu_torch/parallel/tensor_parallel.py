"""The 2-D (graph x model) SGD step of the bespoke two-layer teacher.

The port of ``gnn_tail_generalization_tpu/parallel/tensor_parallel.py``, on
``parallel/mesh.py:DeviceMesh((n_graph, n_model), ("graph", "model"))``. It
extends ``parallel/distributed.py``'s 1-D dst-row partition with a model
axis over the feature dimensions (``:1-17``):

- ``x``, ``y``, the mask and the degrees are row-sharded over ``graph``
  and whole on every model rank;
- ``w0`` ``[feat, hidden]`` and ``b0`` are cut by columns over ``model``
  (column parallel), the SE table ``se0`` over both axes, ``w1``
  ``[hidden, classes]`` by rows over ``model`` (row parallel), and ``b1`` is
  replicated;
- layer 1: ``(x * out_s) @ w0 + se0`` at width ``hidden / M``, all-gathered
  over ``graph`` and summed into the rank's rows by the f32 kernel
  (``distributed.dist_spmm``), then ``relu(agg * in_s + b0)``;
- layer 2: the row-parallel product's partial logits summed over ``model``
  (``parallel/comm.py:reduce_from``, whose backward is the identity: every
  model rank computes the loss whole) plus ``b1``, then aggregated over the
  graph at ``n_class`` and scaled by ``in_s``. Layer 2 has no ``out_s`` and
  no SE, and ``b1`` comes before the aggregation (``:94-101``): not the 1-D
  step's form, so the two share no forward;
- the NLL summed over ``graph``, the SE norm's square over ``graph`` then
  ``model`` (``:103-111``), and SGD.

The model axis never communicates inside the graph aggregation. Gradients
follow ``distributed.sharded_grads``: each rank backpropagates the whole loss
divided by the graph axis's size (the graph-axis all-reduces sum the copies
back; the model-axis sum passes its gradient on as it is), and the
gradients of the parameters replicated over ``graph`` (all but ``se0``) are
summed over it. ``utils/convert.py:teacher_2d_params`` cuts a rank's
parameters from whole ones (``init_2d_teacher``'s or the JAX package's).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .comm import Comm, reduce_from
from .distributed import (Spec, ShardedGraph, batch_shardings, degree_scales,
                          dist_spmm, masked_nll, sgd, sharded_grads,
                          xavier_uniform)
from .mesh import GRAPH_MODEL, DeviceMesh

batch_shardings_2d = batch_shardings  # rows over graph, whole over model


def make_2d_mesh(world: Comm, n_graph: int, n_model: int) -> DeviceMesh:
    """The (graph, model) mesh over the world's ranks, row-major as
    ``jax.make_mesh``; collective (``parallel/mesh.py``)."""
    return DeviceMesh(world, (n_graph, n_model), GRAPH_MODEL)


def init_2d_teacher(seed: int, n_node_pad: int, n_feat: int, n_hidden: int,
                    n_class: int) -> Dict[str, np.ndarray]:
    """The whole parameters, numpy f32, from ``seed`` (JAX's distributions,
    not its draws)."""
    rng = np.random.default_rng(seed)
    return {"w0": xavier_uniform(rng, n_feat, n_hidden),
            "b0": np.zeros(n_hidden, np.float32),
            "se0": rng.standard_normal((n_node_pad, n_hidden), np.float32),
            "w1": xavier_uniform(rng, n_hidden, n_class),
            "b1": np.zeros(n_class, np.float32)}


_SPECS_2D = {"w0": (None, "model"), "b0": ("model",), "se0": ("graph", "model"),
             "w1": ("model", None), "b1": ()}


def param_shardings_2d(params: Mapping) -> Dict[str, Spec]:
    return {k: _SPECS_2D[k] for k in params}


def loss_2d(mesh: DeviceMesh, sg: ShardedGraph, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], se_reg: float = 1.0) -> torch.Tensor:
    """The 2-D forward, NLL and SE norm (module docstring), the same value on
    every rank. ``params``: this rank's blocks; ``batch``: its graph shard's
    rows."""
    graph, model = mesh.comm("graph"), mesh.comm("model")
    out_s, in_s = degree_scales(batch["deg_out"], batch["deg_in"])
    h = (batch["x"] * out_s) @ params["w0"] + params["se0"]  # [rows, hidden / M]
    h = torch.relu(dist_spmm(sg, h, graph) * in_s + params["b0"])
    logits = reduce_from(h @ params["w1"], model) + params["b1"]
    logits = dist_spmm(sg, logits, graph) * in_s
    loss = masked_nll(logits, batch["y"], batch["train_mask"], graph)
    sq = reduce_from(graph.all_reduce_sum((params["se0"] ** 2).sum()), model)
    return loss + se_reg * torch.sqrt(sq)


def make_2d_train_step(mesh: DeviceMesh, lr: float = 1e-2, se_reg: float = 1.0):
    """The SGD step over the 2-D mesh: ``step(params, batch, sg)`` gives (new
    params, loss); ``sg`` is sharded over the graph axis."""

    def step(params, batch, sg):
        loss, grads = sharded_grads(
            params, lambda p: loss_2d(mesh, sg, p, batch, se_reg),
            param_shardings_2d(params), mesh.comm("graph"))
        return sgd(params, grads, lr), loss

    return step
