"""The port's side of ``test_torch_port_hier.py``: what each of its spawned
gloo ranks computes on the two-axis layouts, with the inputs it is built
from.

A module of its own that imports no JAX, so that each spawned rank, which
imports the rank programs by name, starts in seconds. It holds no test."""
import dataclasses

import numpy as np
import torch

from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
from gnn_tail_generalization_tpu_torch.parallel import distgraph as tdg
from gnn_tail_generalization_tpu_torch.parallel import hier as thier
from gnn_tail_generalization_tpu_torch.parallel.mesh import (GRAPH_MODEL, HOST_CHIP,
                                                             DeviceMesh)
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.train.edgewise import score_pairs_sharded
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax

WORLD, RB, SEED, N = 4, 8, 3, 96
HIER_LAYOUTS = ((2, 2), (1, 4), (4, 1))
METHODS = ("auto", "pallas_bf16")
HIER_SPMM_CASES = [(hc, m) for hc in HIER_LAYOUTS for m in METHODS]
MESH_2D = (2, 2)  # (graph, model)
# (width, method): 48 splits over the model axis, 5 stays whole
SPMM_2D_CASES = ((48, "auto"), (48, "pallas_bf16"), (5, "auto"))


def random_graph(seed, n=N, e=600):
    """(edge_index, weights, dense A[dst, src]), as ``tests/test_hier.py``."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), w)
    return np.stack([src, dst]), w, dense


def features(seed, d, n=N):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def fixed_pairs(n, p=12, n_neg=16, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, k).astype(np.int64) for k in (p, p, n_neg, n_neg)]


def _grad_step(g, fn, x, ct):
    x = torch.from_numpy(g.local_rows(x)).requires_grad_()
    y = fn(x)
    (y * torch.from_numpy(g.local_rows(ct))).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def rank_hier_spmm(mesh, case):
    (h, c), method = case
    ei, w, _ = random_graph(h * 10 + c)
    g = thier.build_hier_graph(ei, N, mesh, w, rb=RB)
    return _grad_step(g, lambda x: spmm(g, x, method), features(1, 32), features(2, 32))


def rank_flat_vs_hier(world, mesh):
    """(hier y, flat DistGraph y) at S = 4 on the same rows."""
    ei, w, _ = random_graph(7, n=128, e=800)
    hg = thier.build_hier_graph(ei, 128, mesh, w, rb=RB)
    dg = tdg.build_dist_graph(ei, 128, world, w, rb=RB)
    x = torch.from_numpy(hg.local_rows(features(3, 16, hg.n_node_pad)))
    return spmm(hg, x).numpy(), spmm(dg, x).numpy()


def rank_2d_spmm(mesh, case):
    d, method = case
    ei, w, _ = random_graph(11)
    g = tdg.build_dist_graph(ei, N, mesh.comm("graph"), w, rb=RB,
                             model_comm=mesh.comm("model"))
    return _grad_step(g, lambda x: spmm(g, x, method), features(4 + d, d),
                      features(5 + d, d))


def rank_2d_take_rows(mesh):
    g = tdg.build_dist_graph(np.stack([np.arange(90)] * 2), 90, mesh.comm("graph"),
                             rb=RB, model_comm=mesh.comm("model"))
    h = torch.from_numpy(g.local_rows(features(3, 8, g.n_node_pad))).requires_grad_()
    idx = torch.tensor([0, 5, 17, 89, 33, 33, 60, 24])
    rows = tdg.dist_take_rows(g, h, idx)
    ct = torch.from_numpy(features(4, 8, 8))
    ((rows * ct).sum() / g.n_shards).backward()  # a term every rank computes whole
    return rows.detach().numpy(), h.grad.numpy()


# one GCNConv under pallas_bf16 on a 16-node cycle (degrees 1), with
# values whose every f32 sum is exact: each input gradient is 1 + 1 + 2^-9,
# which bf16 rounds to 2 when the whole sum is rounded once, as on one
# device, and leaves at 2 + 2^-9 when each model shard's part is rounded
CYCLE_N = 16
CONV_W = np.array([[1, 1, 1, 0], [1, 1, 0, 1]], np.float32)
CONV_CT = np.array([1, 1, 2 ** -9, 2 ** -9], np.float32)


def cycle_edges(n=CYCLE_N):
    return np.stack([np.arange(n), (np.arange(n) + 1) % n])


def rank_2d_conv_bf16(mesh):
    """The input gradient of a 2-D mesh's column-parallel conv (above)."""
    from gnn_tail_generalization_tpu_torch.nn.gcn import GCNConv
    from gnn_tail_generalization_tpu_torch.parallel.comm import own_cols

    mc = mesh.comm("model")
    g = tdg.build_dist_graph(cycle_edges(), CYCLE_N, mesh.comm("graph"), rb=RB,
                             model_comm=mc)
    conv = GCNConv(2, 4, CYCLE_N, spmm_method="pallas_bf16", model_comm=mc)
    conv.weight.data = own_cols(torch.from_numpy(CONV_W), mc)
    x = torch.ones(g.rows_per_shard, 2, requires_grad=True)
    (conv(g, x)[0] * torch.from_numpy(CONV_CT)).sum().backward()
    return x.grad.numpy()


def port_cfg(ct, npad):
    return dataclasses.replace(ct, N_nodes=npad)


def _state_2d(mesh, ct, init, npad):
    return params_from_jax(init["params"], port_cfg(ct, npad), init["stats"],
                           shard=mesh.coords["graph"], n_shards=MESH_2D[0],
                           model_shard=mesh.coords["model"], n_model=MESH_2D[1])


def rank_2d_step(mesh, ct, arrays, init):
    """One 2-D step: NLL, SE regulariser and the edgewise loss on fixed
    pairs; the loss summed over the graph axis and this rank's gradients."""
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct, mesh, rb=RB, model_axis="model")
    g = pd.graph
    model = tloops._teacher_model(ct, SEED, _state_2d(mesh, ct, init, g.n_node_pad), g)
    model.train()
    pairs = [torch.from_numpy(p) for p in fixed_pairs(90)]
    loss, _ = tloops.teacher_step_grads(
        ct, model, g, torch.from_numpy(pd.x), torch.from_numpy(pd.y),
        torch.from_numpy(pd.train_mask),
        edgewise=lambda h: score_pairs_sharded(g, h, pairs))
    total = g.comm.all_reduce_sum_(loss.detach().clone()).item()
    return total, {k: p.grad.numpy() for k, p in model.named_parameters()}


def rank_2d_train(mesh, ct, arrays, init, save_dir=None):
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct, mesh, rb=RB, model_axis="model")
    view = tloops.final_agg_view(ct, pd)
    res = tloops.train_teacher(ct, pd, seed=SEED, epochs=3, device="cpu",
                               init_state=_state_2d(mesh, ct, init, pd.graph.n_node_pad),
                               save_dir=save_dir)
    return {"records": res.records, "columns": res.columns, "view": view is not None,
            "state": {k: v.numpy() for k, v in res.state_dict.items()}}


def rank_hier_train(mesh, ct, arrays, init):
    pd = tds.prepare_hier(tds.NodeData(**arrays), ct, mesh, rb=RB)
    g = pd.graph
    state = params_from_jax(init["params"], port_cfg(ct, g.n_node_pad), init["stats"],
                            shard=g.comm.shard, n_shards=g.n_shards)
    res = tloops.train_teacher(ct, pd, seed=SEED, epochs=3, device="cpu",
                               init_state=state)
    return {"records": res.records, "columns": res.columns,
            "view": tloops.final_agg_view(ct, pd) is not None,
            "state": {k: v.numpy() for k, v in res.state_dict.items()}}


def rank_program(world, spec):
    """Everything the test file asks of the ranks, in one process group. The
    meshes are built in one order on every rank (``DeviceMesh`` makes its
    groups collectively)."""
    hier = {hc: DeviceMesh(world, hc, HOST_CHIP) for hc in HIER_LAYOUTS}
    two_d = DeviceMesh(world, MESH_2D, GRAPH_MODEL)
    out = {
        "coords": {"hier": {hc: m.coords for hc, m in hier.items()},
                   "2d": two_d.coords},
        "hier_spmm": {case: rank_hier_spmm(hier[case[0]], case)
                      for case in HIER_SPMM_CASES},
        "flat_vs_hier": rank_flat_vs_hier(world, hier[(2, 2)]),
        "spmm_2d": {case: rank_2d_spmm(two_d, case) for case in SPMM_2D_CASES},
        "take_rows_2d": rank_2d_take_rows(two_d),
        "conv_bf16_2d": rank_2d_conv_bf16(two_d),
        "step_2d": rank_2d_step(two_d, *spec["step_2d"]),
        "train_2d": {name: rank_2d_train(two_d, *args)
                     for name, args in spec["train_2d"].items()},
        "train_hier": rank_hier_train(hier[(2, 2)], *spec["train_hier"]),
    }
    out["counts"] = {
        "world": dict(world.counts),
        "hier": {hc: {a: dict(m.comm(a).counts) for a in HOST_CHIP}
                 for hc, m in hier.items()},
        "2d": {a: dict(two_d.comm(a).counts) for a in GRAPH_MODEL}}
    return out
