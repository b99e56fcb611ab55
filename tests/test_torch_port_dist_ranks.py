"""The port's side of ``test_torch_port_dist.py``: what each of its spawned
gloo ranks computes, with the inputs it is built from.

A module of its own that imports no JAX, so that each spawned rank, which
imports the rank programs by name, starts in seconds. It holds no test."""
import dataclasses

import numpy as np
import torch

from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
from gnn_tail_generalization_tpu_torch.parallel import distgraph as tdg
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.train.edgewise import score_pairs_sharded
from gnn_tail_generalization_tpu_torch.utils.convert import params_from_jax

S, RB, SEED = 4, 8, 3


def random_graph(seed, n, e, block_diagonal=False):
    """(edge_index, weights, dense A[dst, src]); ``block_diagonal`` keeps
    every edge inside one shard of 96 / S rows, so the off-diagonal
    buckets are empty."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if block_diagonal:
        rows = 96 // S
        dst = (src // rows) * rows + rng.integers(0, rows, e)
        dst = np.minimum(dst, n - 1)
    w = rng.normal(size=e).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), w)
    return np.stack([src, dst]), w, dense


def padded(seed, n, d, npad=96):
    x = np.zeros((npad, d), np.float32)
    x[:n] = np.random.default_rng(seed).normal(size=(n, d))
    return x


GRAPHS = {"n96": (0, 96, 500, False), "n90": (1, 90, 400, False),
          "blockdiag": (2, 96, 300, True)}
SPMM_CASES = ([("n90", d, m) for d in (16, 40, 256) for m in ("auto", "pallas_bf16")]
              + [(name, 40, m) for name in ("n96", "blockdiag")
                 for m in ("auto", "pallas_bf16")])


def fixed_pairs(n, p=12, n_neg=16, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, k).astype(np.int64) for k in (p, p, n_neg, n_neg)]


def port_cfg(ct, npad):
    return dataclasses.replace(ct, N_nodes=npad)


def rank_spmm(comm, case):
    name, d, method = case
    seed, n, e, bd = GRAPHS[name]
    ei, w, _ = random_graph(seed, n, e, bd)
    g = tdg.build_dist_graph(ei, n, comm, w, rb=RB)
    x = torch.from_numpy(g.local_rows(padded(10 + d, n, d))).requires_grad_()
    ct = torch.from_numpy(g.local_rows(padded(20 + d, n, d)))
    before = dict(comm.counts)
    y = spmm(g, x, method)
    (y * ct).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), (
        comm.counts["skipped_buckets"] - before["skipped_buckets"])


def rank_masked(comm):
    ei, w, _ = random_graph(0, 96, 500)
    g = tdg.build_dist_graph(ei, 96, comm, w, rb=RB, with_edge_view=True)
    mask = (np.random.default_rng(7).random(ei.shape[1]) < 0.6).astype(np.float32)
    gm = tdg.masked_dist_graph(g, torch.from_numpy(mask))
    x = torch.from_numpy(g.local_rows(padded(8, 96, 32)))
    return (tdg.dist_spmm(gm, x).numpy(), tdg.dist_spmm(gm.transpose(), x).numpy(),
            gm.deg_in.numpy(), gm.deg_out.numpy())


def rank_take_rows(comm):
    g = tdg.build_dist_graph(np.stack([np.arange(90)] * 2), 90, comm, rb=RB)
    h = torch.from_numpy(g.local_rows(padded(3, 90, 8))).requires_grad_()
    idx = torch.tensor([0, 5, 17, 89, 33, 33, 60, 24])
    rows = tdg.dist_take_rows(g, h, idx)
    ct = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 8)).astype(np.float32))
    ((rows * ct).sum() / comm.world_size).backward()  # a term every rank computes whole
    return rows.detach().numpy(), h.grad.numpy()


def rank_edgewise(comm):
    g = tdg.build_dist_graph(np.stack([np.arange(90)] * 2), 90, comm, rb=RB)
    h = torch.from_numpy(g.local_rows(padded(6, 90, 16))).requires_grad_()
    pairs = [torch.from_numpy(p) for p in fixed_pairs(90)]
    loss, mrr = score_pairs_sharded(g, h, pairs)
    (loss / comm.world_size).backward()  # a term every rank computes whole
    return loss.item(), mrr.item(), h.grad.numpy()


def rank_step(comm, ct, arrays, init):
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct, comm, rb=RB)
    g = pd.graph
    state = params_from_jax(init["params"], port_cfg(ct, g.n_node_pad), init["stats"],
                            shard=comm.shard, n_shards=S)
    model = tloops._teacher_model(ct, SEED, state, g)
    model.train()
    x, y = torch.from_numpy(pd.x), torch.from_numpy(pd.y)
    mask = torch.from_numpy(pd.train_mask)
    pairs = [torch.from_numpy(p) for p in fixed_pairs(90)]
    loss, _ = tloops.teacher_step_grads(
        ct, model, g, x, y, mask,
        edgewise=lambda h: score_pairs_sharded(g, h, pairs))
    total = comm.all_reduce_sum_(loss.detach().clone()).item()
    return total, {k: p.grad.numpy() for k, p in model.named_parameters()}


def rank_train(comm, ct, arrays, init):
    pd = tds.prepare_sharded(tds.NodeData(**arrays), ct, comm, rb=RB)
    state = params_from_jax(init["params"], port_cfg(ct, pd.graph.n_node_pad),
                            init["stats"], shard=comm.shard, n_shards=S)
    view = tloops.final_agg_view(ct, pd)
    res = tloops.train_teacher(ct, pd, seed=SEED, epochs=3, init_state=state,
                               device="cpu")
    return {"records": res.records, "columns": res.columns, "view": view is not None,
            "state": {k: v.numpy() for k, v in res.state_dict.items()}}


def rank_program(comm, spec):
    """Everything the test file asks of the ranks, in one process group."""
    return {
        "spmm": {case: rank_spmm(comm, case) for case in SPMM_CASES},
        "masked": rank_masked(comm),
        "take_rows": rank_take_rows(comm),
        "edgewise": rank_edgewise(comm),
        "step": rank_step(comm, *spec["step"]),
        "train": {name: rank_train(comm, *args) for name, args in spec["train"].items()},
        "counts": dict(comm.counts),
    }
