"""The port's side of ``test_torch_port_distributed.py``: what each of its
spawned gloo ranks computes with ``parallel/distributed.py`` and
``parallel/tensor_parallel.py``, with the inputs it is built from.

A module of its own that imports no JAX, so that each spawned rank, which
imports the rank programs by name, starts in seconds. It holds no test."""
import numpy as np
import torch

from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.parallel import distributed as tdist
from gnn_tail_generalization_tpu_torch.parallel import tensor_parallel as ttp
from gnn_tail_generalization_tpu_torch.parallel.comm import Comm, gather_rows
from gnn_tail_generalization_tpu_torch.utils.convert import (dist_teacher_params,
                                                             teacher_2d_params)

S = 4
MESH_2D = (2, 2)  # (graph, model)
# name -> (seed, n, E, d): tests/test_distributed.py's SpMM sizes
# (n46 pads to 48 rows)
SPMM_GRAPHS = {"n64-d16": (0, 64, 400, 16), "n48-d8": (1, 48, 300, 8),
               "n40-d8": (2, 40, 250, 8), "n46-d12": (5, 46, 300, 12)}
# name -> (seed, n, features, hidden, classes, SE flags, lr, se_reg, steps):
# the JAX tests' teachers (test_dist_train_step_runs_and_learns, 15 steps;
# test_2d_train_step_runs_and_learns, 12 steps); n = 78 pads to 80 rows,
# whose SE rows enter the norm
TEACHERS_1D = {"se10": (3, 80, 12, 16, 3, (1, 0), 0.05, 0.01, 15),
               "se11": (3, 78, 12, 16, 3, (1, 1), 0.05, 0.01, 15)}
TEACHER_2D = (4, 64, 12, 16, 4, None, 0.05, 0.001, 12)
HELD_STEP = 5  # the parameters held to JAX after this many steps
# a ring order that is not the rank order, so that both collectives reorder
# shard order into the group's rank order and back
SHUFFLED_ORDER = [2, 0, 3, 1]


def random_graph(seed, n, e):
    """``tests/test_distributed.py:random_graph`` from a seed of its own."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])


def spmm_inputs(name, n_shards):
    """(edge_index, n, x, ct): x and the cotangent over the padded rows."""
    seed, n, e, d = SPMM_GRAPHS[name]
    npad = -(-n // n_shards) * n_shards
    rng = np.random.default_rng(seed + 100)
    return (random_graph(seed, n, e), n,
            rng.normal(size=(npad, d)).astype(np.float32),
            rng.normal(size=(npad, d)).astype(np.float32))


def teacher_inputs(case, n_shards):
    """(edge_index, n, batch): the JAX tests' teacher data (informative
    features, half the nodes in train), every array padded to
    ``n_shards``."""
    seed, n, n_feat, _, n_class = case[:5]
    rng = np.random.default_rng(seed)
    ei = tcore.standard_pipeline(random_graph(seed, n, 300), n)
    y = rng.integers(0, n_class, n)
    x = rng.normal(size=(n, n_feat)).astype(np.float32)
    x[np.arange(n), y] += 2.0
    dout, din = tcore.degrees(ei, n)
    npad = -(-n // n_shards) * n_shards
    batch = {k: tdist.pad_rows(v, npad) for k, v in (
        ("x", x), ("y", y.astype(np.int32)), ("train_mask", rng.random(n) < 0.5),
        ("deg_in", din), ("deg_out", dout))}
    return ei, n, batch


def _spmm_grad(fn, x, ct):
    x = x.clone().requires_grad_()
    y = fn(x)
    (y * ct).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def rank_spmm(comm, name, ring):
    ei, n, x, ct = spmm_inputs(name, comm.world_size)
    rows = x.shape[0] // comm.world_size
    mine = slice(comm.shard * rows, (comm.shard + 1) * rows)
    if ring:
        g = tdist.shard_graph_ring(ei, n, comm, device="cpu")
        fn = lambda t: tdist.dist_spmm_ring(g, t)  # noqa: E731
    else:
        sg = tdist.shard_graph(ei, n, comm.world_size, comm.shard, device="cpu")
        fn = lambda t: tdist.dist_spmm(sg, t, comm)  # noqa: E731
    return _spmm_grad(fn, torch.from_numpy(x[mine]), torch.from_numpy(ct[mine]))


def rank_gather_rows(world):
    """``gather_rows`` and its backward over a communicator whose shard
    order is ``SHUFFLED_ORDER``: (gathered, the input's gradient)."""
    comm = Comm(world.rank, world.world_size, "cpu", "gloo", order=SHUFFLED_ORDER)
    t = torch.full((3, 2), float(comm.shard)) + torch.arange(6.).view(3, 2) / 10
    t.requires_grad_()
    out = gather_rows(t, comm)
    ct = torch.arange(out.numel(), dtype=torch.float32).view_as(out) * (comm.shard + 1)
    (out * ct).sum().backward()
    return {"shard": comm.shard, "out": out.detach().numpy(), "grad": t.grad.numpy(),
            "counts": dict(comm.counts)}


def run_steps(step, params, batch, sg, steps):
    """The losses of ``steps`` SGD steps and the parameters after
    ``HELD_STEP``, as numpy."""
    losses, held = [], None
    for i in range(steps):
        params, loss = step(params, batch, sg)
        losses.append(loss.item())
        if i + 1 == HELD_STEP:
            held = {k: v.numpy() for k, v in params.items()}
    return {"losses": np.array(losses), "params": held}


def rank_teacher_1d(comm, case, init):
    seed, n, f, h, c, has_se, lr, se_reg, steps = case
    ei, n, batch = teacher_inputs(case, comm.world_size)
    sg = tdist.shard_graph(ei, n, comm.world_size, comm.shard, device="cpu")
    coords, sizes = {"graph": comm.shard}, {"graph": comm.world_size}
    b = tdist.local_slices(batch, tdist.batch_shardings(batch), coords, sizes, "cpu")
    params = dist_teacher_params(init, comm.shard, comm.world_size, device="cpu")
    _, grads = tdist.sharded_grads(
        params, lambda p: tdist.dist_teacher_loss(
            comm, sg, p, b["x"], b["y"], b["train_mask"], b["deg_in"], b["deg_out"],
            se_reg), tdist.param_shardings(params), comm)
    out = run_steps(tdist.make_dist_train_step(comm, lr, se_reg), params, b, sg, steps)
    out["grads"] = {k: v.numpy() for k, v in grads.items()}
    return out


def rank_teacher_2d(mesh, init):
    seed, n, f, h, c, _, lr, se_reg, steps = TEACHER_2D
    ei, n, batch = teacher_inputs(TEACHER_2D, MESH_2D[0])
    g = mesh.coords["graph"]
    sg = tdist.shard_graph(ei, n, MESH_2D[0], g, device="cpu")
    b = tdist.local_slices(batch, ttp.batch_shardings_2d(batch), mesh.coords, mesh.shape,
                           "cpu")
    params = teacher_2d_params(init, mesh.coords, mesh.shape, device="cpu")
    _, grads = tdist.sharded_grads(params, lambda p: ttp.loss_2d(mesh, sg, p, b, se_reg),
                                   ttp.param_shardings_2d(params), mesh.comm("graph"))
    out = run_steps(ttp.make_2d_train_step(mesh, lr, se_reg), params, b, sg, steps)
    out["grads"] = {k: v.numpy() for k, v in grads.items()}
    return out


def rank_program(world, spec):
    """Everything the test file asks of the ranks, in one process group."""
    mesh = ttp.make_2d_mesh(world, *MESH_2D)  # collective: every rank builds it
    out = {
        "shard": world.shard, "coords": mesh.coords,
        "spmm": {(name, ring): rank_spmm(world, name, ring)
                 for name in SPMM_GRAPHS for ring in (False, True)},
        "gather_rows": rank_gather_rows(world),
        "teacher_1d": {name: rank_teacher_1d(world, TEACHERS_1D[name], init)
                       for name, init in spec["teacher_1d"].items()},
        "teacher_2d": rank_teacher_2d(mesh, spec["teacher_2d"]),
    }
    out["counts"] = {"world": dict(world.counts),
                     **{a: dict(mesh.comm(a).counts) for a in mesh.names}}
    return out
