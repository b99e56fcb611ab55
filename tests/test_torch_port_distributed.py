"""The port's ``parallel/distributed.py`` and ``parallel/tensor_parallel.py``
against the JAX package's modules of those names.

JAX runs on 4 of the 8 fake CPU devices (``tests/conftest.py``), as
``tests/test_distributed.py`` and ``tests/test_tensor_parallel.py`` run it on
8; the port runs 4 gloo ranks on the CPU, spawned once (``ranks``; their
programs in ``test_torch_port_distributed_ranks.py``), so both pad the nodes
alike (``ceil(n / 4) * 4``; the 2-D mesh is graph 2 x model 2 on both). The
inputs come from numpy seeds at the JAX tests' sizes: SpMMs on n = 40-64
nodes and 250-400 edges at d = 8-16; the 1-D teacher at n = 80 and 78, 12
features, hidden 16, 3 classes, SE flags (1, 0) and (1, 1), 15 SGD steps
(lr 0.05, ``se_reg`` 0.01); the 2-D teacher at n = 64, 4 classes, 12 steps
(``se_reg`` 0.001). Both teachers start from the JAX package's own initial
parameters (``utils/convert.py:dist_teacher_params``, ``teacher_2d_params``).
Tolerances, with max |a - b| over max |b| as "relative":
- the SpMMs and their gradients: 1e-5 against JAX and against the dense
  product (f32; only the sum order differs);
- the teachers: every loss and every parameter after 5 steps 1e-4 against
  JAX; the first step's gradients 1e-4 against a dense float64 evaluation
  of the written-out function on one device (JAX matches it too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gnn_tail_generalization_tpu.parallel import distributed as jdist
from gnn_tail_generalization_tpu.parallel import tensor_parallel as jtp

from gnn_tail_generalization_tpu_torch.graph.core import edge_rows
from gnn_tail_generalization_tpu_torch.parallel import distributed as tdist
from gnn_tail_generalization_tpu_torch.parallel import launch
from gnn_tail_generalization_tpu_torch.parallel import tensor_parallel as ttp
from gnn_tail_generalization_tpu_torch.parallel.comm import Comm, gather_rows
from gnn_tail_generalization_tpu_torch.parallel.mesh import GRAPH_MODEL, DeviceMesh
from gnn_tail_generalization_tpu_torch.utils import convert

from test_torch_port_distributed_ranks import (HELD_STEP, MESH_2D, S, SHUFFLED_ORDER,
                                               SPMM_GRAPHS, TEACHER_2D, TEACHERS_1D,
                                               rank_program, spmm_inputs,
                                               teacher_inputs)

REL = 1e-5
TEACHER_REL = 1e-4


def rel_err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def jmesh():
    return jdist.make_graph_mesh(S)


def jbatch(mesh, batch, spec_of):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec_of(v)))
            for k, v in batch.items()}


def row_spec(v):
    return P("graph", None) if v.ndim == 2 else P("graph")


def jax_steps(step, params, batch, sg, steps):
    losses, held = [], None
    for i in range(steps):
        params, loss = step(params, batch, sg)
        losses.append(float(loss))
        if i + 1 == HELD_STEP:
            held = {k: np.asarray(v) for k, v in params.items()}
    return {"losses": np.array(losses), "params": held}


@pytest.fixture(scope="module")
def jax_teachers():
    """Per teacher: the JAX initial parameters (numpy) and its run."""
    out = {}
    mesh = jmesh()
    for name, case in TEACHERS_1D.items():
        seed, n, f, h, c, has_se, lr, se_reg, steps = case
        ei, n, batch = teacher_inputs(case, S)
        sg = jdist.shard_graph(ei, n, S)
        params = jdist.init_dist_teacher(jax.random.PRNGKey(seed), sg.n_node_pad, f, h, c,
                                         has_se=has_se)
        init = {k: np.asarray(v) for k, v in params.items()}
        params = jax.tree.map(jax.device_put, params, jdist.param_shardings(mesh, params))
        run = jax_steps(jdist.make_dist_train_step(mesh, lr=lr, se_reg=se_reg), params,
                        jbatch(mesh, batch, row_spec), sg, steps)
        out[name] = (init, run)
    seed, n, f, h, c, _, lr, se_reg, steps = TEACHER_2D
    ei, n, batch = teacher_inputs(TEACHER_2D, MESH_2D[0])
    mesh2 = jtp.make_2d_mesh(*MESH_2D)
    sg = jdist.shard_graph(ei, n, MESH_2D[0])
    params = jtp.init_2d_teacher(jax.random.PRNGKey(seed), sg.n_node_pad, f, h, c)
    init = {k: np.asarray(v) for k, v in params.items()}
    psh = jtp.param_shardings_2d(mesh2, params)
    params = {k: jax.device_put(v, psh[k]) for k, v in params.items()}
    bsh = jtp.batch_shardings_2d(mesh2, batch)
    batch = {k: jax.device_put(jnp.asarray(v), bsh[k]) for k, v in batch.items()}
    out["2d"] = (init, jax_steps(jtp.make_2d_train_step(mesh2, lr=lr, se_reg=se_reg),
                                 params, batch, sg, steps))
    return out


@pytest.fixture(scope="module")
def ranks(jax_teachers):
    """The port's 4 gloo ranks, spawned once: rank r's ``rank_program``."""
    spec = {"teacher_1d": {name: jax_teachers[name][0] for name in TEACHERS_1D},
            "teacher_2d": jax_teachers["2d"][0]}
    return launch.spawn(rank_program, S, "gloo", "cpu", spec, timeout=600)


def by_shard(ranks):
    return sorted(ranks, key=lambda r: r["shard"])


def assemble(ranks, pick, specs, sizes):
    """Whole arrays from the ranks' blocks (``pick(rank)``: name -> block),
    each block put where its rank's coordinates place it; the ranks that
    hold the same block must agree bit for bit."""
    out = {}
    for name, spec in specs.items():
        blocks = [(r["coords"], pick(r)[name]) for r in ranks]
        first = blocks[0][1]
        spec = tuple(spec) + (None,) * (first.ndim - len(spec))
        shape = [first.shape[d] * (sizes[a] if a else 1) for d, a in enumerate(spec)]
        whole = np.full(shape, np.nan, np.float32)
        for coords, b in blocks:
            idx = tuple(slice(coords[a] * b.shape[d], (coords[a] + 1) * b.shape[d])
                        if a else slice(None) for d, a in enumerate(spec))
            have = whole[idx]
            assert np.isnan(have).all() or np.array_equal(have, b), name
            whole[idx] = b
        out[name] = whole
    return out


def graph_coords(ranks):
    """The 1-D runs' ranks with their graph coordinate as ``coords``."""
    return [dict(r, coords={"graph": r["shard"]}) for r in ranks]


# ---------------------------------------------------------------------------
# the SpMMs
# ---------------------------------------------------------------------------


def dense_adj(ei, npad):
    a = np.zeros((npad, npad), np.float64)
    np.add.at(a, (ei[1], ei[0]), 1.0)
    return a


@pytest.mark.parametrize("ring", [False, True], ids=["all-gather", "ring"])
@pytest.mark.parametrize("name", list(SPMM_GRAPHS))
def test_dist_spmm_and_its_gradient_match_jax_and_dense(ranks, name, ring):
    """``dist_spmm`` (all-gather, reduce-scatter backward) and
    ``dist_spmm_ring``: y and dx, gathered over the ranks, against the JAX
    function of the same name on 4 devices and the dense product."""
    ei, n, x, ct = spmm_inputs(name, S)
    mesh = jmesh()
    sh = NamedSharding(mesh, P("graph", None))
    if ring:
        jg = jdist.shard_graph_ring(ei, n, S)
        jf = jax.jit(lambda t: jdist.dist_spmm_ring(mesh, jg, t))
    else:
        jg = jdist.shard_graph(ei, n, S)
        jf = lambda t: jdist.dist_spmm(mesh, jg, t)  # noqa: E731
    xd = jax.device_put(jnp.asarray(x), sh)
    y_j = np.asarray(jf(xd))
    dx_j = np.asarray(jax.jit(jax.grad(lambda t: jnp.vdot(jf(t), jnp.asarray(ct))))(xd))
    rs = by_shard(ranks)
    y = np.concatenate([r["spmm"][(name, ring)][0] for r in rs])
    dx = np.concatenate([r["spmm"][(name, ring)][1] for r in rs])
    a = dense_adj(ei, x.shape[0])
    for got, jax_v, dense in ((y, y_j, a @ x), (dx, dx_j, a.T @ ct)):
        assert rel_err(got, jax_v) <= REL
        assert rel_err(got, dense) <= REL


@pytest.mark.parametrize("name", list(SPMM_GRAPHS))
def test_shard_graph_ring_buckets_hold_the_jax_buckets_edges(name):
    """Each rank's forward bucket (k, j) holds, as a multiset, the non-padding
    entries of JAX's ``[S, S, E_b]`` bucket (k, j): (local dst, local src,
    weight); the orders differ."""
    ei, n, _, _ = spmm_inputs(name, S)
    jg = jdist.shard_graph_ring(ei, n, S)
    sl, rl, w = (np.asarray(a) for a in (jg.senders_local, jg.receivers_local,
                                          jg.edge_weight))
    for k in range(S):
        g = tdist.shard_graph_ring(ei, n, Comm(k, S, "cpu", "gloo"), device="cpu")
        assert (g.n_node_pad, g.rows_per_shard) == (jg.n_node_pad, jg.rows_per_shard)
        for j, b in enumerate(g.buckets):
            real = w[k, j] != 0  # unit weights: padding has weight 0
            want = sorted(zip(rl[k, j][real].tolist(), sl[k, j][real].tolist(),
                              w[k, j][real].tolist()))
            got = sorted(zip(edge_rows(b.indptr, b.n_edge).tolist(),
                             b.indices.tolist(), b.weight.tolist()))
            assert got == want, (k, j)


def test_shard_graph_pads_and_cuts_as_jax():
    """Every shard's CSR holds JAX's non-padding edges of that shard (global
    sources, local rows), and the transposed CSR the same edges."""
    ei, n, _, _ = spmm_inputs("n48-d8", S)
    jg = jdist.shard_graph(ei, n, S)
    snd, rcv, w = (np.asarray(a) for a in (jg.senders, jg.receivers_local,
                                            jg.edge_weight))
    for k in range(S):
        sg = tdist.shard_graph(ei, n, S, k, device="cpu")
        assert (sg.n_node_pad, sg.rows_per_shard) == (jg.n_node_pad, jg.rows_per_shard)
        real = w[k] != 0
        want = sorted(zip(rcv[k][real].tolist(), snd[k][real].tolist()))
        got = sorted(zip(edge_rows(sg.indptr, sg.n_edge).tolist(), sg.indices.tolist()))
        got_t = sorted(zip(sg.indices_t.tolist(),
                           edge_rows(sg.indptr_t, sg.n_edge).tolist()))
        assert got == want and got_t == want, k


def test_gather_rows_and_reduce_scatter_match_one_process(ranks):
    """``gather_rows`` over a communicator whose shard order is not the rank
    order stacks the blocks in shard order, and its backward
    (``reduce_scatter_sum``) gives each shard the sum over the ranks of its
    rows of the cotangents, as one process computes them."""
    rs = sorted((r["gather_rows"] for r in ranks), key=lambda g: g["shard"])
    assert [g["shard"] for g in rs] == [0, 1, 2, 3]
    assert sorted(r["shard"] for r in ranks) == [0, 1, 2, 3]
    blocks = [np.full((3, 2), float(s)) + np.arange(6.).reshape(3, 2) / 10 for s in range(S)]
    whole = np.concatenate(blocks).astype(np.float32)
    cts = [np.arange(24, dtype=np.float32).reshape(12, 2) * (s + 1) for s in range(S)]
    total = sum(cts)
    for s, g in enumerate(rs):
        np.testing.assert_array_equal(g["out"], whole)
        np.testing.assert_array_equal(g["grad"], total[3 * s: 3 * s + 3])
        assert g["counts"]["all_gathers"] == 1 and g["counts"]["reduce_scatters"] == 1
    assert SHUFFLED_ORDER != sorted(SHUFFLED_ORDER)


def test_one_rank_gathers_nothing():
    """At S = 1 the gather is the identity and no collective runs."""
    one = Comm(0, 1, "cpu", "gloo")
    t = torch.randn(5, 3, requires_grad=True)
    out = gather_rows(t, one)
    out.backward(torch.ones_like(out))
    assert out is t and torch.equal(one.reduce_scatter_sum(t.detach()), t.detach())
    assert one.counts["all_gathers"] == one.counts["reduce_scatters"] == 0


# ---------------------------------------------------------------------------
# the teachers
# ---------------------------------------------------------------------------


def dense_loss(p, a, batch, se_reg, two_d):
    """The written-out function of JAX's step on one device, float64:
    ``distributed.py:dist_teacher_loss`` or ``tensor_parallel.py``'s body."""
    t = {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in batch.items()}
    out_s = (t["deg_out"].clamp(min=1) ** -0.5)[:, None]
    in_s = (t["deg_in"].clamp(min=1) ** -0.5)[:, None]
    h = (t["x"] * out_s) @ p["w0"] + p["se0"]
    h = torch.relu((a @ h) * in_s + p["b0"])
    if two_d:
        logits = (a @ (h @ p["w1"] + p["b1"])) * in_s
    else:
        h = (h * out_s) @ p["w1"]
        if "se1" in p:
            h = h + p["se1"]
        logits = (a @ h) * in_s + p["b1"]
    lsm = torch.log_softmax(logits, 1)
    picked = lsm.gather(1, t["y"].long()[:, None])[:, 0]
    m = t["train_mask"]
    loss = -(picked * m).sum() / m.sum().clamp(min=1)
    for k in ("se0", "se1"):
        if k in p:
            loss = loss + se_reg * torch.linalg.norm(p[k])
    return loss


def dense_grads(init, ei, batch, se_reg, two_d):
    p = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
         for k, v in init.items()}
    a = torch.as_tensor(dense_adj(ei, batch["x"].shape[0]))
    dense_loss(p, a, batch, se_reg, two_d).backward()
    return {k: v.grad.numpy() for k, v in p.items()}


def check_teacher(got, jax_run, whole, label):
    assert np.isfinite(got["losses"]).all()
    assert rel_err(got["losses"], jax_run["losses"]) <= TEACHER_REL, label
    for k, v in whole.items():
        assert rel_err(v, jax_run["params"][k]) <= TEACHER_REL, (label, k)
    assert got["losses"][-1] < got["losses"][0], label  # the JAX tests' "learns"


@pytest.mark.parametrize("name", list(TEACHERS_1D))
def test_dist_train_step_matches_jax(jax_teachers, ranks, name):
    """``make_dist_train_step`` from JAX's initial parameters: every loss of
    15 SGD steps and every parameter after 5 against JAX's step, and the loss
    falls."""
    init, jax_run = jax_teachers[name]
    rs = graph_coords(ranks)
    specs = tdist.param_shardings(init)
    losses = [r["teacher_1d"][name]["losses"] for r in rs]
    assert all(np.array_equal(v, losses[0]) for v in losses[1:])
    whole = assemble(rs, lambda r: r["teacher_1d"][name]["params"], specs, {"graph": S})
    check_teacher(rs[0]["teacher_1d"][name], jax_run, whole, name)


@pytest.mark.parametrize("name", list(TEACHERS_1D))
def test_dist_first_gradient_matches_dense_float64(jax_teachers, ranks, name):
    init, _ = jax_teachers[name]
    case = TEACHERS_1D[name]
    ei, _, batch = teacher_inputs(case, S)
    want = dense_grads(init, ei, batch, case[7], two_d=False)
    rs = graph_coords(ranks)
    got = assemble(rs, lambda r: r["teacher_1d"][name]["grads"],
                   tdist.param_shardings(init), {"graph": S})
    for k in want:
        assert rel_err(got[k], want[k]) <= TEACHER_REL, k


def test_2d_train_step_matches_jax(jax_teachers, ranks):
    """``make_2d_train_step`` on graph 2 x model 2 from JAX's initial
    parameters: every loss of 12 steps and every parameter (assembled from
    the ranks' blocks) after 5 against JAX's 2-D step; the loss falls."""
    init, jax_run = jax_teachers["2d"]
    sizes = dict(zip(("graph", "model"), MESH_2D))
    losses = [r["teacher_2d"]["losses"] for r in ranks]
    assert all(np.array_equal(v, losses[0]) for v in losses[1:])
    whole = assemble(ranks, lambda r: r["teacher_2d"]["params"],
                     ttp.param_shardings_2d(init), sizes)
    check_teacher(ranks[0]["teacher_2d"], jax_run, whole, "2d")


def test_2d_first_gradient_matches_dense_float64(jax_teachers, ranks):
    init, _ = jax_teachers["2d"]
    ei, _, batch = teacher_inputs(TEACHER_2D, MESH_2D[0])
    want = dense_grads(init, ei, batch, TEACHER_2D[7], two_d=True)
    got = assemble(ranks, lambda r: r["teacher_2d"]["grads"],
                   ttp.param_shardings_2d(init), dict(zip(("graph", "model"), MESH_2D)))
    for k in want:
        assert rel_err(got[k], want[k]) <= TEACHER_REL, k


def test_sharding_specs_match_jax():
    """``param_shardings``, ``param_shardings_2d`` and the batch specs name
    the axes JAX's ``NamedSharding``s do, dimension by dimension."""
    mesh, mesh2 = jmesh(), jtp.make_2d_mesh(*MESH_2D)
    params = jdist.init_dist_teacher(jax.random.PRNGKey(0), 64, 8, 16, 4, has_se=(1, 1))
    params2 = jtp.init_2d_teacher(jax.random.PRNGKey(0), 64, 8, 16, 4)
    batch = teacher_inputs(TEACHER_2D, 2)[2]
    for got, want in ((tdist.param_shardings(params), jdist.param_shardings(mesh, params)),
                      (ttp.param_shardings_2d(params2),
                       jtp.param_shardings_2d(mesh2, params2)),
                      (ttp.batch_shardings_2d(batch), jtp.batch_shardings_2d(mesh2, batch))):
        assert {k: tuple(v.spec) for k, v in want.items()} == got
    assert ttp.param_shardings_2d(params2)["se0"] == ("graph", "model")
    assert ttp.param_shardings_2d(params2)["w1"] == ("model", None)


def test_port_init_has_the_jax_layout():
    """The port's initial parameters: JAX's names, shapes and kinds (zero
    biases, xavier-uniform weights inside their bound)."""
    j = jdist.init_dist_teacher(jax.random.PRNGKey(0), 64, 8, 16, 4, has_se=(1, 1))
    t = tdist.init_dist_teacher(0, 64, 8, 16, 4, has_se=(1, 1))
    j2 = jtp.init_2d_teacher(jax.random.PRNGKey(0), 64, 8, 16, 4)
    t2 = ttp.init_2d_teacher(0, 64, 8, 16, 4)
    for jp, tp in ((j, t), (j2, t2)):
        assert {k: v.shape for k, v in tp.items()} == {k: tuple(v.shape) for k, v in jp.items()}
        assert all(v.dtype == np.float32 for v in tp.values())
        assert not tp["b0"].any() and not tp["b1"].any()
        assert np.abs(tp["w0"]).max() <= np.sqrt(6 / (8 + 16))


def test_ranks_counted_their_collectives(ranks):
    """Every rank of an axis ran the same collectives, and the reduce-scatter
    ran (the all-gather SpMM's backward)."""
    for axis in ("world", "graph", "model"):
        got = [{k: v for k, v in r["counts"][axis].items() if k != "skipped_buckets"}
               for r in ranks]
        assert all(g == got[0] for g in got), (axis, got)
    assert ranks[0]["counts"]["world"]["reduce_scatters"] > 0
    assert ranks[0]["counts"]["graph"]["reduce_scatters"] > 0
    assert ranks[0]["counts"]["model"]["all_reduces"] > 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Called with no device, the graph builds and the parameter and batch
    cuts raise where torch finds no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ei, n, batch = teacher_inputs(TEACHER_2D, 2)
    params = tdist.init_dist_teacher(0, 64, 12, 16, 4)
    calls = (lambda: tdist.shard_graph(ei, n, 2, 0),
             lambda: tdist.shard_graph_ring(ei, n, Comm(0, 2, "cpu", "gloo")),
             lambda: tdist.local_slices(batch, tdist.batch_shardings(batch),
                                        {"graph": 0}, {"graph": 2}),
             lambda: convert.dist_teacher_params(params, 0, 2),
             lambda: convert.teacher_2d_params(ttp.init_2d_teacher(0, 64, 12, 16, 4),
                                               {"graph": 0, "model": 0},
                                               {"graph": 2, "model": 2}))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_one_rank_step_is_the_dense_function():
    """At S = 1 (no collective) one 1-D step's loss is the dense float64
    loss of the same parameters, and the 2-D step on a 1 x 1 mesh likewise."""
    one = Comm(0, 1, "cpu", "gloo")
    case = TEACHERS_1D["se11"]
    ei, n, batch = teacher_inputs(case, 1)
    init = tdist.init_dist_teacher(1, n, 12, 16, 3, has_se=(1, 1))
    sg = tdist.shard_graph(ei, n, 1, 0, device="cpu")
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    params = convert.dist_teacher_params(init, 0, 1, device="cpu")
    _, loss = tdist.make_dist_train_step(one, 0.05, 0.01)(params, b, sg)
    p64 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in init.items()}
    a = torch.as_tensor(dense_adj(ei, n))
    assert rel_err(loss.item(), dense_loss(p64, a, batch, 0.01, False).item()) <= REL
    mesh = DeviceMesh(one, (1, 1), GRAPH_MODEL)
    init2 = ttp.init_2d_teacher(1, n, 12, 16, 3)
    params2 = convert.teacher_2d_params(init2, mesh.coords, mesh.shape, device="cpu")
    _, loss2 = ttp.make_2d_train_step(mesh, 0.05, 0.001)(params2, b, sg)
    p64 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in init2.items()}
    assert rel_err(loss2.item(), dense_loss(p64, a, batch, 0.001, True).item()) <= REL


def test_bf16_is_refused():
    """The bespoke paths compute in f32, as JAX's ``segment_sum``: a bf16
    method raises instead of rounding."""
    ei, n, x, _ = spmm_inputs("n46-d12", 1)
    sg = tdist.shard_graph(ei, n, 1, 0, device="cpu")
    with pytest.raises(ValueError, match="f32"):
        tdist.dist_spmm(sg, torch.from_numpy(x), Comm(0, 1, "cpu", "gloo"), "pallas_bf16")
