"""The CUDA SpMM kernels' row schedule (graph/core.py:build_schedule) and the
launch layout the wrappers pick (ops/spmm_kernels.py:lane_layout).

- The schedule covers every edge of every row exactly once, in CSR order
  (hypothesis over random row degrees, with empty graphs, empty rows, one
  row holding every edge and the degrees around the hub threshold).
- A plain emulation of the scheduled computation (light rows summed whole,
  hub rows as chunk partials added in chunk order) equals ``spmm_csr_plain``
  within f32 rounding (rtol = atol = 1e-5: the same products, summed in
  another order) and the JAX package's Pallas kernel in interpret mode
  (1e-4, as tests/test_spmm_pallas.py). The emulation lives here: nothing on
  the main path runs it; the CUDA kernels are held to the plain version on
  the card by chip_smoke.py.
- Every graph transform carries the schedule of its own CSR.
- ``profile_step.py`` puts every kernel the wrappers launch in its SpMM class.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gnn_tail_generalization_tpu.graph import core as jcore
from gnn_tail_generalization_tpu.ops import spmm_pallas as sp

from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.nn import graph_dropout as gd
from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

T = tcore.HUB_THRESHOLD


def covered_edges(indptr: np.ndarray, s: tcore.RowSchedule):
    """{row: [edge ids in the order the schedule sums them]}, and checks
    the schedule's own invariants on the way."""
    ip = np.asarray(indptr, np.int64)
    hubs = s.hub_rows.numpy()
    ptr = s.hub_chunk_ptr.numpy()
    bounds = s.chunk_bounds.numpy()
    assert s.hub_rows.dtype == s.hub_chunk_ptr.dtype == s.chunk_bounds.dtype == torch.int32
    assert np.all(np.diff(hubs) > 0)
    assert ptr[0] == 0 and ptr[-1] == s.n_chunks and np.all(np.diff(ptr) >= 2)
    light = np.setdiff1d(np.arange(len(ip) - 1), hubs)  # the light kernel's rows
    assert np.all(np.diff(ip)[light] <= s.threshold)
    rows = {int(r): list(range(ip[r], ip[r + 1])) for r in light}
    for h, r in enumerate(hubs):
        edges = []
        for c0, c1 in bounds[ptr[h]:ptr[h + 1]]:
            assert 0 < c1 - c0 <= s.threshold
            edges += list(range(c0, c1))
        rows[int(r)] = edges
    return rows


degrees = st.lists(
    st.one_of(st.integers(0, 20),
              st.sampled_from([0, T - 1, T, T + 1, 2 * T + 1])),
    min_size=0, max_size=24)


@settings(max_examples=200, deadline=None)
@given(degs=degrees, threshold=st.sampled_from([1, 2, 7, T]))
def test_schedule_covers_every_edge_once_in_csr_order(degs, threshold):
    indptr = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
    s = tcore.build_schedule(indptr, threshold)
    rows = covered_edges(indptr, s)
    assert sorted(rows) == list(range(len(degs)))
    for r, d in enumerate(degs):
        assert rows[r] == list(range(indptr[r], indptr[r] + d))  # once, in order
        assert (d > threshold) == (r in set(s.hub_rows.tolist()))


@pytest.mark.parametrize("degs", [[], [0, 0, 0], [3 * T + 5], [0, 3 * T + 5, 0],
                                  [T - 1, T, T + 1, 2 * T + 1]])
def test_schedule_edge_cases(degs):
    indptr = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
    s = tcore.build_schedule(indptr)
    rows = covered_edges(indptr, s)
    assert sum(len(v) for v in rows.values()) == indptr[-1]
    expect_chunks = sum(-(-d // T) for d in degs if d > T)
    assert s.n_chunks == expect_chunks and s.chunk_bounds.shape == (expect_chunks, 2)


def test_schedule_rejects_a_threshold_below_one():
    with pytest.raises(ValueError, match="threshold"):
        tcore.build_schedule(np.array([0, 1]), 0)


def emulate(g: tcore.Graph, x: torch.Tensor, s: tcore.RowSchedule, bf16=False):
    """The scheduled computation, written plainly: each light row summed in
    CSR order; each hub chunk into its own partial; each hub row the sum of
    its partials in chunk order."""
    if bf16:
        x = x.to(torch.bfloat16).float()
        w = g.weight.to(torch.bfloat16).float()
    else:
        w = g.weight
    ip, src = g.indptr.long(), g.indices.long()
    terms = w[:, None] * x[src]
    y = torch.zeros(g.indptr.numel() - 1, x.shape[1])
    hubs = set(s.hub_rows.tolist())
    for r in (r for r in range(g.indptr.numel() - 1) if r not in hubs):
        for e in range(ip[r], ip[r + 1]):
            y[r] += terms[e]
    partial = torch.zeros(s.n_chunks, x.shape[1])
    for c, (c0, c1) in enumerate(s.chunk_bounds.tolist()):
        for e in range(c0, c1):
            partial[c] += terms[e]
    ptr = s.hub_chunk_ptr.tolist()
    for h, r in enumerate(s.hub_rows.tolist()):
        for c in range(ptr[h], ptr[h + 1]):
            y[r] += partial[c]
    return y


def boundary_edges(rng, n, threshold):
    """Rows 0-5 of in-degree 0, T - 1, T, T + 1, 2T + 1 and 1, plus random
    edges into the other rows."""
    degs = [0, threshold - 1, threshold, threshold + 1, 2 * threshold + 1, 1]
    dst = np.concatenate([np.full(k, i) for i, k in enumerate(degs)])
    dst = np.concatenate([dst, rng.integers(len(degs), n, 3 * n)])
    src = rng.integers(0, n, dst.shape[0])
    w = rng.normal(size=dst.shape[0]).astype(np.float32)
    return np.stack([src, dst]), w


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("threshold,d", [(4, 48), (8, 256), (T, 16)])
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "transposed"])
def test_emulation_matches_plain_and_pallas_interpret(rng, threshold, d, bf16,
                                                      transposed):
    n = 40 if threshold < T else 1100
    ei, w = boundary_edges(rng, n, threshold)
    ei = np.concatenate([ei, ei[::-1]], axis=1)  # hub rows in both CSRs
    w = np.concatenate([w, -w])
    if transposed:
        ei = np.ascontiguousarray(ei[::-1])
    g = tcore.build_graph(ei, n, w, with_dense=False)
    s = tcore.build_schedule(g.indptr.numpy(), threshold)
    assert 0 < s.n_hub < n
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_e = emulate(g, torch.from_numpy(x), s, bf16)
    y_p = K.spmm_csr_plain(g.indptr, g.indices, g.weight, torch.from_numpy(x),
                           bf16=bf16)
    torch.testing.assert_close(y_e, y_p, rtol=1e-5, atol=1e-5)
    jg = jcore.build_graph(ei, n, edge_weight=w, with_dense=False)
    plan = sp.build_plan(np.asarray(jg.senders), np.asarray(jg.receivers),
                         np.asarray(jg.edge_weight), n, rb=8, eb=128)
    y_j = sp.spmm_via_plan(plan, jnp.asarray(x), interpret=True,
                           compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    np.testing.assert_allclose(y_e.numpy(), np.asarray(y_j), rtol=1e-4, atol=1e-4)


def assert_same_schedule(a: tcore.RowSchedule, b: tcore.RowSchedule):
    assert a.threshold == b.threshold
    for name in ("hub_rows", "hub_chunk_ptr", "chunk_bounds"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), name


def hub_graph(rng):
    ei, w = boundary_edges(rng, 700, T)
    return ei, w, tcore.build_graph(ei, 700, w, with_dense=False, with_plans=True)


def test_graph_carries_the_schedules_of_its_csrs(rng):
    ei, w, g = hub_graph(rng)
    assert g.schedule.n_chunks > 0
    assert_same_schedule(g.schedule, tcore.build_schedule(g.indptr.numpy()))
    assert_same_schedule(g.schedule_t, tcore.build_schedule(g.indptr_t.numpy()))
    gt = g.transpose()
    assert gt.schedule is g.schedule_t and gt.schedule_t is g.schedule
    assert gt.transpose().schedule is g.schedule


def test_graph_to_moves_the_schedules(rng):
    _, _, g = hub_graph(rng)
    m = g.to("meta")
    for s in (m.schedule, m.schedule_t):
        for name in ("hub_rows", "hub_chunk_ptr", "chunk_bounds"):
            assert getattr(s, name).device.type == "meta", name
    assert m.schedule.threshold == g.schedule.threshold
    assert m.schedule.n_chunks == g.schedule.n_chunks


def test_masked_and_loss_masked_graphs_keep_a_matching_schedule(rng):
    ei, w, g = hub_graph(rng)
    mask = (torch.rand(g.n_edge, generator=torch.Generator().manual_seed(0)) < 0.5
            ).float()
    mg = gd.masked_graph(g, mask)  # same CSR structure, weights masked
    assert torch.equal(mg.indptr, g.indptr)
    assert_same_schedule(mg.schedule, g.schedule)
    assert_same_schedule(mg.schedule_t, g.schedule_t)
    dst_mask = np.zeros(700, bool)
    dst_mask[[1, 3, 4, 10]] = True
    v = tcore.loss_masked_view(g, ei, dst_mask, w)
    assert_same_schedule(v.schedule, tcore.build_schedule(v.indptr.numpy()))
    assert_same_schedule(v.schedule_t, tcore.build_schedule(v.indptr_t.numpy()))
    assert v.schedule.n_hub == 2  # rows 3 and 4 keep their T + 1 and 2T + 1 edges


def test_wrapper_checks_the_schedule(rng):
    _, _, g = hub_graph(rng)
    other = tcore.build_schedule(np.array([0, 100, 200]))
    with pytest.raises(ValueError, match="schedule of 2 hub rows"):
        other.check(1, 200, g.indptr.device)
    with pytest.raises(ValueError, match="contiguous int32"):
        g.schedule.to("meta").check(g.n_node, g.n_edge, g.indptr.device)
    g.schedule.check(g.n_node, g.n_edge, g.indptr.device)
    # a CPU tensor runs the plain version whatever the schedule
    x = torch.from_numpy(rng.normal(size=(700, 8)).astype(np.float32))
    torch.testing.assert_close(
        K.spmm_csr_f32(g.indptr, g.indices, g.weight, x, g.schedule),
        K.spmm_csr_plain(g.indptr, g.indices, g.weight, x), rtol=0, atol=0)


@pytest.mark.parametrize("wrapper", ["spmm_csr_f32", "spmm_csr_bf16"])
def test_wrapper_refuses_the_schedule_of_another_csr(rng, wrapper):
    """A schedule records the row and edge counts of the CSR it was built
    from, and both routes of a wrapper refuse it with a CSR of other counts:
    the CUDA kernels would leave that CSR's hub rows unwritten. Two CSRs of
    one row count (a graph's forward CSR and a subgraph's), as a ring's
    buckets are."""
    ei, w, g = hub_graph(rng)
    sub = tcore.build_graph(ei[:, ::2], 700, w[::2], with_dense=False)
    assert sub.n_node == g.n_node and sub.n_edge != g.n_edge
    assert sub.schedule.n_rows == g.n_node and sub.schedule.n_edge == sub.n_edge
    x = torch.from_numpy(rng.normal(size=(700, 8)).astype(np.float32))
    fn = getattr(K, wrapper)
    with pytest.raises(ValueError, match="schedule built for a CSR of 700 rows"):
        fn(g.indptr, g.indices, g.weight, x, sub.schedule)
    with pytest.raises(ValueError, match="schedule built for a CSR"):
        g.schedule.check(g.n_node, sub.n_edge, g.indptr.device)
    torch.testing.assert_close(fn(sub.indptr, sub.indices, sub.weight, x, sub.schedule),
                               fn(sub.indptr, sub.indices, sub.weight, x),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::spmm_light_kernel<float, 4, 2>(int const*)", "spmm"),
    ("void (anonymous namespace)::spmm_hub_chunk_kernel<__nv_bfloat16, 8, 1>(int)", "spmm"),
    ("(anonymous namespace)::spmm_hub_reduce_kernel(float const*, float*)", "spmm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", "elementwise")])
def test_profile_step_counts_every_spmm_kernel_as_spmm(name, cls):
    import profile_step

    assert profile_step.op_class("kernel", name) == cls
