"""The pair-scoring op (``ops/pair_score.py``) and the route of the link
evaluation's scorer (``linkpred/model.py:predict_chunked``): on the CPU the
plain version against ``DotPredictor`` and against the chunked scoring it
replaces, the route each predictor, graph and dtype takes, the wrapper's
argument checks, the launch counter and what a forward hook on the
predictor sees; on the card the kernel against the plain version and a
float64 dot product, and a whole evaluation against the CPU's.

Imports neither JAX nor the JAX package, so the card's machine runs it:

    python -m pytest tests/test_torch_port_pair_score.py -m card --noconftest -q

Tolerances: on the CPU the route keeps today's arithmetic, so its outputs
are held bit for bit. On the card the kernel sums each dot product in
another order than torch (fmaf a lane, then a butterfly over the warp), so
it is held to 1e-6 of the largest |score| against the plain version, to
1e-5 of sum |h_s h_d| a pair against float64 (an f32 sum of d products
lies within d eps of that, and d <= 256 here), and to itself bit for bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.linkpred import model as tlpm
from gnn_tail_generalization_tpu_torch.linkpred import predictors as tpred
from gnn_tail_generalization_tpu_torch.ops import _build
from gnn_tail_generalization_tpu_torch.ops import pair_score as ps
from gnn_tail_generalization_tpu_torch.parallel.distgraph import ShardedGraph
from gnn_tail_generalization_tpu_torch.utils import debug

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
F, H = 12, 16  # feature and hidden widths


def table_and_pairs(n, d, m, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=gen)
    pairs = torch.randint(0, n, (m, 2), generator=gen)
    return h.to(device), pairs.to(device)


def grouped_pairs(pos, n, k, seed):
    """OGB's citation2 layout: each positive's source on ``k`` negatives."""
    gen = torch.Generator().manual_seed(seed)
    dst = torch.randint(0, n, (pos.shape[0] * k,), generator=gen)
    return torch.stack([pos[:, 0].repeat_interleave(k), dst], dim=1)


def model_and_table(n=300, predictor="DOT", hidden=H, **kw):
    """A link model (dropout 0) on a power-law graph, its eval-mode table and
    the graph's message edges [2, E]."""
    cfg = tlpm.LinkPredConfig(predictor=predictor, dropout=0.0, gnn_hidden_channels=hidden,
                              mlp_hidden_channels=hidden, emb_hidden_channels=hidden,
                              **kw)
    msg = tcore.symmetrize(fast_powerlaw_graph(n, 4 * n, 0), n)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(n, F)).astype(np.float32))
    model = tlpm.LinkPredModel(cfg, n, F, generator=torch.Generator().manual_seed(2))
    const = tlpm.link_const(cfg, tlpm.link_graph(cfg, msg, n), x)
    model.eval()
    with torch.no_grad():
        h = tlpm.encode_all(model, const)
    return cfg, model, const, h, msg


def chunked_before(model, h, edges, chunk):
    """``predict_chunked`` as it scored every predictor before the route:
    gathered rows a chunk, then the predictor."""
    edges = torch.as_tensor(edges).long()
    outs = [model.predict_pairs(h[e[:, 0]], h[e[:, 1]]) for e in torch.split(edges, chunk)]
    return torch.cat(outs)


@pytest.mark.parametrize("d", [16, 256, 33])
def test_plain_equals_dot_predictor_on_gathered_rows(d):
    h, pairs = table_and_pairs(500, d, 3000)
    want = tpred.DotPredictor()(h[pairs[:, 0]], h[pairs[:, 1]])
    assert torch.equal(ps.pair_dot_plain(h, pairs), want)
    assert torch.equal(ps.pair_dot_plain(h, pairs, chunk=7), want)
    assert torch.equal(tpred.DotPredictor()(h, pairs), want)  # the pairs form
    assert ps.pair_dot_plain(h, pairs[:0]).shape == (0,)


@pytest.mark.parametrize("predictor", ["DOT", "MLPCAT"])
@pytest.mark.parametrize("chunk", [7, 64, 1000, 5000])
def test_predict_chunked_keeps_todays_outputs(predictor, chunk):
    _, model, _, h, msg = model_and_table(predictor=predictor)
    edges = msg.T[:1000]  # a transposed view: not contiguous
    with torch.no_grad():
        got = tlpm.predict_chunked(model, h, edges, chunk=chunk)
        assert torch.equal(got, chunked_before(model, h, edges, chunk))


class _Stand:
    """A counting stand-in for ``pair_score.pair_dot``."""

    def __init__(self):
        self.calls, self.real = [], ps.pair_dot

    def __call__(self, h, pairs):
        self.calls.append(pairs.shape[0])
        return self.real(h, pairs)


class _Rows(ShardedGraph):
    """A stand-in for a rank's rows of a sharded graph."""


def test_route_dot_on_one_device_takes_the_pairs_forward(monkeypatch):
    stand = _Stand()
    monkeypatch.setattr(ps, "pair_dot", stand)
    _, model, _, h, msg = model_and_table()
    with torch.no_grad():
        out = tlpm.predict_chunked(model, h, msg.T[:1000], chunk=64)
    assert stand.calls == [1000] and out.shape == (1000,)


@pytest.mark.parametrize("case", ["BIL", "MLP", "sharded", "bf16"])
def test_route_other_cases_take_the_chunked_route(monkeypatch, case):
    stand = _Stand()
    monkeypatch.setattr(ps, "pair_dot", stand)
    took = []
    monkeypatch.setattr(tlpm, "dist_take_rows",
                        lambda g, h, idx: took.append(idx.numel()) or h[idx])
    _, model, _, h, msg = model_and_table(predictor="DOT" if case in ("sharded", "bf16")
                                          else case)
    g = _Rows() if case == "sharded" else None
    if case == "bf16":
        h = h.bfloat16()
    edges = msg.T[:1000]
    with torch.no_grad():
        out = tlpm.predict_chunked(model, h, edges, chunk=64, g=g)
        assert torch.equal(out, chunked_before(model, h, edges, 64))
    assert stand.calls == []
    assert (sum(took) == 2 * 1000) if case == "sharded" else not took


def test_wrapper_refuses_what_the_kernel_cannot_take():
    h, pairs = table_and_pairs(50, 8, 100)
    with pytest.raises(TypeError, match="float32 table"):
        ps.pair_dot(h.double(), pairs)
    with pytest.raises(TypeError, match="int64 pairs"):
        ps.pair_dot(h, pairs.int())
    with pytest.raises(ValueError, match=r"\[m, 2\]"):
        ps.pair_dot(h, torch.zeros(10, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ps.pair_dot(h, pairs.T.contiguous().T)  # [m, 2] with strides (1, m)
    with pytest.raises(ValueError, match="contiguous"):
        ps.pair_dot(h, pairs[::2])
    with pytest.raises(ValueError, match="contiguous"):
        ps.pair_dot(h.T.contiguous().T, pairs)
    with pytest.raises(ValueError, match="contiguous"):
        ps.pair_dot(h[0], pairs)
    with pytest.raises(RuntimeError, match="no backward"):
        ps.pair_dot(h.requires_grad_(), pairs)
    with torch.no_grad():
        assert ps.pair_dot(h, pairs).shape == (100,)
    with pytest.raises(ValueError, match="no pair-scoring kernel"):
        ps.pair_dot(h.detach().to("meta"), pairs.to("meta"))


def mrr_split(msg, n, k=20, n_pos=(60, 80), seed=0):
    """valid and test positives from the message edges, each with ``k``
    grouped negatives."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(msg.shape[1], sum(n_pos), replace=False)
    pos = torch.from_numpy(msg.T[pick].copy())
    split = {}
    for i, (s, p) in enumerate(zip(("valid", "test"), (pos[:n_pos[0]], pos[n_pos[0]:]))):
        split[s] = {"edge": p, "edge_neg": grouped_pairs(p, n, k, seed + 1 + i)}
    return split


def test_score_calls_counts_only_launches(tmp_path):
    """The plain version launches nothing and counts nothing: under a
    profile, an evaluation on the CPU leaves ``score.kernel_calls`` out."""
    cfg, model, const, _, msg = model_and_table(eval_metric="mrr")
    split = mrr_split(msg, 300)
    _build.reset_launch_counts()
    with debug.profile_trace(str(tmp_path)):
        tlpm.evaluate(cfg, model, const, split)
        rec = debug.recorded()
    assert "score.kernel_calls" not in rec["counters"]
    assert rec["spans"]["gnn.link.score"]["calls"] == 4
    assert _build.launch_counts("pair_dot") == {"pair_dot_f32": 0}


def test_forward_hook_sees_one_output_a_split():
    """The benchmark's check reads the scores through a global forward hook
    on the predictor's type: one output a split, in ``evaluate``'s order."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness.capture import EvalOutputs

    cfg, model, const, h, msg = model_and_table(eval_metric="mrr")
    split = mrr_split(msg, 300)
    with EvalOutputs(tpred.DotPredictor) as seen:
        tlpm.evaluate(cfg, model, const, split)
    parts = [split[s][k] for s in ("valid", "test") for k in ("edge", "edge_neg")]
    assert [o.shape[0] for o in seen.outputs] == [p.shape[0] for p in parts]
    for out, p in zip(seen.outputs, parts):
        assert torch.equal(out, chunked_before(model, h, p, 64 * 1024))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the pair-scoring kernel runs on a card only")
    return torch.device("cuda")


def exact_dot(h, pairs):
    """float64 dot products and sum |h_s h_d|, a pair."""
    a, b = h[pairs[:, 0]].double(), h[pairs[:, 1]].double()
    return (a * b).sum(-1), (a * b).abs().sum(-1)


def card_cases(n):
    """(name, pairs) on the host: grouped runs of 1,000 and of 7, one source
    repeated throughout, all sources distinct, row counts off every tile,
    one pair, none."""
    gen = torch.Generator().manual_seed(21)
    pos = torch.randint(0, n, (301, 2), generator=gen)
    yield "grouped 1000", grouped_pairs(pos, n, 1000, 22)
    yield "grouped 7 (unaligned)", grouped_pairs(pos, n, 7, 23)
    one = torch.randint(0, n, (70_001, 2), generator=gen)
    one[:, 0] = 17
    yield "one repeated source", one
    yield "all distinct sources", torch.stack(
        [torch.randperm(n, generator=gen), torch.randint(0, n, (n,), generator=gen)], dim=1)
    yield "33 pairs", torch.randint(0, n, (33, 2), generator=gen)
    yield "1 pair", torch.randint(0, n, (1, 2), generator=gen)
    yield "empty", torch.zeros(0, 2, dtype=torch.int64)


@pytest.mark.card
def test_kernel_refuses_pairs_off_the_16_byte_grid(card):
    h, pairs = table_and_pairs(50, 256, 100, device=card)
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte aligned"):
        ps.pair_dot(h, pairs.view(-1)[1:-1].view(-1, 2))


@pytest.mark.card
@pytest.mark.parametrize("d", [256, 40, 33])
def test_kernel_matches_plain_and_float64_on_the_card(card, d):
    n = 5000
    h_host = torch.randn(n, d, generator=torch.Generator().manual_seed(20))
    h = h_host.to(card)
    for name, p_host in card_cases(n):
        p = p_host.to(card)
        _build.reset_launch_counts()
        got = ps.pair_dot(h, p)
        assert _build.launch_counts("pair_dot") == {"pair_dot_f32": int(p.shape[0] > 0)}, name
        assert torch.equal(got, ps.pair_dot(h, p)), f"{name}: two launches differ"
        assert got.shape == (p.shape[0],) and got.dtype == torch.float32
        if not p.shape[0]:
            continue
        plain = ps.pair_dot_plain(h, p)
        scale = float(plain.abs().max())
        assert float((got - plain).abs().max()) <= 1e-6 * scale, name
        want, mag = exact_dot(h_host, p_host)
        err = (got.cpu().double() - want).abs()
        assert bool((err <= 1e-5 * mag).all()), (name, float((err / mag).max()))


@pytest.mark.card
def test_evaluate_on_the_card_equals_the_cpus(card, tmp_path):
    """A 5,000-node DOT model at width 256: the card's evaluation (B1 and
    the pair-scoring kernel) against the CPU's (the plain versions), with
    one kernel launch a split."""
    n = 5000
    cfg, model, const, _, msg = model_and_table(n=n, hidden=256, eval_metric="mrr")
    split = mrr_split(msg, n, k=1000, n_pos=(300, 300))
    want = tlpm.evaluate(cfg, model, const, split)["MRR"]
    model_c = model.to(card)
    const_c = tlpm.link_const(cfg, tlpm.link_graph(cfg, msg, n).to(card),
                              const["x"].to(card))
    split_c = {s: {k: v.to(card) for k, v in e.items()} for s, e in split.items()}
    _build.reset_launch_counts()
    with debug.profile_trace(str(tmp_path)):
        got = tlpm.evaluate(cfg, model_c, const_c, split_c)["MRR"]
        rec = debug.recorded()
    assert rec["counters"]["score.kernel_calls"] == 4
    assert _build.launch_counts("pair_dot") == {"pair_dot_f32": 4}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
