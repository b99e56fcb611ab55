"""The link Transformer's attention op (``ops/edge_attention.py``) against
the benchmark's plain reference of the configuration
(``benchmark/reference/i2gtl-citation2-transformer.py``: the attention over
blocks of whole destination rows, each under ``torch.utils.checkpoint``,
its gradients derived by autograd), and the CUDA kernels against the
plain version on the card.

Imports neither JAX nor the JAX package, so the card's machine runs it:

    python -m pytest tests/test_torch_port_linkpred_attention.py -m card --noconftest -q

Tolerances: forward 1e-5 relative with a floor of 1e-6 of the largest
entry; gradients 1e-4 relative with a floor of 1e-5 of the largest
entry, as ``test_torch_port_linkpred.py`` holds the encoders to JAX (the
two sum the same products in other orders). On the card the kernels sum
each dot product and each row statistic in another order than the plain
version, so they are held to 1e-5 of the largest entry, and to themselves
bit for bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization_tpu_torch.graph import core as tcore
from gnn_tail_generalization_tpu_torch.linkpred import encoders as tenc
from gnn_tail_generalization_tpu_torch.linkpred import model as tlpm
from gnn_tail_generalization_tpu_torch.ops import _build
from gnn_tail_generalization_tpu_torch.ops import edge_attention as ea
from gnn_tail_generalization_tpu_torch.utils import debug

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
SIZES = [300, 5000]
D = 16


def reference():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import spec

    return spec.load_module("reference", "i2gtl-citation2-transformer")


def link_graph(n, seed=0):
    msg = tcore.symmetrize(fast_powerlaw_graph(n, 4 * n, seed), n)
    return tlpm.link_graph(tlpm.LinkPredConfig(encoder="Transformer"), msg, n)


def ref_graph(g):
    """The reference's message graph of ``g``: its edges sorted by
    destination, sources ascending within a row."""
    return {"src": g.indices.long(), "dst": tcore.edge_rows(g.indptr, g.n_edge)}


def close(got, want, rtol, floor):
    want = want.detach()
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=floor * float(want.abs().max()))


def qkv(n, d=D, seed=1, scale=1.0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return [(scale * torch.randn(n, d, generator=gen)).to(device).requires_grad_()
            for _ in range(3)]


def op_and_grads(fn, q, k, v, r):
    out = fn(q, k, v)
    grads = torch.autograd.grad((out * r).sum(), (q, k, v))
    return out, grads


@pytest.mark.parametrize("n", SIZES)
def test_plain_op_matches_the_blockwise_reference(n):
    """Forward and the gradients of q, k and v; the reference in blocks of
    about n edges, so that the larger graph spans several blocks."""
    ref = reference()
    g = link_graph(n)
    rg = ref_graph(g)
    rg["blocks"] = ref.row_blocks(rg["dst"], n, block_edges=n)
    assert n < 1000 or len(rg["blocks"]) > 3
    q, k, v = qkv(n)
    r = torch.randn(n, D, generator=torch.Generator().manual_seed(2))
    _build.reset_launch_counts()
    out, grads = op_and_grads(lambda *t: ea.edge_attention(g, *t), q, k, v, r)
    assert _build.launch_counts("edge_attn_rows") == {"edge_attn_rows_f32": 0,
                                                      "edge_attn_rows_plain": 2}
    want, want_grads = op_and_grads(lambda *t: ref.attention(*t, rg), q, k, v, r)
    close(out, want, 1e-5, 1e-6)
    for got, w in zip(grads, want_grads):
        close(got, w, 1e-4, 1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_transformer_encoder_matches_the_reference_encode(n):
    """The port's two-layer Transformer encoder (dropout 0) holding the
    reference's parameters: its output and every parameter gradient."""
    ref = reference()
    g = link_graph(n, seed=3)
    enc = tenc.GNNEncoder("Transformer", D, D, D, 2, 0.0,
                          generator=torch.Generator().manual_seed(4))
    x = torch.randn(n, D, generator=torch.Generator().manual_seed(5))
    r = torch.randn(n, D, generator=torch.Generator().manual_seed(6))
    (enc(g, x) * r).sum().backward()
    p = {f"encoder.{k}": t.detach().clone().requires_grad_() for k, t in
         enc.state_dict().items()}
    p["node_emb"] = x
    h = ref.encode(p, ref_graph(g), 2, torch.matmul)
    (h * r).sum().backward()
    close(enc(g, x), h, 1e-5, 1e-6)
    # the floor is of the model's largest gradient: the key bias's is zero
    # but for rounding (a softmax is shift-invariant)
    top = max(float(t.grad.abs().max()) for t in enc.parameters())
    for name, t in enc.named_parameters():
        want = p[f"encoder.{name}"].grad
        np.testing.assert_allclose(t.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-5 * top,
                                   err_msg=name)


def edge_case_graph():
    """Rows with no in-edge, a hub row of 1,000 in-edges (over 10x the
    kernels' hub threshold of 64) and light rows, as a CSR."""
    n, hub = 1200, 5
    src = np.concatenate([np.arange(100, 1100), np.arange(200, 260), np.arange(300, 303),
                          [700]])
    dst = np.concatenate([np.full(1000, hub), np.full(60, 6), np.full(3, 7), [8]])
    assert tcore.HUB_THRESHOLD * 10 < 1000
    return tcore.build_graph(np.stack([src, dst]), n), n, hub


def attention64(g, q, k, v):
    """The attention in float64, row by row."""
    q, k, v = q.double(), k.double(), v.double()
    out = torch.zeros_like(v)
    ip = g.indptr.tolist()
    for r in range(g.n_node):
        s = g.indices[ip[r]:ip[r + 1]].long()
        if s.numel():
            a = torch.softmax(k[s] @ q[r] / q.shape[1] ** 0.5, dim=0)
            out[r] = a @ v[s]
    return out


@pytest.mark.parametrize("logit", [1.0, 80.0])
def test_empty_rows_hub_rows_and_large_logits(logit):
    """Rows with no in-edge give 0; the hub row and the light rows match a
    float64 softmax; logits of +-``logit`` (q and k scaled so that
    |q . k| / sqrt(d) reaches it) neither overflow nor lose a row."""
    g, n, hub = edge_case_graph()
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(n, D, generator=gen)
    k = torch.randn(n, D, generator=gen)
    v = torch.randn(n, D, generator=gen)
    s = (q[hub] @ k.T).abs().max() / D ** 0.5
    q = q * (logit / float(s))  # the hub row's largest |logit| is `logit`
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ea.edge_attention(g, q, k, v)
    assert torch.isfinite(out).all()
    deg = g.indptr[1:] - g.indptr[:-1]
    assert (out[deg == 0] == 0).all() and int((deg == 0).sum()) > 1000
    want = attention64(g, q.detach(), k.detach(), v.detach())
    close(out, want, 1e-5, 1e-6)
    alpha = ea.edge_attn_rows("softmax", g.indptr, g.indices, q.detach(), k.detach(), D ** -0.5)
    rows = tcore.edge_rows(g.indptr, g.n_edge)
    sums = torch.zeros(n, dtype=torch.float64).index_add(0, rows, alpha.double())
    assert torch.isfinite(alpha).all() and (alpha >= 0).all()
    np.testing.assert_allclose(sums[deg > 0].numpy(), 1.0, rtol=1e-6)
    r = torch.randn(n, D, generator=gen)
    gq, gk, gv = torch.autograd.grad((out * r).sum(), (q, k, v))
    assert all(torch.isfinite(t).all() for t in (gq, gk, gv))
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    w = torch.autograd.grad((attention64(g, q64, k64, v64) * r.double()).sum(),
                            (q64, k64, v64))
    # a logit of size L carries f32 rounding of L x 6e-8, and so does each
    # weight relative to itself: the gradients' floor scales with L
    for got, ww in zip((gq, gk, gv), w):
        close(got, ww.float(), 1e-4, 1e-5 * logit)


def test_op_records_its_spans_and_counter(tmp_path):
    """Under a profile: ``attn.calls`` one a forward, a ``gnn.attn`` span a
    forward and ``gnn.attn.backward`` a backward, the backward's aggregations
    counted in ``spmm.calls``."""
    g = link_graph(300)
    q, k, v = qkv(300)
    with debug.profile_trace(str(tmp_path)):
        ea.edge_attention(g, q, k, v).sum().backward()
        with torch.no_grad():
            ea.edge_attention(g, q, k, v)
        rec = debug.recorded()
    assert rec["counters"]["attn.calls"] == 2
    assert rec["counters"]["spmm.calls"] == 2 + 3
    assert rec["spans"]["gnn.attn"]["calls"] == 2
    assert rec["spans"]["gnn.attn.backward"]["calls"] == 1


def test_op_refuses_what_the_kernels_cannot_read():
    g = link_graph(300)
    q, k, v = qkv(300)
    with pytest.raises(ValueError, match="must be"):
        ea.edge_attention(g, q[:-1], k, v)
    with pytest.raises(ValueError, match="alpha"):
        ea.edge_attn_rows("grad", g.indptr, g.indices, q, k, 1.0)
    with pytest.raises(TypeError, match="float32"):
        ea.edge_attn_rows("softmax", g.indptr, g.indices, q.double(), k.double(), 1.0)
    with pytest.raises(ValueError, match="schedule"):
        ea.edge_attn_rows("softmax", g.indptr, g.indices, q, k, 1.0,
                          schedule=tcore.build_schedule(g.indptr_t[:-5].numpy()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the attention kernels run on a card only")
    return torch.device("cuda")


def powerlaw_with_hubs(n, seed):
    """A power-law graph whose largest rows are hub rows of thousands of
    edges, plus a star into node 0 and some rows with no in-edge."""
    e = fast_powerlaw_graph(n, 8 * n, seed)
    star = np.stack([np.arange(1, 5001), np.zeros(5000, np.int64)])
    e = tcore.symmetrize(np.concatenate([e, star], axis=1), n)
    e = e[:, e[1] % 97 != 3]  # rows with no in-edge
    return tcore.build_graph(e, n)


@pytest.mark.card
@pytest.mark.parametrize("d", [256, 40, 33])
def test_kernels_match_the_plain_version_on_the_card(card, d):
    """Forward and backward through the CUDA kernels against the plain
    version on the same graph; two launches give identical bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n = 60000
    g_host = powerlaw_with_hubs(n, 11)
    g = g_host.to(card)
    deg = g_host.indptr[1:] - g_host.indptr[:-1]
    assert int(deg.max()) > 10 * tcore.HUB_THRESHOLD and int((deg == 0).sum()) > 0
    q, k, v = qkv(n, d, seed=12, scale=2.0, device=card)
    r = torch.randn(n, d, generator=torch.Generator().manual_seed(13)).to(card)
    _build.reset_launch_counts()
    out, grads = op_and_grads(lambda *t: ea.edge_attention(g, *t), q, k, v, r)
    assert _build.launch_counts("edge_attn_rows") == {"edge_attn_rows_f32": 2,
                                                      "edge_attn_rows_plain": 0}
    out2, grads2 = op_and_grads(lambda *t: ea.edge_attention(g, *t), q, k, v, r)
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    a1 = ea.edge_attn_rows("softmax", g.indptr, g.indices, q.detach(), k.detach(), d ** -0.5,
                           schedule=g.schedule)
    a2 = ea.edge_attn_rows("softmax", g.indptr, g.indices, q.detach(), k.detach(), d ** -0.5)
    assert torch.equal(a1, a2)  # a schedule built from indptr is the graph's
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    want, want_grads = op_and_grads(lambda *t: ea.edge_attention(g_host, *t), qc, kc, vc,
                                    r.cpu())
    close(out, want, 1e-5, 1e-5)
    for got, w in zip(grads, want_grads):
        close(got, w, 1e-5, 1e-5)
    alpha_plain = ea.edge_attn_rows("softmax", g_host.indptr, g_host.indices, qc.detach(),
                                    kc.detach(), d ** -0.5)
    close(a1, alpha_plain, 1e-5, 1e-6)
