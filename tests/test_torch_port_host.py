"""The PyTorch port's host-side code against the JAX package's: config chain,
synthetic generators, edge pipeline, degree analysis, CSR and degrees, GCN
weights and link prediction's host parts (edge keys, the non-edge sampler,
the membership table, surgery, heuristics, cal_recall) — exact equality —
and a subprocess proving the port imports no JAX."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.data import synthetic as jsyn
from gnn_tail_generalization_tpu.graph import analysis as jan
from gnn_tail_generalization_tpu.graph import core as jcore

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.data import synthetic as tsyn
from gnn_tail_generalization_tpu_torch.graph import analysis as tan
from gnn_tail_generalization_tpu_torch.graph import core as tcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_fields(a, b):
    """Every field of two dataclass instances is equal (arrays exactly)."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("dataset", sorted(jcfg._DATASET_PRESETS))
def test_build_config_matches(dataset):
    j = jcfg.build_config(dataset=dataset, train_which="TeacherGNN")
    t = tcfg.build_config(dataset=dataset, train_which="TeacherGNN")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_arxiv_best_config_is_initial_branch():
    cfg = tcfg.build_config(dataset="ogbn-arxiv", train_which="TeacherGNN")
    assert (cfg.type_trick, cfg.num_layers, cfg.dim_hidden) == (
        "InitialBatchNorm", 2, 256)
    assert (cfg.dropout, cfg.weight_decay) == (0.1, 0.0)


def test_synthetic_generators_match():
    np.testing.assert_array_equal(tsyn.fast_powerlaw_graph(500, 3000, 3),
                                  jsyn.fast_powerlaw_graph(500, 3000, 3))
    for a, b in zip(tsyn.synthetic_features_labels(200, 16, 5, 1),
                    jsyn.synthetic_features_labels(200, 16, 5, 1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_node", [300, 20_500])  # both generator branches
def test_synthetic_planetoid_matches(n_node):
    kw = dict(n_node=n_node, n_feat=24, n_class=4, seed=2, name="synthetic-x")
    assert_same_fields(tsyn.synthetic_planetoid(**kw),
                       jsyn.synthetic_planetoid(**kw))


@pytest.mark.parametrize("special", [True, False])
def test_pipeline_and_degree_analysis_match(rng, special):
    n = 400
    e = np.stack([rng.integers(0, n, 1500), rng.integers(0, n, 1500)])
    ej, et = jcore.standard_pipeline(e, n), tcore.standard_pipeline(e, n)
    np.testing.assert_array_equal(et, ej)
    sj, st = jan.degree_splits(n, ej, special), tan.degree_splits(n, et, special)
    assert_same_fields(st, sj)
    if special:
        for a, b in zip(tan.craft_isolation(et, st.zero_deg_mask),
                        jan.craft_isolation(ej, sj.zero_deg_mask)):
            np.testing.assert_array_equal(a, b)


def _rows(indptr):
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr.numpy()))


def assert_csr_matches(tg, jg):
    """The port's CSR pair holds exactly the JAX Graph's real (unpadded)
    edges in the same order, with the same degrees."""
    e = jg.n_edge
    assert (tg.n_node, tg.n_edge) == (jg.n_node, e)
    assert tg.indptr.dtype == tg.indices.dtype == torch.int32
    np.testing.assert_array_equal(tg.indices.numpy(), np.asarray(jg.senders)[:e])
    np.testing.assert_array_equal(_rows(tg.indptr), np.asarray(jg.receivers)[:e])
    np.testing.assert_array_equal(tg.weight.numpy(), np.asarray(jg.edge_weight)[:e])
    np.testing.assert_array_equal(tg.indices_t.numpy(), np.asarray(jg.senders_t)[:e])
    np.testing.assert_array_equal(_rows(tg.indptr_t), np.asarray(jg.receivers_t)[:e])
    np.testing.assert_array_equal(tg.weight_t.numpy(),
                                  np.asarray(jg.edge_weight_t)[:e])
    np.testing.assert_array_equal(tg.deg_out.numpy(), np.asarray(jg.deg_out))
    np.testing.assert_array_equal(tg.deg_in.numpy(), np.asarray(jg.deg_in))
    if jg.dense_adj is None:
        assert tg.dense_adj is None
    else:
        np.testing.assert_array_equal(tg.dense_adj.numpy(), np.asarray(jg.dense_adj))


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_matches_jax_graph(rng, weighted):
    n = 150
    e = jcore.standard_pipeline(
        np.stack([rng.integers(0, n, 600), rng.integers(0, n, 600)]), n)
    w = rng.normal(size=e.shape[1]).astype(np.float32) if weighted else None
    assert_csr_matches(tcore.build_graph(e, n, w), jcore.build_graph(e, n, w))
    tg = tcore.build_graph(e, n, w, with_dense=False)
    assert tg.dense_adj is None
    tt = tg.transpose()
    assert torch.equal(tt.indptr, tg.indptr_t) and torch.equal(tt.deg_in, tg.deg_out)


def test_loss_masked_view_matches(rng):
    n = 120
    e = jcore.standard_pipeline(
        np.stack([rng.integers(0, n, 500), rng.integers(0, n, 500)]), n)
    mask = rng.random(n) < 0.3
    jg, tg = jcore.build_graph(e, n), tcore.build_graph(e, n)
    jv = jcore.loss_masked_view(jg, e, mask)
    tv = tcore.loss_masked_view(tg, e, mask)
    assert_csr_matches(tv, jv)
    assert tv.n_edge < tg.n_edge
    assert torch.equal(tv.deg_in, tg.deg_in)  # the full graph's degrees
    # rows outside the mask hold no edges
    counts = np.diff(tv.indptr.numpy())
    assert (counts[~mask] == 0).all()


def test_prepare_matches(rng):
    n = 300
    data = jsyn.synthetic_planetoid(n_node=n, n_feat=20, n_class=4, seed=5)
    cfg = tcfg.build_config(dataset="", train_which="TeacherGNN")
    tdata = tds.NodeData(**dataclasses.asdict(data))
    tp = tds.prepare(tdata, cfg, spmm_dense_threshold=64)
    jp = jds.prepare(data, jcfg.build_config(dataset="", train_which="TeacherGNN"),
                     spmm_dense_threshold=64)
    for f in dataclasses.fields(tds.PreparedData):
        if f.name == "splits":
            assert_same_fields(tp.splits, jp.splits)
        elif f.name == "graph":
            assert_csr_matches(tp.graph, jp.graph)
        elif getattr(jp, f.name) is None:
            assert getattr(tp, f.name) is None
        else:
            np.testing.assert_array_equal(getattr(tp, f.name), getattr(jp, f.name))


def test_load_dataset_synthetic_and_raw_files(tmp_path):
    """No files: the synthetic stand-in; raw Cora files: the reader's
    arrays, both equal to the JAX package's."""
    small = tcfg.build_config(dataset="TEXAS", train_which="TeacherGNN")
    jd = jds.load_dataset(jcfg.build_config(dataset="TEXAS"), str(tmp_path))
    assert_same_fields(tds.load_dataset(small, str(tmp_path)), jd)
    cfg = tcfg.build_config(dataset="Cora", train_which="TeacherGNN")
    tsyn.write_fake_planetoid_raw(str(tmp_path), "cora", n_node=300, n_feat=40,
                                  n_class=3, n_allx=200, n_train=30, n_edge_und=400)
    got = tds.load_dataset(cfg, str(tmp_path))
    assert got.name == "Cora" and got.x.shape == (300, 40)
    assert_same_fields(got, jds.load_dataset(jcfg.build_config(dataset="Cora"),
                                             str(tmp_path)))
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.load_dataset(dataclasses.replace(cfg, dataset="nope"), None)


def _surgery_graph(rng, js, n=200, e=1000):
    """tests/test_surgery.py's graph, as a GraphData of the module ``js``."""
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    m = int(keep.sum())
    return js.GraphData(x=rng.normal(size=(n, 8)).astype(np.float32),
                        edge_index=np.stack([src[keep], dst[keep]]),
                        node_year=rng.integers(2010, 2019, n),
                        edge_year=rng.integers(2010, 2019, m),
                        keys=np.arange(n))


def assert_same_split(got, want):
    assert got.keys() == want.keys()
    for s in want:
        assert got[s].keys() == want[s].keys()
        for k in want[s]:
            np.testing.assert_array_equal(got[s][k], want[s][k], err_msg=f"{s}/{k}")


def test_gcn_norm_weights_matches(rng):
    n = 300
    e = jcore.add_self_loops(jcore.remove_self_loops(jcore.symmetrize(
        np.stack([rng.integers(0, n, 1200), rng.integers(0, n, 1200)]), n)), n)
    np.testing.assert_array_equal(tcore.gcn_norm_weights(e, n),
                                  jcore.gcn_norm_weights(e, n))


def test_edge_keys_sampler_and_membership_match(rng):
    from gnn_tail_generalization_tpu.linkpred import sampling as js
    from gnn_tail_generalization_tpu_torch.linkpred import sampling as ts

    n = 2_927_963  # ids up to the citation2 shape: the int32 hash wraps
    e = np.stack([rng.integers(0, n, 5000), rng.integers(n - 3000, n, 5000)])
    keys = ts.edge_keys(e, n)
    np.testing.assert_array_equal(keys, js.edge_keys(e, n))
    np.testing.assert_array_equal(
        ts.rejection_sample_non_edges(np.random.default_rng(3), keys, n, 4000),
        js.rejection_sample_non_edges(np.random.default_rng(3), keys, n, 4000))
    for slots in (8, 1):
        tm, jm = ts.build_membership(keys, slots), js.build_membership(keys, slots)
        np.testing.assert_array_equal(tm.buckets.numpy(), np.asarray(jm.buckets))
        np.testing.assert_array_equal(tm.spill.numpy(), np.asarray(jm.spill))


@pytest.mark.parametrize("module", ["surgery", "heuristics"])
def test_linkpred_host_copies_match_the_originals(module):
    """linkpred/surgery.py and heuristics.py are copies (importing the
    originals runs the JAX package's __init__): the code after the docstring
    is the original's."""
    port = os.path.join(REPO, "gnn_tail_generalization_tpu_torch", "linkpred",
                        f"{module}.py")
    orig = os.path.join(REPO, "gnn_tail_generalization_tpu", "linkpred",
                        f"{module}.py")
    assert _without_docstring(port) == _without_docstring(orig)


@pytest.mark.parametrize("by,setting", [
    ("node", s) for s in ("t2t", "u2t", "i2t", "s", "i")] + [
    ("edge", s) for s in ("t2t", "u2t", "i2t", "s", "i")] + [("cold", "i2t")])
def test_transfer_surgery_matches(by, setting):
    from gnn_tail_generalization_tpu.linkpred import surgery as js
    from gnn_tail_generalization_tpu_torch.linkpred import surgery as ts

    out = []
    for mod in (ts, js):
        g = _surgery_graph(np.random.default_rng(7), mod)
        if by == "edge":
            out.append(mod.transfer_surgery_edge_year(g, setting, lo=2013, hi=2016))
        else:
            out.append(mod.transfer_surgery_node_year(
                g, setting, lo=2013, hi=2016, exp_on_cold_edge=by == "cold"))
    (tg, tse), (jg, jse) = out
    assert_same_fields(tg, jg)
    assert_same_split(tse, jse)


def test_split_helpers_match(rng):
    from gnn_tail_generalization_tpu.linkpred import surgery as js
    from gnn_tail_generalization_tpu_torch.linkpred import surgery as ts

    g1, g2 = (_surgery_graph(np.random.default_rng(s), ts, n=40, e=90) for s in (1, 2))
    j1, j2 = (_surgery_graph(np.random.default_rng(s), js, n=40, e=90) for s in (1, 2))
    for a, b, keys in ((g1, j1, np.arange(0, 40)), (g2, j2, np.arange(25, 65))):
        a.keys = b.keys = keys
    assert_same_fields(ts.cal_union(g1, g2), js.cal_union(j1, j2))
    assert_same_fields(ts.target_seeded_by_source(g1, g2),
                       js.target_seeded_by_source(j1, j2))
    unique = rng.random(40) < 0.5
    g1.is_unique_in_targetG_mask = j1.is_unique_in_targetG_mask = unique
    assert_same_split(ts.init_split_edge_unified(g1, seed=4),
                      js.init_split_edge_unified(j1, seed=4))


@pytest.mark.parametrize("name", ["CN", "AA", "PPR"])
def test_heuristic_scores_match(rng, name):
    from gnn_tail_generalization_tpu.linkpred import heuristics as jh
    from gnn_tail_generalization_tpu_torch.linkpred import heuristics as th

    n = 300
    e = jcore.symmetrize(np.stack([rng.integers(0, n, 1500),
                                   rng.integers(0, n, 1500)]), n)
    pairs = np.stack([rng.integers(0, n, 400), rng.integers(0, n, 400)])
    np.testing.assert_array_equal(th.heuristic_scores(name, e, n, pairs),
                                  jh.heuristic_scores(name, e, n, pairs))


def test_cal_recall_matches(rng):
    from gnn_tail_generalization_tpu.linkpred import metrics as jm
    from gnn_tail_generalization_tpu_torch.linkpred import metrics as tm

    pos = rng.normal(size=300).astype(np.float32)
    neg = rng.normal(size=900).astype(np.float32)
    pos[:20] = neg[:20]  # ties across the two sets
    for topk in (None, 0, 0.5, 1.25, 3, 10, 5000):
        assert tm.cal_recall(torch.from_numpy(pos), torch.from_numpy(neg), topk) == \
            jm.cal_recall(pos, neg, topk), topk


_NO_JAX = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "gnn_tail_generalization_tpu")
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import importlib, pkgutil
import numpy as np
import gnn_tail_generalization_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from gnn_tail_generalization_tpu_torch.config import build_config
from gnn_tail_generalization_tpu_torch.data.synthetic import synthetic_planetoid
from gnn_tail_generalization_tpu_torch.data.datasets import prepare
from gnn_tail_generalization_tpu_torch.train.loops import run_experiment
import gnn_tail_generalization_tpu_torch.models.semlp
import gnn_tail_generalization_tpu_torch.nn.mlp
import gnn_tail_generalization_tpu_torch.ops.topk_attention
import gnn_tail_generalization_tpu_torch.nn.norms
import gnn_tail_generalization_tpu_torch.nn.graph_dropout
import gnn_tail_generalization_tpu_torch.propagation.diffusion
import gnn_tail_generalization_tpu_torch.propagation.correlation
from gnn_tail_generalization_tpu_torch.propagation.cs import run_cs_pipeline
data = synthetic_planetoid(n_node=80, n_feat=12, n_class=3, seed=0)
for tw, trick in (("TeacherGNN", "InitialBatchNorm"), ("SEMLP", "InitialBatchNorm"),
                  ("GraphMLP", "InitialBatchNorm"), ("TeacherGNN", "GroupNorm"),
                  ("TeacherGNN", "DenseNoNorm"), ("TeacherGNN", "LADIES"),
                  ("LP", "InitialBatchNorm")):
    cfg = build_config(dataset="", train_which=tw, N_nodes=80,
                       num_feats=12, num_classes=3, dim_hidden=8,
                       type_trick=trick, whetherHasSE="111",
                       force_set_to_best_config=False, skip_weight=0.01,
                       num_groups=2,
                       apply_graph_dropout=trick == "LADIES",
                       layerwise_dropout=True)
    pd = prepare(data, cfg, spmm_dense_threshold=10)
    res = run_experiment(cfg, pd, epochs=1)
    records = np.array(list(res.values())) if tw == "LP" else res.records
    assert np.isfinite(records).all(), (tw, trick, records)
cfg = build_config(dataset="", train_which="LP", N_nodes=80, num_feats=12,
                   num_classes=3, force_set_to_best_config=False)
cs = run_cs_pipeline(cfg, pd, epochs=2)
assert np.isfinite(cs["out"].numpy()).all()
import gnn_tail_generalization_tpu_torch.linkpred.edge_lp
import gnn_tail_generalization_tpu_torch.linkpred.encoders
import gnn_tail_generalization_tpu_torch.linkpred.heuristics
import gnn_tail_generalization_tpu_torch.linkpred.losses
import gnn_tail_generalization_tpu_torch.linkpred.metrics
import gnn_tail_generalization_tpu_torch.linkpred.predictors
import gnn_tail_generalization_tpu_torch.linkpred.sampling
import gnn_tail_generalization_tpu_torch.utils.convert
from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
from gnn_tail_generalization_tpu_torch.linkpred import surgery
g = surgery.GraphData(x=np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32),
                      edge_index=fast_powerlaw_graph(300, 1500, 0),
                      node_year=np.random.default_rng(1).integers(2010, 2019, 300),
                      keys=np.arange(300))
g2, se = surgery.transfer_surgery_node_year(g, "i2t", drop_rate=0.0)
for kw in (dict(encoder="GCN", edge_lp_mode="logit", eval_metric="mrr"),
           dict(encoder="SAGE", use_node_feats=True, train_node_emb=False),
           dict(encoder="CN", eval_metric="hits")):
    cfg = lpm.LinkPredConfig(batch_size=256, gnn_hidden_channels=8,
                             emb_hidden_channels=8, mlp_hidden_channels=8, **kw)
    out = lpm.train_linkpred(cfg, g2.x, g2.edge_index, g2.n_node, epochs=1,
                             split_edge=se)
    assert np.isfinite(list(out["stats"].values())).all(), (kw, out["stats"])
import tempfile
import torch
from gnn_tail_generalization_tpu_torch import main as port_main
from gnn_tail_generalization_tpu_torch.data import datasets, ogb, synthetic
from gnn_tail_generalization_tpu_torch.graph.analysis import table1_stats
from gnn_tail_generalization_tpu_torch.graph.core import build_graph, subgraph_edges
from gnn_tail_generalization_tpu_torch.ops.spmm import spmm_edge_grad, spmm_normalized
from gnn_tail_generalization_tpu_torch.train import checkpoint, loops
from gnn_tail_generalization_tpu_torch.utils import debug
with tempfile.TemporaryDirectory() as root:
    synthetic.write_fake_planetoid_raw(root, "cora", n_node=200, n_feat=30, n_class=3,
                                       n_allx=150, n_train=30, n_edge_und=300)
    assert datasets.load_dataset(build_config(dataset="Cora"), root).name == "Cora"
    synthetic.write_fake_ogbn_arxiv_raw(root, n_node=100, n_feat=4, n_class=3, n_edge=300)
    assert ogb.load_ogbn_arxiv(root).x.shape == (100, 4)
    argv = ["--dataset=TEXAS", "--exp_mode=I2_GTL", "--epochs=1", "--device=cpu",
            "--N_exp=2", "--prog=0-1", f"--records_path={root}", "--log_every=0"]
    res = port_main.main(argv)
    assert len(res) == 2 and res[0].columns[-1] == "linkp_test"
    assert port_main.main(argv) == []
    cfg = build_config(dataset="", train_which="SEMLP", N_nodes=80, num_feats=12,
                       num_classes=3, dim_hidden=8)
    r = loops.train_teacher(cfg, prepare(data, cfg), epochs=1, save_dir=root)
    debug.assert_finite(checkpoint.load_train_state(root + "/best-teacherGNN.pt"))
g = build_graph(fast_powerlaw_graph(50, 200, 0), 50, with_dense=False)
x = torch.randn(50, 4, requires_grad=True)
w = torch.rand(g.n_edge, requires_grad=True)
(spmm_edge_grad(g, x, w).sum() + spmm_normalized(g, x).sum()).backward()
err, _ = debug.checked(lambda t: t.log())(w.detach() - 2)
assert err.get() is not None and np.isfinite(w.grad.numpy()).all()
assert subgraph_edges(fast_powerlaw_graph(50, 200, 0), np.arange(20), 50)[0].max() < 20
assert table1_stats(50, np.bincount(fast_powerlaw_graph(50, 200, 0)[1], minlength=50))[0] == 50
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("NO_JAX_OK")
"""


def _without_docstring(path):
    tree = ast.parse(open(path).read())
    return ast.unparse(ast.Module(body=tree.body[1:], type_ignores=[]))


def test_diffusion_copy_matches_the_original():
    """propagation/diffusion.py is a copy (the JAX package's module cannot be
    imported without JAX): the code after the docstring is the original's."""
    port = os.path.join(REPO, "gnn_tail_generalization_tpu_torch", "propagation",
                        "diffusion.py")
    orig = os.path.join(REPO, "gnn_tail_generalization_tpu", "propagation",
                        "diffusion.py")
    assert _without_docstring(port) == _without_docstring(orig)


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]
