"""The port's dataset readers and fake raw-set writers against the JAX
package's, on the same files written to tmp: every array of the returned
``NodeData`` / ``GraphData`` exactly equal, dtype included (Cora, Citeseer
with missing test ids, ogbn-arxiv, ogbl with and without edge years and
weights, TEXAS with and without geom-gcn split files, ACTOR's sparse
features); the port's writers read back equal through the JAX readers; the
``load_dataset`` registry, directory names included; full-size fake Cora
through the reader and ``prepare``; and the code of each host copy equal to
its original's. The 1,500-epoch golden-protocol twins are marked slow."""
import ast
import dataclasses
import gzip
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as ssp

from gnn_tail_generalization_tpu import config as jcfg
from gnn_tail_generalization_tpu.data import datasets as jds
from gnn_tail_generalization_tpu.data import ogb as jogb
from gnn_tail_generalization_tpu.data import planetoid as jplan
from gnn_tail_generalization_tpu.data import synthetic as jsyn
from gnn_tail_generalization_tpu.data import webkb as jweb

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.data import ogb as togb
from gnn_tail_generalization_tpu_torch.data import planetoid as tplan
from gnn_tail_generalization_tpu_torch.data import synthetic as tsyn
from gnn_tail_generalization_tpu_torch.data import webkb as tweb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CORA = dict(n_node=300, n_feat=60, n_class=4, n_allx=200, n_train=40,
                  n_edge_und=500)


def assert_same(a, b):
    """Every field of two dataclass instances equal; arrays exactly, with
    the same dtype."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert isinstance(va, np.ndarray) and va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_cora_reader_matches(tmp_path):
    jsyn.write_fake_planetoid_raw(str(tmp_path), "cora", **SMALL_CORA)
    t = tplan.load_planetoid(str(tmp_path), "Cora")
    assert_same(t, jplan.load_planetoid(str(tmp_path), "Cora"))
    assert t.x.shape == (300, 60) and t.name == "Cora"


def test_citeseer_reader_reinserts_missing_test_ids(tmp_path):
    """Citeseer's isolated test nodes are missing from tx/ty and
    test.index: the readers put zero rows back at their ids."""
    d = jsyn.write_fake_planetoid_raw(str(tmp_path), "citeseer", **SMALL_CORA)
    n_allx, n = SMALL_CORA["n_allx"], SMALL_CORA["n_node"]
    missing = np.arange(n_allx + 5, n - 5, 9)  # inside the test id range
    keep = np.setdiff1d(np.arange(n_allx, n), missing)

    def load(s):
        with open(os.path.join(d, f"ind.citeseer.{s}"), "rb") as f:
            return pickle.load(f)

    def dump(obj, s):
        with open(os.path.join(d, f"ind.citeseer.{s}"), "wb") as f:
            pickle.dump(obj, f)

    dump(ssp.csr_matrix(load("tx").toarray()[keep - n_allx]), "tx")
    dump(load("ty")[keep - n_allx], "ty")
    np.savetxt(os.path.join(d, "ind.citeseer.test.index"),
               np.random.default_rng(1).permutation(keep), fmt="%d")
    t = tplan.load_planetoid(str(tmp_path), "Citeseer")
    assert_same(t, jplan.load_planetoid(str(tmp_path), "Citeseer"))
    assert (t.x[missing] == 0).all() and not t.test_mask[missing].any()
    assert t.test_mask.sum() == len(keep)


def gz_save(path, arr, fmt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, arr, delimiter=",", fmt=fmt)


def test_ogbn_arxiv_reader_matches(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 80, 8
    raw, split = tmp_path / "ogbn_arxiv" / "raw", tmp_path / "ogbn_arxiv" / "split" / "time"
    gz_save(str(raw / "edge.csv.gz"), rng.integers(0, n, (300, 2)), "%d")
    gz_save(str(raw / "node-feat.csv.gz"), rng.normal(size=(n, d)), "%.6f")
    gz_save(str(raw / "node-label.csv.gz"), rng.integers(0, 5, (n, 1)), "%d")
    idx = rng.permutation(n)
    for name, part in (("train", idx[:50]), ("valid", idx[50:60]), ("test", idx[60:])):
        gz_save(str(split / f"{name}.csv.gz"), part[:, None], "%d")
    t = togb.load_ogbn_arxiv(str(tmp_path))
    assert_same(t, jogb.load_ogbn_arxiv(str(tmp_path)))
    assert t.x.dtype == np.float32 and t.train_mask.sum() == 50


@pytest.mark.parametrize("extras", ["edges_only", "years_weights"])
def test_ogbl_reader_matches(tmp_path, extras):
    """ogbl-collab's layout: per-undirected-edge years and weights, which
    the readers repeat for both directions; without features, x is zeros."""
    rng = np.random.default_rng(2)
    n, e = 60, 240
    raw = tmp_path / "ogbl_collab" / "raw"
    gz_save(str(raw / "edge.csv.gz"), rng.integers(0, n, (e, 2)), "%d")
    if extras == "years_weights":
        gz_save(str(raw / "node-feat.csv.gz"), rng.normal(size=(n, 5)), "%.5f")
        gz_save(str(raw / "node_year.csv.gz"), rng.integers(2000, 2020, (n, 1)), "%d")
        gz_save(str(raw / "edge_year.csv.gz"), rng.integers(2000, 2020, (e // 2, 1)), "%d")
        gz_save(str(raw / "edge_weight.csv.gz"), rng.random((e, 1)), "%.4f")
    (tg, td), (jg, jd) = (m.load_ogbl_graph(str(tmp_path), "ogbl-collab")
                          for m in (togb, jogb))
    assert td == jd
    assert_same(tg, jg)
    if extras == "years_weights":
        assert tg.edge_year.shape == (e,) and tg.edge_weight.shape == (e,)
    else:
        assert tg.node_year is None and tg.x.shape == (n, 1)


def write_webkb(root, name, n=30, sparse=False, with_splits=False):
    d = os.path.join(root, name, "raw")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(3)
    with open(os.path.join(d, "out1_node_feature_label.txt"), "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        for i in rng.permutation(n):
            if sparse:  # Actor: active word ids, some above the 932 vocabulary
                feats = ",".join(str(v) for v in rng.integers(0, 1000, 4))
            else:
                feats = ",".join(str(v) for v in rng.integers(0, 2, 7))
            f.write(f"{i}\t{feats}\t{rng.integers(0, 5)}\n")
    with open(os.path.join(d, "out1_graph_edges.txt"), "w") as f:
        f.write("node_id\tnode_id\n")
        for a, b in rng.integers(0, n, (80, 2)):
            f.write(f"{a}\t{b}\n")
    if with_splits:
        for k in range(3):
            r = np.random.default_rng(10 + k).random(n)
            np.savez(os.path.join(d, f"{name.lower()}_split_0.6_0.2_{k}.npz"),
                     train_mask=r < 0.6, val_mask=(r >= 0.6) & (r < 0.8),
                     test_mask=r >= 0.8)


@pytest.mark.parametrize("name,splits", [("TEXAS", False), ("TEXAS", True),
                                         ("ACTOR", False)])
def test_webkb_readers_match(tmp_path, name, splits):
    write_webkb(str(tmp_path), name, sparse=name == "ACTOR", with_splits=splits)
    for which in (0, 1, 4):
        t = tweb.load_webkb_like(str(tmp_path), name, which_split=which)
        assert_same(t, jweb.load_webkb_like(str(tmp_path), name, which_split=which))
    if name == "ACTOR":
        assert t.x.shape == (30, 932)


@pytest.mark.parametrize("kind", ["planetoid", "ogbn_arxiv"])
def test_port_writers_read_back_through_the_jax_readers(tmp_path, kind):
    if kind == "planetoid":
        jsyn.write_fake_planetoid_raw(str(tmp_path / "j"), "cora", **SMALL_CORA)
        tsyn.write_fake_planetoid_raw(str(tmp_path / "t"), "cora", **SMALL_CORA)
        read = lambda r: jplan.load_planetoid(str(r), "Cora")  # noqa: E731
    else:
        kw = dict(n_node=120, n_feat=6, n_class=3, n_edge=500, seed=1)
        jsyn.write_fake_ogbn_arxiv_raw(str(tmp_path / "j"), **kw)
        tsyn.write_fake_ogbn_arxiv_raw(str(tmp_path / "t"), **kw)
        read = jogb.load_ogbn_arxiv
    assert_same(read(tmp_path / "t"), read(tmp_path / "j"))


@pytest.mark.parametrize("dataset,dirname", [
    ("Cora", "Cora"), ("ogbn-arxiv", "ogbn_arxiv"), ("ogbn-arxiv", "ogbn-arxiv"),
    ("TEXAS", None), ("Pubmed", None)])
def test_load_dataset_registry_matches(tmp_path, dataset, dirname):
    """The readers fire where their files are, under the JAX package's
    directory names only (``ogbn-arxiv`` is not one); elsewhere both fall
    back to the same synthetic stand-in."""
    if dirname == "Cora":
        tsyn.write_fake_planetoid_raw(str(tmp_path), "cora", **SMALL_CORA)
    elif dirname is not None:
        tsyn.write_fake_ogbn_arxiv_raw(str(tmp_path), n_node=90, n_feat=4,
                                       n_class=3, n_edge=300)
        if dirname != "ogbn_arxiv":
            os.rename(tmp_path / "ogbn_arxiv", tmp_path / dirname)
    kw = dict(dataset=dataset, train_which="TeacherGNN")
    t = tds.load_dataset(tcfg.build_config(**kw), str(tmp_path))
    assert_same(t, jds.load_dataset(jcfg.build_config(**kw), str(tmp_path)))
    assert t.name.startswith("synthetic") == (dirname not in ("Cora", "ogbn_arxiv"))


def test_full_size_cora_through_reader_and_prepare(tmp_path):
    tsyn.write_fake_planetoid_raw(str(tmp_path), "cora")
    kw = dict(dataset="Cora", train_which="TeacherGNN", want_headtail=True,
              num_layers=2, use_special_split=True)
    ct, cj = tcfg.build_config(**kw), jcfg.build_config(**kw)
    t = tds.load_dataset(ct, str(tmp_path))
    assert t.name == "Cora" and t.x.shape == (2708, 1433)
    assert t.train_mask.sum() == 140 and t.test_mask.sum() == 1000
    tp = tds.prepare(t, ct)
    jp = jds.prepare(jds.load_dataset(cj, str(tmp_path)), cj)
    for f in ("x", "y", "edge_index", "edge_index_bkup", "train_mask",
              "test_mask", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    assert tp.train_idx.shape == (600,)  # the Cora special split
    assert tp.graph.n_edge == jp.graph.n_edge and tp.graph.dense_adj is not None
    np.testing.assert_array_equal(tp.graph.dense_adj.numpy(),
                                  np.asarray(jp.graph.dense_adj))


def _code(path, skip=()):
    """The module's code with every docstring dropped (the copies' docstrings
    name their original and may not name files outside the project), and
    without the functions named in ``skip``."""
    tree = ast.parse(open(path).read())
    tree.body = [n for n in tree.body if getattr(n, "name", None) not in skip]
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            b = node.body
            if b and isinstance(b[0], ast.Expr) and isinstance(
                    getattr(b[0], "value", None), ast.Constant) and isinstance(
                    b[0].value.value, str):
                node.body = b[1:] or [ast.Pass()]
    return ast.unparse(tree)


@pytest.mark.parametrize("module", [
    "data/planetoid.py", "data/ogb.py", "data/webkb.py", "data/synthetic.py",
    "utils/records.py", "graph/analysis.py"])
def test_host_copy_code_matches_the_original(module):
    """The fake-arxiv writer differs in its gzip level alone, and is held
    to its original by what the readers make of its files
    (``test_port_writers_read_back_through_the_jax_readers``)."""
    port = os.path.join(REPO, "gnn_tail_generalization_tpu_torch", module)
    orig = os.path.join(REPO, "gnn_tail_generalization_tpu", module)
    skip = ("write_fake_ogbn_arxiv_raw",) if module == "data/synthetic.py" else ()
    assert _code(port, skip) == _code(orig, skip)


# ---- the golden-protocol dry runs of tests/test_golden_dryrun.py, through
# the port on full-size fake Cora (1,500 epochs each: slow) ----------------


@pytest.fixture(scope="module")
def fake_cora_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fakedata")
    tsyn.write_fake_planetoid_raw(str(root), "cora")
    return str(root)


def _golden_teacher(root, **over):
    from gnn_tail_generalization_tpu_torch.train import loops

    cfg = tcfg.build_config(dataset="Cora", want_headtail=True, num_layers=2,
                            use_special_split=True, train_which="TeacherGNN", **over)
    data = tds.load_dataset(cfg, root)
    assert data.name == "Cora", "the raw reader did not fire"
    pd = tds.prepare(data, cfg)
    res = loops.train_teacher(cfg, pd, seed=0, device="cpu")
    assert res.records.shape[0] == cfg.epochs == 1500
    assert np.isfinite(res.records).all()
    assert res.best("acc_test") > 25.0  # the fake task is learnable
    return cfg, pd, res


@pytest.mark.slow
def test_golden_protocol_dryrun_traditional_gcn(fake_cora_root):
    from gnn_tail_generalization_tpu_torch.train import loops

    cfg, pd, res = _golden_teacher(fake_cora_root, whetherHasSE="000")
    again = loops.train_teacher(cfg, pd, seed=0, device="cpu")
    np.testing.assert_array_equal(res.records, again.records)


@pytest.mark.slow
def test_golden_protocol_dryrun_coldbrew_teacher(fake_cora_root):
    _golden_teacher(fake_cora_root, whetherHasSE="100", se_reg=32.0)


@pytest.mark.slow
def test_golden_protocol_dryrun_semlp_isolation(fake_cora_root):
    from gnn_tail_generalization_tpu_torch.train import loops

    cfg = tcfg.build_config(
        dataset="Cora", train_which="SEMLP", SEMLP_topK_2_replace=3,
        SEMLP_part1_arch="2layer", dropout_MLP=0.5,
        studentMLP__opt_lr="adam&0.005", want_headtail=True,
        use_special_split=True)
    data = tds.load_dataset(cfg, fake_cora_root)
    assert data.name == "Cora"
    res = loops.run_experiment(cfg, tds.prepare(data, cfg), seed=0, device="cpu")
    assert "iso" in res.columns and np.isfinite(res.records).all()
