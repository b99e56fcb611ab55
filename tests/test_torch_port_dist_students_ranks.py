"""The port's side of ``test_torch_port_dist_students.py``: the inputs both
packages are fed, and what each of its spawned gloo ranks computes.

A module of its own that imports no JAX, so that each spawned rank, which
imports the rank program by name, starts in seconds. It holds no test."""
import dataclasses

import numpy as np
import torch

from gnn_tail_generalization_tpu_torch import config as tcfg
from gnn_tail_generalization_tpu_torch.data import datasets as tds
from gnn_tail_generalization_tpu_torch.data.synthetic import synthetic_features_labels
from gnn_tail_generalization_tpu_torch.graph.core import symmetrize
from gnn_tail_generalization_tpu_torch.linkpred import model as tlpm
from gnn_tail_generalization_tpu_torch.ops.topk_attention import dist_latent_replace
from gnn_tail_generalization_tpu_torch.parallel import distgraph as tdg
from gnn_tail_generalization_tpu_torch.propagation import correlation as corr
from gnn_tail_generalization_tpu_torch.train import loops as tloops
from gnn_tail_generalization_tpu_torch.utils.convert import linkpred_params_from_jax

S, RB, SEED = 4, 8, 3
F_IN, C, H = 24, 5, 16
N_SMALL, N_LARGE = 90, 8200  # GraphMLP: the dense A^r up to 8192 nodes, crops above
STUDENTS = ("SEMLP", "StudentBaseMLP", "GraphMLP", "GraphMLP-sparse", "LP")
METHODS = ("auto", "pallas_bf16")
N_PROP = 10


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def node_arrays(n, n_feat=F_IN, n_class=C):
    """A ``NodeData``'s fields: synthetic features and labels, 4n random
    edges, the first half of the nodes in train, the rest test."""
    rng = np.random.default_rng(0)
    x, y = synthetic_features_labels(n, n_feat, n_class, 0)
    train = np.zeros(n, bool)
    train[: n // 2] = True
    return dict(x=x, y=y, edge_index=np.stack([rng.integers(0, n, 4 * n),
                                               rng.integers(0, n, 4 * n)]),
                train_mask=train, val_mask=None, test_mask=~train, name="dist-students")


def student_case(name):
    """(config, NodeData fields) of a student run: dropout 0 in the teacher
    (its streams differ between the ranks' rows) and no norm (padded rows
    would enter its statistics); the students keep their dropout, drawn
    from streams seeded alike on every rank."""
    tw = name.split("-")[0]
    n, f, c = (N_LARGE, 8, 3) if name.endswith("sparse") else (N_SMALL, F_IN, C)
    kw = dict(dataset="Cora", train_which=tw, whetherHasSE="111", se_reg=0.5)
    over = dict(N_nodes=n, num_feats=f, num_classes=c, dim_hidden=H, dropout=0.0,
                type_trick="Residual", use_special_split=True, epochs=3,
                batch_size=32, graphMLP_reg=0.5)
    cfg = tcfg.apply_arch_configs(dataclasses.replace(tcfg.build_config(**kw), **over))
    return cfg, node_arrays(n, f, c)


def teacher_init(cfg):
    """The one-device teacher's initial state (seed SEED)."""
    return {k: v.clone() for k, v in
            tloops._teacher_model(cfg, SEED, None, None).state_dict().items()}


def rank_state(state, n_node_pad, shard):
    """A one-device state as rank ``shard``'s: its rows of each row-sharded
    tensor, padded with zero rows to ``n_node_pad``."""
    padded = {k: torch.cat([v, v.new_zeros((n_node_pad - v.shape[0],) + v.shape[1:])])
              if tdg.is_row_sharded(k) else v for k, v in state.items()}
    return tdg.shard_state_dict(padded, shard, S)


def run_semlp(cfg, pd, init_state):
    """The SEMLP pipeline of ``run_experiment`` from a given teacher start:
    the teacher, its SE table, part 1, part 2."""
    teacher = tloops.train_teacher(cfg, pd, SEED, init_state=init_state, device="cpu")
    se = tloops.collect_teacher_se(cfg, pd, teacher.best_state_dict, device="cpu")
    p1 = tloops.train_semlp_part1(cfg, pd, se, SEED, device="cpu")
    p2 = tloops.train_semlp_part2(cfg, pd, se, p1, SEED, device="cpu")
    return {"teacher": teacher, "se": se, "part1": p1, "part2": p2}


def run_student(name, pd, cfg, init_state=None):
    """One case of ``STUDENTS`` on ``pd`` (one device, or a rank's data)."""
    if name == "SEMLP":
        return run_semlp(cfg, pd, init_state)
    return {"result": tloops.run_experiment(cfg, pd, SEED, device="cpu")}


def replace_case(name):
    """(queries, the padded table [96, 6] with poisoned padding rows, K,
    n_valid): "random"; "tie": for the first query rows 10 and 11 score
    highest and rows 23 and 24, either side of the first shard cut, tie for
    the K-th place, which row 23 takes; "many-ties": a table of 3 distinct
    rows, so that most selections are tied."""
    rng = np.random.default_rng(4)
    n, npad = N_SMALL, 96
    se = np.zeros((npad, 6), np.float32)
    se[:n] = rng.normal(size=(n, 6))
    q = rng.normal(size=(20, 6)).astype(np.float32)
    if name == "tie":
        u = q[0] / np.linalg.norm(q[0])
        se[10], se[11], se[23], se[24] = 12 * u, 11 * u, 10 * u, 10 * u
    if name == "many-ties":
        se[:n] = se[rng.integers(0, 3, n)]
    se[n:] = 1e3  # poisoned: they would win every selection
    return q, se, 3, n


REPLACE_CASES = ("random", "tie", "many-ties")


def lp_arrays():
    """``tests/test_distgraph.py``'s C&S inputs: edges, labels, a softmax
    model output, the label rows."""
    rng = np.random.default_rng(0)
    n = N_SMALL
    e = np.stack([rng.integers(0, n, 500), rng.integers(0, n, 500)])
    e = e[:, e[0] != e[1]]
    y = rng.integers(0, C, n)
    mo = rng.random((n, C)).astype(np.float32)
    mo /= mo.sum(1, keepdims=True)
    return e, y, mo, np.unique(rng.integers(0, n, 30))


def pad_rows(a, npad=96):
    return tdg.pad_rows_np(np.asarray(a), npad)


LINK_KW = dict(encoder="SAGE", predictor="DOT", dropout=0.0, use_node_feats=True,
               train_node_emb=False, eval_metric="mrr", batch_size=64, num_neg=2,
               gnn_hidden_channels=H, mlp_hidden_channels=H)


def link_case():
    """(LinkPredConfig, features, edges, n): the JAX sharded test's graph."""
    rng = np.random.default_rng(0)
    n = N_SMALL
    e = np.unique(rng.integers(0, n, (2, 700)), axis=1)
    e = e[:, e[0] != e[1]]
    x = rng.normal(size=(n, 12)).astype(np.float32)
    return tlpm.LinkPredConfig(**LINK_KW), x, e, n


def link_batch(n, msg, b=48, num_neg=2, n_valid=40):
    rng = np.random.default_rng(10)
    pos = msg.T[rng.choice(msg.shape[1], b, replace=False)]
    return pos, rng.integers(0, n, (b, num_neg, 2)), (np.arange(b) < n_valid).astype(np.float32)


def link_msg(e, n):
    return symmetrize(e, n)


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _replicated(state):
    return {k: v.numpy().copy() for k, v in state.items() if not tdg.is_row_sharded(k)}


def rank_students(comm, init):
    out = {}
    for name in STUDENTS:
        cfg, arrays = student_case(name)
        pd = tds.prepare_sharded(tds.NodeData(**arrays), cfg, comm, rb=RB)
        state = None
        if name == "SEMLP":
            state = rank_state(init, pd.graph.n_node_pad, comm.shard)
        res = run_student(name, pd, cfg, state)
        out[name] = {k: (v.numpy() if isinstance(v, torch.Tensor) else
                         v if isinstance(v, dict) else
                         {"records": v.records, "columns": v.columns,
                          "replicated": _replicated(v.state_dict)})
                     for k, v in res.items()}
    return out


def rank_propagation(comm):
    e, y, mo, idx = lp_arrays()
    out = {}
    dad = corr.gen_normalized_dist_adj(e, N_SMALL, comm, "DAD", rb=RB)
    ad = corr.gen_normalized_dist_adj(e, N_SMALL, comm, "AD", rb=RB)
    yl = torch.from_numpy(dad.local_rows(pad_rows(y)))
    mol = torch.from_numpy(dad.local_rows(pad_rows(mo)))
    li = torch.from_numpy(idx)
    for m in METHODS:
        out[("lp", m)] = corr.label_propagation(yl, li, dad, 0.5, N_PROP, C, m).numpy()
        for fn in (corr.double_correlation_autoscale, corr.double_correlation_fixed):
            res, smooth = fn(yl, mol, li, li, dad, 0.8, N_PROP, ad, 0.7, N_PROP, C,
                             spmm_method=m)
            out[(fn.__name__, m)] = (res.numpy(), smooth.numpy())
    return out


def rank_linkpred(comm, jax_params):
    cfg, x, e, n = link_case()
    run = tlpm.train_linkpred(cfg, x, e, n, epochs=2, runs=1, seed=11, comm=comm,
                              dist_rb=RB, device="cpu")
    # one step's loss and gradients from the JAX parameters on fixed pairs
    msg = link_msg(e, n)
    g = tlpm.link_dist_graph(cfg, msg, n, comm, rb=RB)
    model = tlpm.LinkPredModel(cfg, n, x.shape[1])
    model.load_state_dict(linkpred_params_from_jax(jax_params, cfg, n, x.shape[1]))
    model.train()
    const = tlpm.link_const(cfg, g, tlpm.shard_rows(x, g, "cpu"))
    pos, neg, valid = (torch.from_numpy(a) for a in link_batch(n, msg))
    loss = tlpm.make_loss_fn(cfg, model)(const, pos, neg, None, valid)
    (loss / comm.world_size).backward()
    tdg.sum_replicated_grads(model, comm)
    return {"stats": run["stats"], "params": _replicated(run["params"]),
            "step_loss": loss.item(),
            "step_grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()}}


def rank_checkpoint(comm, save_dir):
    cfg, arrays = student_case("SEMLP")
    cfg = dataclasses.replace(cfg, type_trick="BatchNorm", epochs=1)
    pd = tds.prepare_sharded(tds.NodeData(**arrays), cfg, comm, rb=RB)
    res = tloops.train_teacher(cfg, pd, SEED, device="cpu", save_dir=save_dir)
    return {k: v.numpy().copy() for k, v in res.state_dict.items()}


def rank_replace(comm):
    out = {}
    for name in REPLACE_CASES:
        q, se, k, n_valid = replace_case(name)
        rows = se.shape[0] // S
        local = torch.from_numpy(se[comm.shard * rows: (comm.shard + 1) * rows])
        out[name] = dist_latent_replace(comm, torch.from_numpy(q), local, k, n_valid,
                                        rows, row_chunk=7).numpy()
    return out


def rank_program(comm, spec):
    """Everything the test file asks of the ranks, in one process group."""
    gathered = {str(dt): comm.all_gather(
        torch.arange(6, dtype=dt).reshape(2, 3) + 10 * comm.shard).numpy()
        for dt in (torch.float32, torch.int32, torch.int64)}
    return {
        "rank": comm.rank,
        "all_gather": gathered,
        "replace": rank_replace(comm),
        "students": rank_students(comm, spec["teacher_init"]),
        "propagation": rank_propagation(comm),
        "linkpred": rank_linkpred(comm, spec["link_params"]),
        "checkpoint": rank_checkpoint(comm, spec["save_dir"]),
        "counts": dict(comm.counts),
    }
