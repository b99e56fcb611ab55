"""Drive the PyTorch port's teacher, trick zoo, Cold Brew student, label
propagation and link-prediction paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   and the build of the CUDA kernels (``gnn_tail_generalization_tpu_torch/
   csrc/*.cu``, built into ``gnn_tail_generalization_tpu_torch/_build/``);
2. each kernel against its plain PyTorch version on the card, on each CSR's
   row schedule: the bench-shape power-law graph (169,343 nodes, 2,501,571
   edges after the loader pipeline), forward and transposed CSR, d=256 and
   d=40, the slice's own graphs at d=256, a hub-row case at d=16, a
   degree-boundary graph (rows of in-degree 0, T - 1, T, T + 1 and 2T + 1,
   T the hub threshold) at d=256, 40, 16 and 33 (vector width 1), and a star
   graph (one row of 1,000,000 in-edges) at d=256 and 40, forward and
   transposed; max |kernel - plain| / max |plain| must be <= 1e-5
   (identical operands, only the summation order differs). Each case prints
   the kernel, plain and ``library_ms`` times (median of CUDA-event timed
   runs; ``library_ms`` is ``torch.sparse.mm`` of a CSR tensor, cuSPARSE,
   which the port never calls), ``bound_ms`` (``bound``) and the kernel's
   share of it. Two launches on the bench graph must be bit-identical, and
   a call without a schedule (built from ``indptr``) must equal one with;
3. the slice: the port's ``main`` on ogbn-arxiv's shape (synthetic stand-in,
   169,343 nodes, 128 features, hidden 256, 40 classes), 3 epochs, once with
   ``--spmm_method=auto`` (f32 kernel) and once with ``pallas_bf16`` (bf16
   kernel). Each run's records must be finite, its kernel's launch count must
   grow and the plain version's must not. One step at dropout 0 from fixed
   weights through the f32 kernel must match the same step through the plain
   version within 1e-5 relative, in loss and every gradient;
4. the student: (i) the port's ``main`` with ``--train_which=SEMLP`` at the
   same shape (teacher with SE on every layer, its [169343, 512] SE table,
   part 1, part 2), 3 epochs a phase: finite records with the columns
   ``loss_train, acc_test, head, tail, iso``, and the f32 kernel launched
   for exactly the teacher's steps plus the SE-table forward, the bf16
   kernel and the plain version never; (ii) ``latent_neighbor_replace`` on
   the card against a float64 CPU evaluation of 512 rows of that run's own
   queries and SE table (the same selected neighbours, output within 1e-5
   relative), and its time at B = 65,536 rows, the real arxiv batch;
   (iii) StudentBaseMLP at the arxiv shape and GraphMLP on the Cora
   stand-in (dense A^r), 3 epochs each, finite, with no SpMM launch;
   (iv) the step and eval times of each phase;
5. the trick zoo: the port's ``main`` at the arxiv shape with
   ``--force_set_to_best_config=0``, 3 epochs, for BatchNorm, GroupNorm (the
   arxiv preset: 10 groups, a [169343, 2560] block per layer), PairNorm,
   DenseNoNorm with attention, Jumping, and graph dropout (DropEdge, LADIES,
   FastGCN under ``pallas_bf16``). Finite records, and launch counts as the
   rule predicts: per epoch 2 SpMMs a layer for the train step (on masked,
   plan-less graphs under graph dropout: the f32 kernel) and 1 a layer for
   the eval forward (the full graph: the kernel of the method). One step at
   dropout 0 through the f32 kernel against the plain version (1e-5
   relative, loss and every gradient) for GroupNorm and LADIES, both drawing
   the same masks;
6. propagation: ``--train_which=LP`` through ``main`` (a finite JSON line,
   the f32 kernel launched once per propagation), its [169343, 40]
   propagation against the plain version (1e-5 relative); then
   ``run_cs_pipeline`` with diffusion features and 5 mid-step epochs (the
   f32 kernel launched num_propagations1 + num_propagations2 times), and
   ``lp_step`` against the plain version (1e-5 relative); the ms of both
   and of one propagation;
7. link prediction at the ogbl-citation2 shape (``bench_linkpred.py``'s
   graph: 2,927,963 nodes, a power-law graph of 15.2M edges, 8,192 valid
   and 8,192 test positives with 50 sampled negatives each, message edges
   the symmetrized rest, ~30.4M; 128 features drawn on the card), with the
   host build's seconds and the maximum in-degree: (i) both kernels against
   the plain version on that graph at d=256; (ii) the JAX package's bench
   config (SAGE + DOT, ``ce_loss``, features, no embedding, batch 65,536,
   3 negatives, ``pallas_bf16``) through ``train_linkpred``, 2 epochs of 8
   steps, the bf16 kernel launched exactly 1 + 2 per step + 1 per eval and
   nothing else, a finite MRR; (iii) its 16-step epoch and the warm
   1000-negative OGB eval, timed; (iv) the default ``LinkPredConfig()`` (a
   trainable [n, 256] embedding, the f32 kernel 4 per step + 2 per eval);
   (v) one step of each at dropout 0 through the kernels against the plain
   versions, loss and every gradient within the larger of 1e-5 and 4x the
   plain step's own sum-order floor (the kernels sum in another order than
   the plain version, so no step is expected to be bit-identical); (vi) GCN (the f32 kernel) and the
   Transformer (no launch) at the bench shape; (vii) ``--exp_mode=I2_GTL
   --task=linkp`` through ``main`` (the 2,000-node stand-in, dense, no
   launch);
8. the rest of the single-device CLI: (i) a full-size fake ogbn-arxiv raw
   set (169,343 nodes, 1,166,243 edges, 128 features, 40 classes) written to
   a directory under ``_chip/``, read through ``load_dataset`` (the reader
   must fire, not the stand-in), prepared, and trained 3 epochs through
   ``main --data_root`` under ``auto``, with the write, read and prepare
   seconds and exactly 6 f32 launches an epoch; (ii) ``--exp_mode=I2_GTL
   --task=nodeC`` on the arxiv slice under ``auto`` and ``pallas_bf16``, 3
   epochs: exactly 2 + 1 launches a layer an epoch of the method's kernel
   (no loss-masked view under the edgewise loss), MRR columns in (0, 1],
   step ms beside phase 3's, and one step through the f32 kernel against
   the plain version with fixed pairs at dropout 0 (loss and every
   gradient, ``check_step_parity``'s rule with the sum-order floor);
   (iii) ``spmm_edge_grad`` on the bench-shape graph at d=256: y, dx and dw
   against the plain version (1e-5 relative) and forward + backward ms;
   (iv) ``--N_exp=3`` through ``main`` (``train/multiseed.py``): each seed's
   records bit-identical to ``train_teacher`` from that seed; (v) a
   ``save_dir`` checkpoint read back onto the card gives a bit-identical
   eval forward, and a ``--prog`` run repeated skips its done cell.

Prints the kernels' JSON line (launches summed over every phase; phase 7's
numbers under ``linkpred``, phase 8's under ``cli``), then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REL_TOL = 1e-5
SOURCE = "gnn_tail_generalization_tpu_torch/csrc/spmm_csr.cu"
KERNELS = {  # wrapper -> the Pallas kernel it replaces
    "spmm_csr_f32": "gnn_tail_generalization_tpu/ops/spmm_pallas.py:305",
    "spmm_csr_bf16": "gnn_tail_generalization_tpu/ops/spmm_pallas.py:389",
}
SLICE_ARGS = ["--dataset=ogbn-arxiv", "--train_which=TeacherGNN", "--epochs=3",
              "--device=cuda", "--log_every=1"]
# '111': under the Initial trick every conv takes SE flag [1]
SEMLP_ARGS = ["--dataset=ogbn-arxiv", "--train_which=SEMLP", "--whetherHasSE=111",
              "--se_reg=32", "--epochs=3", "--device=cuda", "--spmm_method=auto",
              "--log_every=1"]
STUDENT_RUNS = (
    ["--dataset=ogbn-arxiv", "--train_which=StudentBaseMLP", "--epochs=3",
     "--device=cuda", "--log_every=1"],
    ["--dataset=Cora", "--train_which=GraphMLP", "--graphMLP_reg=0.5",
     "--epochs=3", "--device=cuda", "--log_every=1"],
)
STUDENT_COLS = ["loss_train", "acc_test", "head", "tail", "iso"]
REPLACE_ROWS = 512  # rows held to the float64 evaluation
REPLACE_BATCH = 64 * 1024  # the arxiv config's batch_size
TRICK_BASE = ["--dataset=ogbn-arxiv", "--train_which=TeacherGNN",
              "--force_set_to_best_config=0", "--epochs=3", "--device=cuda",
              "--log_every=1"]
TRICK_RUNS = {
    "BatchNorm": ["--type_trick=BatchNorm"],
    "GroupNorm": ["--type_trick=GroupNorm"],
    "PairNorm": ["--type_trick=PairNorm"],
    "DenseNoNorm-attention": ["--type_trick=DenseNoNorm", "--layer_agg=attention"],
    "Jumping": ["--type_trick=Jumping"],
    "DropEdge": ["--type_trick=DropEdge", "--apply_graph_dropout=1"],
    "LADIES": ["--type_trick=LADIES", "--apply_graph_dropout=1",
               "--layerwise_dropout=1"],
    "FastGCN-bf16": ["--type_trick=FastGCN", "--apply_graph_dropout=1",
                     "--spmm_method=pallas_bf16"],
}
# run -> whether the parity bound takes the sum-order floor (check_step_parity)
TRICK_PARITY = {"GroupNorm": True, "LADIES": False}
LP_ARGS = ["--dataset=ogbn-arxiv", "--train_which=LP", "--device=cuda"]
CS_EPOCHS = 5
# phase 7: link prediction at ogbl-citation2's shape (bench_linkpred.py:49-105)
C2_NODES, C2_EDGES, C2_FEATS = 2_927_963, 30_387_995 // 2, 128
BENCH_NODES, BENCH_EDGES = 169_343, 1_166_243  # phase 2's bench shape
EVAL_POS, EVAL_NEG, OGB_NEG = 8192, 50, 1000
TIMED_STEPS = 16
I2GTL_ARGS = ["--exp_mode=I2_GTL", "--task=linkp", "--device=cuda"]
STAR_NODES, STAR_EDGES = 100_000, 1_000_000  # phase 2's star graph
# phase 8: the reader-fed teacher, the I2-GTL teacher, multi-seed, --prog
READER_ARGS = SLICE_ARGS + ["--spmm_method=auto"]
I2GTL_NODEC_ARGS = SLICE_ARGS + ["--exp_mode=I2_GTL", "--task=nodeC"]
N_EXP = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet), at 700 W
F32_FLOPS = 67e12  # f32 outside the tensor cores, the same sheet


def bound(g, d: int, bf16: bool) -> tuple:
    """(ms, what bounds it): the least time the card could take for y = A @ x
    on ``g``'s CSR at width d. Bytes: every x row some edge reads (bf16 where
    the kernel reads bf16), y in f32, indices, weights and indptr, each
    once, over the HBM rate; operations: 2 flops an edge and column over
    the f32 rate. The larger of the two."""
    elem = 2 if bf16 else 4
    n_src = int(torch.unique(g.indices).numel())
    nbytes = (n_src * d * elem + g.n_node * d * 4 + g.n_edge * (4 + elem)
              + (g.n_node + 1) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * g.n_edge * d / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_fn(g, x, bf16: bool):
    """One PyTorch call that computes the same product: torch.sparse.mm of a
    CSR tensor (cuSPARSE), x and w already in the working type (its bf16
    form returns bf16). Timed as a yardstick; the port never calls it."""
    dt = torch.bfloat16 if bf16 else torch.float32
    a = torch.sparse_csr_tensor(g.indptr, g.indices, g.weight.to(dt),
                                size=(g.n_node, g.n_node), check_invariants=False)
    xx = x.to(dt)
    return lambda: torch.sparse.mm(a, xx)


def compare(name, fn, g, x, plain_bf16, card_name, tag, reps: int = 20) -> dict:
    """Kernel ``fn`` on ``g``'s CSR and row schedule against the plain
    version: errors, kernel, plain and library ms, the bound and the
    kernel's share of it. Fails when rel err > REL_TOL."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    args = (g.indptr, g.indices, g.weight, x)
    y = fn(*args, schedule=g.schedule)
    torch.cuda.synchronize()
    y_ref = K.spmm_csr_plain(*args, bf16=plain_bf16)
    assert y.shape == y_ref.shape and y.dtype == torch.float32, (y.shape, y.dtype)
    abs_err = (y - y_ref).abs().max().item()
    rel = abs_err / max(y_ref.abs().max().item(), 1e-30)
    del y, y_ref
    ms = median_ms(lambda: fn(*args, schedule=g.schedule), reps=reps)
    plain_ms = median_ms(lambda: K.spmm_csr_plain(*args, bf16=plain_bf16), reps=reps)
    library_ms = median_ms(library_fn(g, x, plain_bf16), reps=reps)
    bound_ms, bound_by = bound(g, x.shape[1], plain_bf16)
    log(f"  {name:14s} {tag:28s} d={x.shape[1]:3d} max_abs_err={abs_err:.3e} "
        f"rel_err={rel:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"share={bound_ms / ms:.3f} [{card_name}]")
    assert rel <= REL_TOL, f"{name} {tag}: rel err {rel} > {REL_TOL}"
    return {"max_abs_err": abs_err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}


def hub_graph():
    """The hub-row stress case of tests/test_spmm_pallas.py: node 7 takes
    500 in-edges, plus 100 random edges, over 40 nodes."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(0)
    n = 40
    src = rng.integers(0, n, 500)
    e = np.stack([np.concatenate([src, rng.integers(0, n, 100)]),
                  np.concatenate([np.full(500, 7), rng.integers(0, n, 100)])])
    return build_graph(e, n, with_dense=False)


def star_graph():
    """Node 0 takes STAR_EDGES in-edges from random sources, plus random
    light rows, over STAR_NODES nodes; unit weights."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(1)
    n, light = STAR_NODES, STAR_NODES * 5
    e = np.stack([rng.integers(0, n, STAR_EDGES + light),
                  np.concatenate([np.zeros(STAR_EDGES, np.int64),
                                  rng.integers(1, n, light)])])
    return build_graph(e, n, with_dense=False)


def boundary_graph():
    """Rows 0-4 of in-degree 0, T - 1, T, T + 1 and 2T + 1 (T the schedule's
    hub threshold), then 2,000 rows of random in-degree 0-8; weights
    normal."""
    from gnn_tail_generalization_tpu_torch.graph.core import HUB_THRESHOLD as T
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(2)
    degs = np.concatenate([[0, T - 1, T, T + 1, 2 * T + 1], rng.integers(0, 9, 2000)])
    n = degs.shape[0]
    dst = np.repeat(np.arange(n), degs)
    e = np.stack([rng.integers(0, n, dst.shape[0]), dst])
    return build_graph(e, n, rng.normal(size=dst.shape[0]).astype(np.float32),
                       with_dense=False)


def slice_data():
    """The slice's config and prepared data, as main builds them."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config

    return port_main.load_prepared(
        build_config(**port_main.parse_args(SLICE_ARGS)[0]), "data")


def step_grads(model, cfg, g, g_last, x, y, mask, pairs=None):
    """Loss and gradients of one train-mode step (no optimizer update), the
    loss as ``train_teacher``'s; graph-dropout masks, where the config draws
    them, from a generator seeded 0; the edgewise loss, where the config has
    it, on the fixed ``pairs``."""
    from gnn_tail_generalization_tpu_torch.train.edgewise import score_pairs
    from gnn_tail_generalization_tpu_torch.train.loops import teacher_loss

    model.train()
    model.zero_grad(set_to_none=True)
    graph_gen = torch.Generator(device=x.device).manual_seed(0)
    common, classi, se_reg, _ = model(g, x, g_last=g_last, graph_generator=graph_gen)
    l_struct = None if pairs is None else score_pairs(common, pairs)[0]
    loss = teacher_loss(cfg, classi, se_reg, y, mask, l_struct)
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def reordered_graph(pd):
    """``pd.graph`` with the edges of every row summed in another order: the
    same adjacency, built from a permuted edge list."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    perm = np.random.default_rng(1).permutation(pd.edge_index.shape[1])
    return build_graph(pd.edge_index[:, perm], pd.n_node, with_dense=False,
                       with_plans=pd.graph.has_plans)


def check_step_parity(cfg, pd, order_floor: bool = False, pairs=None):
    """One step at dropout 0 from fixed weights: f32 kernel vs the plain
    version (spmm method 'gather' calls it directly), within REL_TOL in loss
    and every gradient. Under graph dropout both steps draw their masks from
    a generator seeded 0, and the masks must be equal.

    ``order_floor``: also run the plain step on ``reordered_graph`` and hold
    each quantity to the larger of REL_TOL and 4x the difference that the
    reordering alone makes — for steps whose f32 result depends on the sum
    order by more than REL_TOL (GroupNorm's score gradient, PERF.md).
    ``pairs``: the fixed pairs of the edgewise loss (exp_mode=I2_GTL)."""
    from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
    from gnn_tail_generalization_tpu_torch.nn import graph_dropout as gd
    from gnn_tail_generalization_tpu_torch.train.loops import final_agg_view

    dev = torch.device("cuda")
    g = pd.graph.to(dev)
    g_last = final_agg_view(cfg, pd)
    g_last = g_last.to(dev) if g_last is not None else None
    x = torch.as_tensor(pd.x, device=dev)
    y = torch.as_tensor(pd.y, device=dev)
    mask = torch.as_tensor(pd.train_mask, device=dev)
    cfg_k = dataclasses.replace(cfg, dropout=0.0, spmm_method="pallas")
    kernel_model = TeacherGNN(cfg_k, generator=torch.Generator().manual_seed(0))
    plain_model = copy.deepcopy(kernel_model)
    for m in plain_model.modules():  # same weights, SpMM via the plain version
        if hasattr(m, "spmm_method"):
            m.spmm_method = "gather"
    floor_model = copy.deepcopy(plain_model)
    drawn, draw = [], gd.per_layer_edge_masks

    def record(*args, **kw):
        drawn.append(draw(*args, **kw))
        return drawn[-1]

    gd.per_layer_edge_masks = record
    try:
        loss_k, grads_k = step_grads(kernel_model.to(dev), cfg_k, g, g_last,
                                     x, y, mask, pairs)
        loss_p, grads_p = step_grads(plain_model.to(dev), cfg_k, g, g_last,
                                     x, y, mask, pairs)
    finally:
        gd.per_layer_edge_masks = draw
    if cfg.apply_graph_dropout:
        assert len(drawn) == 2 and drawn[0] is not None, drawn
        assert all(torch.equal(a, b) for a, b in zip(*drawn)), "masks differ"
        kept = [round(m.mean().item(), 4) for m in drawn[0]]
        log(f"  same masks in both steps; kept edge share per layer {kept}")
    floors = {}
    if order_floor:
        assert g_last is None and not cfg.apply_graph_dropout
        loss_f, grads_f = step_grads(floor_model.to(dev), cfg_k,
                                     reordered_graph(pd).to(dev), None, x, y, mask,
                                     pairs)
        floors = {k: rel_err(grads_f[k], grads_p[k]) for k in grads_p}
        floors["loss"] = abs(loss_f - loss_p) / abs(loss_p)
    worst = abs(loss_k - loss_p) / abs(loss_p)
    bound = max(REL_TOL, 4 * floors.get("loss", 0.0))
    log(f"  loss kernel={loss_k:.8f} plain={loss_p:.8f} rel={worst:.3e} "
        f"(bound {bound:.1e})")
    assert worst <= bound, f"step loss rel diff {worst} > {bound}"
    for k in grads_p:
        rel = rel_err(grads_k[k], grads_p[k])
        bound = max(REL_TOL, 4 * floors.get(k, 0.0))
        floor = f" order floor={floors[k]:.3e}" if k in floors else ""
        log(f"  grad {k:32s} {tuple(grads_p[k].shape)} rel={rel:.3e}{floor} "
            f"(bound {bound:.1e})")
        assert torch.isfinite(grads_k[k]).all() and rel <= bound, (k, rel, bound)


def replace_f64(q: np.ndarray, se: np.ndarray, k: int):
    """The replacement op in float64 on the host, written out plainly:
    (output, selected indices ordered by score, then index)."""
    scores = q @ se.T
    idx = np.empty((len(q), k), np.int64)
    for i, s in enumerate(scores):
        kth = np.partition(s, -k)[-k]
        above = np.flatnonzero(s > kth)
        sel = np.concatenate([above, np.flatnonzero(s == kth)[:k - len(above)]])
        idx[i] = sel[np.lexsort((sel, -s[sel]))]
    top = np.take_along_axis(scores, idx, axis=1)
    w = np.exp(top - top.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return np.einsum("bk,bkd->bd", w, se[idx]), idx


def check_replace(cfg, pd, res, card_name) -> dict:
    """(ii): latent_neighbor_replace on the card against the float64 host
    evaluation, on the SEMLP run's own SE table and part-1 queries; and its
    time at the arxiv batch."""
    from gnn_tail_generalization_tpu_torch.models.semlp import SEMLPPart1
    from gnn_tail_generalization_tpu_torch.ops.topk_attention import (
        latent_neighbor_replace, top_k_lowest_index)
    from gnn_tail_generalization_tpu_torch.train.loops import collect_teacher_se

    dev = torch.device("cuda")
    k = cfg.SEMLP_topK_2_replace
    se = collect_teacher_se(cfg, pd, res.extra["teacher"].best_state_dict,
                            device=dev)
    assert se.shape == (pd.n_node, 512), se.shape
    with torch.device("meta"):
        part1 = SEMLPPart1(cfg, se.shape[1])
    part1.load_state_dict(res.extra["part1"].state_dict, assign=True)
    part1.to(dev).eval()
    with torch.no_grad():  # part 2's input: alphas[0] * part 1's output
        q = part1(torch.as_tensor(pd.x[:REPLACE_BATCH], device=dev))
        q = q * res.state_dict["alphas"][0]
    rows = torch.randperm(REPLACE_BATCH, generator=torch.Generator().manual_seed(0))
    qr = q[rows[:REPLACE_ROWS].to(dev)]
    out = latent_neighbor_replace(qr, se, k)
    with torch.no_grad():
        _, idx = top_k_lowest_index(qr @ se.T, k)
    ref, ref_idx = replace_f64(qr.double().cpu().numpy(),
                               se.double().cpu().numpy(), k)
    same = np.array_equal(np.sort(idx.cpu().numpy(), axis=1), np.sort(ref_idx, axis=1))
    abs_err = float(np.abs(out.double().cpu().numpy() - ref).max())
    rel_err = abs_err / max(float(np.abs(ref).max()), 1e-300)
    ms = median_ms(lambda: latent_neighbor_replace(q, se, k), reps=3, warmup=1)
    tflop = 2 * REPLACE_BATCH * se.shape[1] * se.shape[0] / 1e12
    log(f"  latent_neighbor_replace: {REPLACE_ROWS} rows vs float64, same "
        f"neighbours={same}, max_abs_err={abs_err:.3e} rel_err={rel_err:.3e}; "
        f"B={REPLACE_BATCH} K={k} table {tuple(se.shape)}: {ms:.3f} ms "
        f"({tflop:.2f} TFLOP of scores, {tflop / ms * 1e3:.1f} TFLOP/s) "
        f"[{card_name}]")
    assert same, "the card selected other neighbours than the float64 evaluation"
    assert rel_err <= REL_TOL, f"replace rel err {rel_err} > {REL_TOL}"
    # one row chunk of the op, split into its score matmul and its selection
    chunk = q[:8192]
    with torch.no_grad():
        mm_ms = median_ms(lambda: chunk @ se.T, reps=5, warmup=1)
        scores = chunk @ se.T
        sel_ms = median_ms(lambda: top_k_lowest_index(scores, k), reps=5, warmup=1)
    del scores
    log(f"  one {tuple(chunk.shape)} chunk: score matmul {mm_ms:.3f} ms "
        f"({tflop * chunk.shape[0] / REPLACE_BATCH / mm_ms * 1e3:.1f} "
        f"TFLOP/s), top-K selection "
        f"{sel_ms:.3f} ms [{card_name}]")
    return {"rows": REPLACE_ROWS, "rel_err": rel_err, "batch": REPLACE_BATCH,
            "ms": ms, "chunk_matmul_ms": mm_ms, "chunk_select_ms": sel_ms}


def student_phase(pd, teacher_launches: int, card_name: str,
                  totals: dict) -> dict:
    """Phase 4: the Cold Brew student on the card."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    log("  (i) SEMLP through the port's main")
    K.reset_launch_counts()
    res = port_main.main(SEMLP_ARGS)[0]
    counts = dict(K.LAUNCHES)
    log(f"  launch counts over the SEMLP run: {counts}")
    cfg = port_main.fitted_to(
        build_config(**port_main.parse_args(SEMLP_ARGS)[0]), pd)
    # the teacher's steps as in phase 3, plus the SE-table forward
    expect = {"spmm_csr_f32": teacher_launches + cfg.num_layers,
              "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    assert counts == expect, f"SEMLP launched {counts}, expected {expect}"
    for k, v in counts.items():
        totals[k] += v
    phases = {"teacher": res.extra["teacher"], "part1": res.extra["part1"],
              "part2": res}
    assert res.columns == STUDENT_COLS, res.columns
    for name, r in phases.items():
        assert r.records.shape[0] == 3 and np.isfinite(r.records).all(), (name, r.records)

    log("  (ii) latent_neighbor_replace on the card")
    replace = check_replace(cfg, pd, res, card_name)

    log("  (iii) StudentBaseMLP (arxiv shape) and GraphMLP (Cora stand-in)")
    for argv in STUDENT_RUNS:
        K.reset_launch_counts()
        r = port_main.main(argv)[0]
        counts = dict(K.LAUNCHES)
        log(f"  {argv[1]}: launch counts {counts}, step_ms {r.step_ms}, "
            f"eval_ms {r.eval_ms} [{card_name}]")
        assert not any(counts.values()), f"{argv[1]} launched {counts}"
        assert r.columns == STUDENT_COLS and r.records.shape == (3, 5), r.columns
        assert np.isfinite(r.records).all(), r.records

    log("  (iv) SEMLP times per epoch")
    times = {name: r.step_ms for name, r in phases.items()}
    times["part2_eval"] = res.eval_ms
    for name, t in times.items():
        log(f"  {name:10s} ms {[round(v, 3) for v in t]} [{card_name}]")
    return {"step_ms": times, "replace": replace}


def expected_launches(cfg, epochs: int) -> dict:
    """The SpMM launches of ``epochs`` teacher epochs: per layer two in the
    train step (forward and the transposed backward) and one in the eval
    forward. Masked graphs have no plans, so their SpMMs run the f32 kernel
    under every method; the eval forward runs on the full graph."""
    counts = {"spmm_csr_f32": 0, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    bf16 = cfg.spmm_method == "pallas_bf16"
    train = "spmm_csr_f32" if cfg.apply_graph_dropout or not bf16 else "spmm_csr_bf16"
    counts[train] += 2 * cfg.num_layers * epochs
    counts["spmm_csr_bf16" if bf16 else "spmm_csr_f32"] += cfg.num_layers * epochs
    return counts


def trick_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 5: the trick zoo through the port's main."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    step_ms = {}
    for name, extra in TRICK_RUNS.items():
        argv = TRICK_BASE + extra
        cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
        K.reset_launch_counts()
        res = port_main.main(argv)[0]
        counts = dict(K.LAUNCHES)
        expect = expected_launches(cfg, 3)
        assert counts == expect, f"{name} launched {counts}, expected {expect}"
        assert res.records.shape[0] == 3 and np.isfinite(res.records).all(), (
            name, res.records)
        for k, v in counts.items():
            totals[k] += v
        step_ms[name] = res.step_ms
        log(f"  {name:22s} launches {counts} step_ms "
            f"{[round(v, 3) for v in res.step_ms]} [{card_name}]")
    for name, order_floor in TRICK_PARITY.items():
        argv = TRICK_BASE + TRICK_RUNS[name]
        cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
        log(f"  one-step parity, {name}, f32 kernel vs plain version (dropout 0):")
        check_step_parity(cfg, pd, order_floor)
    return step_ms


def propagation_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 6: --train_which=LP through main, and C&S."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
    from gnn_tail_generalization_tpu_torch.propagation import correlation as corr
    from gnn_tail_generalization_tpu_torch.propagation import cs

    dev = torch.device("cuda")
    log("  (i) --train_which=LP through the port's main")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = port_main.main(LP_ARGS)[0]
    lp_s = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    log(f"  LP result {res}, launch counts {counts}, run {lp_s:.3f} s [{card_name}]")
    assert set(res) == {"acc_train", "acc_test"} and all(
        np.isfinite(v) for v in res.values()), res
    n_prop = 50  # run_pure_lp's
    assert counts == {"spmm_csr_f32": n_prop, "spmm_csr_bf16": 0,
                      "spmm_csr_plain": 0}, counts
    for k, v in counts.items():
        totals[k] += v

    dad = corr.gen_normalized_adjs(pd.edge_index, pd.n_node, which={"DAD"})[0].to(dev)
    y = torch.as_tensor(pd.y, device=dev)
    idx = torch.as_tensor(pd.train_idx, device=dev)
    nc = int(pd.y.max()) + 1

    def propagate(method):
        return corr.label_propagation(y, idx, dad, 0.5, n_prop, nc, method)

    out_k, out_p = propagate("auto"), propagate("gather")
    rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    assert out_k.shape == (pd.n_node, nc) and torch.isfinite(out_k).all()
    assert rel <= REL_TOL, f"LP propagation rel err {rel} > {REL_TOL}"
    lp_ms = median_ms(lambda: propagate("auto"), reps=3, warmup=1)
    x40 = torch.rand(pd.n_node, nc, device=dev)
    spmm_ms = median_ms(lambda: spmm(dad, x40))
    log(f"  LP [{pd.n_node}, {nc}] kernel vs plain rel={rel:.3e}; {n_prop} "
        f"propagations {lp_ms:.3f} ms, {lp_ms / n_prop:.4f} ms each; one DAD "
        f"SpMM at d={nc} ({dad.n_edge} edges) {spmm_ms:.4f} ms [{card_name}]")

    log(f"  (ii) run_cs_pipeline, diffusion features, {CS_EPOCHS} mid-step epochs")
    cfg = port_main.fitted_to(build_config(
        dataset="ogbn-arxiv", train_which="LP", force_set_to_best_config=False), pd)
    cfg = dataclasses.replace(cfg, preStep=dataclasses.replace(
        cfg.preStep, pre_methods="diffusion"))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cs_res = cs.run_cs_pipeline(cfg, pd, epochs=CS_EPOCHS, device=dev)
    torch.cuda.synchronize()
    cs_s = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    lp = cfg.lpStep
    n_cs = lp.num_propagations1 + lp.num_propagations2
    log(f"  C&S acc_train={cs_res['acc_train']:.2f} acc_test={cs_res['acc_test']:.2f}"
        f" launches {counts}, pipeline {cs_s:.3f} s [{card_name}]")
    assert counts == {"spmm_csr_f32": n_cs, "spmm_csr_bf16": 0,
                      "spmm_csr_plain": 0}, counts
    assert torch.isfinite(cs_res["out"]).all() and np.isfinite(cs_res["acc_test"])
    for k, v in counts.items():
        totals[k] += v

    gen = torch.Generator(device=dev).manual_seed(0)
    model_out = torch.softmax(torch.randn(pd.n_node, nc, generator=gen, device=dev), 1)

    def step(method):
        return cs.lp_step(cfg, pd, model_out, idx, idx, spmm_method=method)

    t0 = time.perf_counter()
    cs_k = step("auto")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    cs_p = step("gather")
    rel_cs = ((cs_k - cs_p).abs().max() / cs_p.abs().max()).item()
    assert rel_cs <= REL_TOL, f"lp_step rel err {rel_cs} > {REL_TOL}"
    _, da, ad = (a if a is None else a.to(dev) for a in corr.gen_normalized_adjs(
        pd.edge_index, pd.n_node, which={lp.A1, lp.A2}))
    assert (lp.fn, lp.A1, lp.A2) == ("double_correlation_autoscale", "DA", "AD")
    cs_ms = median_ms(lambda: corr.double_correlation_autoscale(
        y, model_out, idx, idx, da, lp.alpha1, lp.num_propagations1, ad,
        lp.alpha2, lp.num_propagations2, nc), reps=3, warmup=1)
    log(f"  lp_step kernel vs plain rel={rel_cs:.3e}; lp_step {step_s * 1e3:.3f} ms "
        f"(host adjacency builds included); its {n_cs} propagations on the "
        f"card {cs_ms:.3f} ms [{card_name}]")
    return {"lp": res, "lp_rel_err": rel, "lp_ms": lp_ms,
            "propagation_ms": lp_ms / n_prop, "dad_spmm_ms": spmm_ms,
            "cs_acc_test": cs_res["acc_test"], "lp_step_rel_err": rel_cs,
            "cs_propagations_ms": cs_ms, "cs_pipeline_s": cs_s}


def lp_split(n_node: int, n_edge: int):
    """bench_linkpred.py:49-97 with the port's host copies: a power-law graph,
    EVAL_POS valid and EVAL_POS test positives with EVAL_NEG sampled
    non-edges each, the other edges train; message edges = symmetrize(train).
    Returns (split_edge, message edges, host seconds)."""
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import symmetrize
    from gnn_tail_generalization_tpu_torch.linkpred import sampling

    t0 = time.perf_counter()
    e = fast_powerlaw_graph(n_node, n_edge, 0)
    perm = np.random.default_rng(0).permutation(e.shape[1])
    val, test = e[:, perm[:EVAL_POS]], e[:, perm[EVAL_POS:2 * EVAL_POS]]
    train = e[:, perm[2 * EVAL_POS:]]
    negs = sampling.rejection_sample_non_edges(
        np.random.default_rng(1), sampling.edge_keys(e, n_node), n_node,
        2 * EVAL_POS * EVAL_NEG)
    split_edge = {
        "train": {"edge": train.T},
        "valid": {"edge": val.T, "edge_neg": negs[:EVAL_POS * EVAL_NEG]},
        "test": {"edge": test.T, "edge_neg": negs[EVAL_POS * EVAL_NEG:]},
    }
    return split_edge, symmetrize(train, n_node), time.perf_counter() - t0


@contextlib.contextmanager
def plain_kernels():
    """Route ``spmm``'s kernel calls to the plain version (the bf16 one with
    its rounding), for the parity steps."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    def plain(bf16):
        return lambda ip, ix, w, x, schedule=None: K.spmm_csr_plain(ip, ix, w, x, bf16=bf16)

    saved = K.spmm_csr_f32, K.spmm_csr_bf16
    K.spmm_csr_f32, K.spmm_csr_bf16 = plain(False), plain(True)
    try:
        yield
    finally:
        K.spmm_csr_f32, K.spmm_csr_bf16 = saved


def lp_grads(cfg, model, g, x, batch):
    """Loss and gradients of one train-mode step (no update) on graph ``g``,
    the hoisted aggregation recomputed for it."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

    const = lpm.link_const(cfg, g, x)
    model.train()
    model.zero_grad(set_to_none=True)
    loss = lpm.make_loss_fn(cfg, model)(const, *batch)
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def lp_parity(cfg, g, g_reordered, x, train_edges, tag) -> dict:
    """One step at dropout 0 from fixed weights, the kernels against the
    plain versions, in loss and every gradient: each within the larger of
    REL_TOL and 4x the plain step's own sum-order floor (the same plain step
    on ``g_reordered``, the edges of every row summed in another order)."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

    dev = x.device
    cfg = dataclasses.replace(cfg, dropout=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = lpm.LinkPredModel(cfg, g.n_node, x.shape[1], generator=gen)
    b = cfg.batch_size
    pos = torch.as_tensor(train_edges[:b].astype(np.int64), device=dev)
    neg = torch.randint(0, g.n_node, (b, cfg.num_neg, 2), generator=gen, device=dev)
    valid = (torch.arange(b, device=dev) < b * 3 // 4).float()
    batch = (pos, neg, None, valid)
    loss_k, grads_k = lp_grads(cfg, model, g, x, batch)
    with plain_kernels():
        loss_p, grads_p = lp_grads(cfg, model, g, x, batch)
        loss_f, grads_f = lp_grads(cfg, model, g_reordered, x, batch)
    rows = {"loss": (abs(loss_k - loss_p) / abs(loss_p),
                     abs(loss_f - loss_p) / abs(loss_p))}
    for k in grads_p:
        assert torch.isfinite(grads_k[k]).all(), (tag, k)
        rows[k] = (rel_err(grads_k[k], grads_p[k]), rel_err(grads_f[k], grads_p[k]))
    log(f"  {tag}: loss kernel={loss_k:.8f} plain={loss_p:.8f}")
    for k, (rel, floor) in rows.items():
        bound = max(REL_TOL, 4 * floor)
        log(f"  {tag} {k:32s} rel={rel:.3e} order floor={floor:.3e} "
            f"(bound {bound:.1e})")
        assert rel <= bound, (tag, k, rel, bound)
    return {k: {"rel": r, "floor": f} for k, (r, f) in rows.items()}


def lp_timed(cfg, g, x, split_edge, msg, card_name) -> dict:
    """The bench config's TIMED_STEPS-step epoch (best of 2 after a warm-up)
    and the warm OGB-style eval: EVAL_POS positives x OGB_NEG uniform
    destinations, one encode, chunked scoring, grouped MRR."""
    from gnn_tail_generalization_tpu_torch.linkpred import metrics as M
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.linkpred import sampling

    dev, n, bsz = x.device, g.n_node, cfg.batch_size
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.device(dev):
        model = lpm.LinkPredModel(cfg, n, x.shape[1], generator=gen)
    const = lpm.link_const(cfg, g, x)
    epoch = lpm.make_epoch_fn(cfg, model, lpm.make_optimizer(cfg, model.parameters()),
                              n, TIMED_STEPS, bsz, TIMED_STEPS * bsz)
    pos_all = torch.as_tensor(
        split_edge["train"]["edge"][:TIMED_STEPS * bsz].astype(np.int64), device=dev)
    keys = sampling.build_membership(sampling.edge_keys(msg, n)).to(dev)
    model.train()
    epoch_s = []
    for _ in range(3):  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = epoch(const, pos_all, keys, gen)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        assert torch.isfinite(losses).all(), losses
    best = min(epoch_s[1:])
    log(f"  {TIMED_STEPS}-step epoch s {[round(s, 4) for s in epoch_s]} (first warms "
        f"up): {best / TIMED_STEPS * 1e3:.3f} ms a step [{card_name}]")

    val = torch.as_tensor(split_edge["valid"]["edge"][:EVAL_POS].astype(np.int64),
                          device=dev)
    neg = torch.stack([val[:, 0].repeat_interleave(OGB_NEG),
                       torch.randint(0, n, (EVAL_POS * OGB_NEG,), generator=gen,
                                     device=dev)], dim=1)

    def ogb_eval():
        model.eval()
        with torch.no_grad():
            h = lpm.encode_all(model, const)
            pos_s = lpm.predict_chunked(model, h, val, chunk=512 * 1024)
            neg_s = lpm.predict_chunked(model, h, neg, chunk=512 * 1024)
        return M.mrr(pos_s, neg_s.reshape(EVAL_POS, OGB_NEG))  # reads back

    ogb_eval()
    eval_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        mrr = ogb_eval()
        eval_s.append(time.perf_counter() - t0)
    assert np.isfinite(mrr), mrr
    log(f"  OGB eval: {EVAL_POS} positives x {OGB_NEG} destinations, MRR={mrr:.4f}, "
        f"warm s {[round(s, 4) for s in eval_s]} [{card_name}]")
    return {"epoch_s": epoch_s, "step_ms": best / TIMED_STEPS * 1e3,
            "ogb_eval_s": min(eval_s), "ogb_mrr": mrr}


def run_linkpred(cfg, x, split_edge, msg, n_node, expect, tag, card_name,
                 totals, dev, **kw) -> dict:
    """``train_linkpred`` on the card with the launch counts reset before and
    read after; fails unless they equal ``expect`` and every loss and
    statistic is finite."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    expect = {k: expect.get(k, 0) for k in K.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = lpm.train_linkpred(cfg, x, msg, n_node, split_edge=split_edge,
                             msg_edges=msg, log_every=1, device=dev, **kw)
    counts = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {tag}: launches {counts}, epoch s {[round(s, 4) for s in out['epoch_s']]}, "
        f"losses {out['epoch_loss']}, {out['last_results']}, peak {peak_gb:.2f} GiB "
        f"[{card_name}]")
    assert counts == expect, f"{tag} launched {counts}, expected {expect}"
    assert np.isfinite(out["epoch_loss"]).all(), out["epoch_loss"]
    assert all(np.isfinite(v) for v in out["stats"].values()), out["stats"]
    for k, v in counts.items():
        totals[k] += v
    return {"launches": counts, "epoch_s": out["epoch_s"],
            "epoch_loss": out["epoch_loss"], "results": out["last_results"],
            "peak_gib": peak_gb}


def linkpred_phase(card_name: str, totals: dict, dev) -> dict:
    """Phase 7: I2-GTL link prediction at the ogbl-citation2 shape."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    t_phase = time.perf_counter()
    split_edge, msg, split_s = lp_split(C2_NODES, C2_EDGES)
    # the JAX package's bench config (bench_linkpred.py:100-105) and the
    # reference's default; both train SAGE on the same message graph
    bench = lpm.LinkPredConfig(
        encoder="SAGE", predictor="DOT", loss_func="ce_loss", use_node_feats=True,
        train_node_emb=False, eval_metric="mrr", num_neg=3, batch_size=64 * 1024,
        spmm_method="pallas_bf16")
    default = lpm.LinkPredConfig()
    t0 = time.perf_counter()
    g_host = lpm.link_graph(bench, msg, C2_NODES)
    csr_s = time.perf_counter() - t0
    g = g_host.to(dev)
    max_in = int((g_host.indptr[1:] - g_host.indptr[:-1]).max())
    log(f"  citation2-shape graph: n_node={g.n_node} message edges={g.n_edge} "
        f"max_in_degree={max_in}; host build: split {split_s:.1f} s, CSR pair "
        f"{csr_s:.1f} s")

    log("  (i) both kernels against the plain version on the citation2 graph, d=256")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_ms = {}
    for tag, gg in (("citation2 fwd", g), ("citation2 transposed", g.transpose())):
        x = torch.randn(gg.n_node, 256, generator=gen, device=dev)
        for name, fn, bf16 in (("spmm_csr_f32", K.spmm_csr_f32, False),
                               ("spmm_csr_bf16", K.spmm_csr_bf16, True)):
            kernel_ms[f"{name} {tag}"] = compare(name, fn, gg, x, bf16, card_name, tag,
                                                 reps=5)
        del x
    torch.cuda.empty_cache()

    x = torch.randn(C2_NODES, C2_FEATS, generator=gen, device=dev)
    steps = 2 * 8
    log("  (ii) the bench config through train_linkpred: 2 epochs of 8 steps")
    # bf16 launches: 1 hoisted layer-1 aggregation, 2 per train step (layer-2
    # forward and its transposed backward), 1 per eval encode (layer 2)
    bench_run = run_linkpred(
        bench, x, split_edge, msg, C2_NODES, {"spmm_csr_bf16": 1 + 2 * steps + 1},
        "bench config", card_name, totals, dev, epochs=2, eval_steps=2,
        max_steps_per_epoch=8)
    assert np.isfinite(bench_run["results"]["MRR"]).all()
    log("  (iii) the bench config's timed epoch and OGB-style eval")
    timed = lp_timed(bench, g, x, split_edge, msg, card_name)
    torch.cuda.empty_cache()

    log("  (iv) LinkPredConfig() through train_linkpred: 2 epochs of 8 steps")
    # f32 launches: per step the layer-1 and layer-2 forwards and both
    # transposed backwards (the embedding trains), 2 per eval encode
    default_run = run_linkpred(
        default, None, split_edge, msg, C2_NODES, {"spmm_csr_f32": 4 * steps + 2},
        "default config", card_name, totals, dev, epochs=2, eval_steps=2,
        max_steps_per_epoch=8)
    torch.cuda.empty_cache()

    log("  (v) one-step parity on the citation2 graph, kernels vs plain (dropout 0)")
    perm = np.random.default_rng(2).permutation(msg.shape[1])
    g_re = lpm.link_graph(bench, msg[:, perm], C2_NODES).to(dev)
    train_edges = split_edge["train"]["edge"]
    parity = {"bench": lp_parity(bench, g, g_re, x, train_edges, "bench"),
              "default": lp_parity(default, g, g_re,
                                   torch.zeros(C2_NODES, 1, device=dev),
                                   train_edges, "default")}
    del g_re, x
    torch.cuda.empty_cache()

    log("  (vi) GCN and Transformer at the bench shape: 2 steps each")
    split_b, msg_b, _ = lp_split(BENCH_NODES, BENCH_EDGES)
    others = {}
    for kind, expect in (("GCN", {"spmm_csr_f32": 2 * 4 + 2}), ("Transformer", {})):
        others[kind] = run_linkpred(
            lpm.LinkPredConfig(encoder=kind), None, split_b, msg_b, BENCH_NODES,
            expect, kind, card_name, totals, dev, epochs=1, max_steps_per_epoch=2)

    log("  (vii) --exp_mode=I2_GTL through the port's main (2,000-node stand-in)")
    K.reset_launch_counts()
    cli = port_main.main(I2GTL_ARGS)[0]
    assert not any(K.LAUNCHES.values()), K.LAUNCHES  # the dense product
    assert all(np.isfinite(v) for v in cli.values()), cli
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 7: {phase_s:.1f} s")

    return {"phase_s": phase_s, "n_node": C2_NODES, "n_msg_edges": g.n_edge, "max_in_degree": max_in,
            "host_build_s": {"split": split_s, "csr_pair": csr_s},
            "kernels_d256": kernel_ms,
            "bench": {**bench_run, "step_ms": bench_run["epoch_s"][1] / 8 * 1e3},
            "bench_timed": timed,
            "default": {**default_run,
                        "step_ms": default_run["epoch_s"][1] / 8 * 1e3},
            "parity": parity, "others": others, "cli": cli}


def reader_phase(card_name: str, totals: dict, root: str) -> dict:
    """Phase 8 (i): the full-size fake ogbn-arxiv raw set through the reader,
    prepare, and 3 epochs through main --data_root under auto."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.data.datasets import load_dataset, prepare
    from gnn_tail_generalization_tpu_torch.data.synthetic import write_fake_ogbn_arxiv_raw
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    t0 = time.perf_counter()
    write_fake_ogbn_arxiv_raw(root)
    write_s = time.perf_counter() - t0
    cfg = build_config(**port_main.parse_args(READER_ARGS)[0])
    t0 = time.perf_counter()
    data = load_dataset(cfg, root)
    read_s = time.perf_counter() - t0
    assert data.name == "ogbn-arxiv", f"the reader did not fire: {data.name}"
    assert data.x.shape == (BENCH_NODES, 128) and data.x.dtype == np.float32
    assert int(data.y.max()) == 39 and int(data.train_mask.sum()) == 90941
    t0 = time.perf_counter()
    pd = prepare(data, cfg)
    prepare_s = time.perf_counter() - t0
    log(f"  fake ogbn-arxiv raw set: write {write_s:.2f} s, read {read_s:.2f} s, "
        f"prepare {prepare_s:.2f} s; {pd.n_node} nodes, {data.edge_index.shape[1]} "
        f"edges read, {pd.graph.n_edge} after the pipeline [{card_name} host]")
    K.reset_launch_counts()
    res = port_main.main(READER_ARGS + [f"--data_root={root}"])[0]
    counts = dict(K.LAUNCHES)
    expect = expected_launches(cfg, 3)
    log(f"  main --data_root: launches {counts}, step_ms "
        f"{[round(v, 3) for v in res.step_ms]} [{card_name}]")
    assert counts == expect, f"the reader-fed teacher launched {counts}, expected {expect}"
    assert res.records.shape == (3, 6) and np.isfinite(res.records).all(), res.records
    for k, v in counts.items():
        totals[k] += v
    return {"write_s": write_s, "read_s": read_s, "prepare_s": prepare_s,
            "n_edge": pd.graph.n_edge, "launches": counts, "step_ms": res.step_ms}


def i2gtl_phase(pd, card_name: str, totals: dict, slice_step_ms: dict) -> dict:
    """Phase 8 (ii): the I2-GTL teacher on the arxiv slice through main under
    both kernels, and one step of the f32 kernel against the plain version
    with fixed pairs."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.train import edgewise as ew

    out = {}
    for method in ("auto", "pallas_bf16"):
        argv = I2GTL_NODEC_ARGS + [f"--spmm_method={method}"]
        cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
        K.reset_launch_counts()
        res = port_main.main(argv)[0]
        counts = dict(K.LAUNCHES)
        # no loss-masked view under the edgewise loss: 2 launches a layer in
        # the train step (forward, transposed backward), 1 in the eval
        expect = expected_launches(cfg, 3)
        assert counts == expect, f"I2-GTL ({method}) launched {counts}, expected {expect}"
        assert res.columns[-2:] == ["linkp_train", "linkp_test"], res.columns
        mrr = res.records[:, -2:]
        assert np.isfinite(res.records).all() and (mrr > 0).all() and (mrr <= 1).all(), (
            res.records)
        for k, v in counts.items():
            totals[k] += v
        log(f"  I2-GTL nodeC ({method}): launches {counts}, linkp_train/test "
            f"{mrr.round(4).tolist()}, step_ms {[round(v, 3) for v in res.step_ms]} "
            f"(phase 3: {[round(v, 3) for v in slice_step_ms[method]]}) [{card_name}]")
        out[method] = {"launches": counts, "step_ms": res.step_ms,
                       "linkp": mrr.tolist()}
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(
        I2GTL_NODEC_ARGS)[0]), pd)
    plan = ew.build_edgewise_plan(cfg, pd)
    dev = torch.device("cuda")
    pairs = ew.draw_pairs(plan, ew.edgewise_consts(plan, dev),
                          torch.Generator(device=dev).manual_seed(0), "train")
    log("  one-step parity, I2-GTL, f32 kernel vs plain version, fixed pairs "
        "(dropout 0):")
    check_step_parity(cfg, pd, order_floor=True, pairs=pairs)
    return out


def edge_grad_phase(gb, card_name: str) -> dict:
    """Phase 8 (iii): spmm_edge_grad on the bench-shape graph at d=256, the
    f32 kernel (the reweighted graph has no plans) against the plain
    version: y, dx and dw, and the forward + backward ms."""
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm_edge_grad

    dev = torch.device("cuda")
    g = gb.to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(g.n_node, 256, generator=gen, device=dev)
    w = torch.rand(g.n_edge, generator=gen, device=dev)
    dy = torch.randn(g.n_node, 256, generator=gen, device=dev)

    def run(method):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = spmm_edge_grad(g, xx, ww, method)
        y.backward(dy)
        return y.detach(), xx.grad, ww.grad

    got, want = run("auto"), run("gather")
    rels = {k: rel_err(a, b) for k, a, b in zip(("y", "dx", "dw"), got, want)}
    del got, want
    ms = median_ms(lambda: run("auto"), reps=10)
    plain_ms = median_ms(lambda: run("gather"), reps=5)
    errs = {k: f"{v:.3e}" for k, v in rels.items()}
    log(f"  spmm_edge_grad, bench graph ({g.n_edge} edges) d=256: rel err {errs}, "
        f"forward + backward {ms:.4f} ms (plain version {plain_ms:.4f} ms) "
        f"[{card_name}]")
    assert all(v <= REL_TOL for v in rels.values()), rels
    return {"rel_err": rels, "ms": ms, "plain_ms": plain_ms}


def multiseed_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 8 (iv): --N_exp through main, each seed's records against
    train_teacher from that seed, bit for bit."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.train.loops import train_teacher

    argv = READER_ARGS + [f"--N_exp={N_EXP}"]
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = port_main.main(argv)
    run_s = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    expect = expected_launches(cfg, 3 * N_EXP)
    assert counts == expect, f"--N_exp={N_EXP} launched {counts}, expected {expect}"
    for k, v in counts.items():
        totals[k] += v
    same = []
    for s, res in enumerate(results):
        one = train_teacher(cfg, pd, cfg.random_seed + s, 3, device="cuda")
        same.append(bool(np.array_equal(res.records, one.records)))
    log(f"  --N_exp={N_EXP}: launches {counts}, run {run_s:.2f} s, each seed's "
        f"records bit-identical to a single train_teacher run: {same} [{card_name}]")
    assert len(results) == N_EXP and all(same), same
    return {"launches": counts, "run_s": run_s, "bit_identical": same}


def checkpoint_phase(pd, card_name: str, totals: dict, root: str) -> dict:
    """Phase 8 (v): a save_dir checkpoint read back onto the card, and a
    --prog run repeated."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.train.checkpoint import load_train_state
    from gnn_tail_generalization_tpu_torch.train.loops import train_teacher

    dev = torch.device("cuda")
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(READER_ARGS)[0]), pd)
    K.reset_launch_counts()
    res = train_teacher(cfg, pd, 0, 3, device=dev, save_dir=root)
    counts = dict(K.LAUNCHES)
    assert counts == expected_launches(cfg, 3), counts
    for k, v in counts.items():
        totals[k] += v
    state = load_train_state(os.path.join(root, "teacherGNN.pt"), map_location=dev)
    g, x = pd.graph.to(dev), torch.as_tensor(pd.x, device=dev)
    outs = []
    for sd in (res.state_dict, state["params"]):
        model = TeacherGNN(cfg).to(dev)
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            outs.append(model(g, x)[1])
    same = bool(torch.equal(*outs))
    log(f"  save_dir round trip: state epoch {state['epoch']}, eval forward "
        f"bit-identical after the reload: {same} [{card_name}]")
    assert same and state["epoch"] == 3

    argv = READER_ARGS + ["--epochs=1", "--prog=0-1", f"--records_path={root}"]
    K.reset_launch_counts()
    first = port_main.main(argv)
    first_counts = dict(K.LAUNCHES)
    K.reset_launch_counts()
    again = port_main.main(argv)
    again_counts = dict(K.LAUNCHES)
    log(f"  --prog=0-1: first run launches {first_counts}, repeated run "
        f"{len(again)} results, launches {again_counts}")
    assert len(first) == 1 and first_counts == expected_launches(cfg, 1), first_counts
    assert again == [] and not any(again_counts.values()), again_counts
    for k, v in first_counts.items():
        totals[k] += v
    return {"reload_bit_identical": same, "prog_first_launches": first_counts,
            "prog_repeat_launches": again_counts}


def cli_phase(gb, pd, card_name: str, totals: dict, slice_step_ms: dict) -> dict:
    """Phase 8: the rest of the single-device CLI on the card. Its files go
    to a directory under ``_chip/`` (gitignored), removed at the end."""
    t_phase = time.perf_counter()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_chip")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase8-", dir=scratch)
    try:
        log("  (i) a full-size fake ogbn-arxiv raw set through the reader and main")
        readers = reader_phase(card_name, totals, os.path.join(root, "data"))
        torch.cuda.empty_cache()
        log("  (ii) --exp_mode=I2_GTL --task=nodeC on the arxiv slice")
        i2gtl = i2gtl_phase(pd, card_name, totals, slice_step_ms)
        log("  (iii) spmm_edge_grad against the plain version")
        edge_grad = edge_grad_phase(gb, card_name)
        torch.cuda.empty_cache()
        log(f"  (iv) --N_exp={N_EXP} through main")
        multiseed = multiseed_phase(pd, card_name, totals)
        log("  (v) a save_dir checkpoint and a repeated --prog run")
        ckpt = checkpoint_phase(pd, card_name, totals, os.path.join(root, "runs"))
    finally:
        shutil.rmtree(root)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 8: {phase_s:.1f} s")
    return {"phase_s": phase_s, "readers": readers, "i2gtl": i2gtl,
            "spmm_edge_grad": edge_grad, "multiseed": multiseed, "checkpoint": ckpt}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import (
        build_graph, standard_pipeline)
    from gnn_tail_generalization_tpu_torch.ops import _build
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.train.loops import final_agg_view

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = card()
    dev = torch.device("cuda")

    log("== phase 1: environment")
    log(f"card: {card_name}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    log(f"nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    log(f"kernels built into {_build.load()._name}")
    log(f"build_s={time.perf_counter() - t0:.2f}")

    log("== phase 2: kernels vs plain versions on the card")
    t0 = time.perf_counter()
    n = 169343
    gb = build_graph(standard_pipeline(fast_powerlaw_graph(n, 1_166_243, 0), n),
                     n, with_dense=False)
    max_in = int((gb.indptr[1:] - gb.indptr[:-1]).max())
    log(f"bench-shape graph: n_node={gb.n_node} n_edge={gb.n_edge} "
        f"max_in_degree={max_in} (host build {time.perf_counter() - t0:.1f} s)")
    cfg, pd = slice_data()
    g_last = final_agg_view(cfg, pd)
    log(f"slice graph: n_node={pd.graph.n_node} n_edge={pd.graph.n_edge}; "
        f"loss-masked view n_edge={g_last.n_edge}")
    gen = torch.Generator(device=dev).manual_seed(0)
    bg, sg = boundary_graph(), star_graph()
    log(f"degree-boundary graph: n_node={bg.n_node} n_edge={bg.n_edge}; star graph: "
        f"n_node={sg.n_node} n_edge={sg.n_edge}, {STAR_EDGES} edges into node 0")
    graphs = [("bench fwd", gb.to(dev), (256, 40)),
              ("bench transposed", gb.transpose().to(dev), (256, 40)),
              ("slice fwd", pd.graph.to(dev), (256,)),
              ("slice transposed", pd.graph.transpose().to(dev), (256,)),
              ("slice loss-masked fwd", g_last.to(dev), (256,)),
              ("slice loss-masked transp.", g_last.transpose().to(dev), (256,)),
              ("hub rows", hub_graph().to(dev), (16,)),
              ("degree boundary fwd", bg.to(dev), (256, 40, 16, 33)),
              ("degree boundary transp.", bg.transpose().to(dev), (256, 40, 16, 33)),
              ("star fwd", sg.to(dev), (256, 40)),
              ("star transposed", sg.transpose().to(dev), (256, 40))]
    kernels = (("spmm_csr_f32", K.spmm_csr_f32, False),
               ("spmm_csr_bf16", K.spmm_csr_bf16, True))
    stats = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS}
    for tag, g, widths in graphs:
        for d in widths:
            if tag.startswith("star"):
                # multiples of 1/8 in [-1, 1]: every partial sum of the
                # 1M-edge row is exact in f32, in any order
                x = torch.randint(-8, 9, (g.n_node, d), generator=gen, device=dev) / 8
            else:
                x = torch.randn(g.n_node, d, generator=gen, device=dev)
            for name, fn, bf16 in kernels:
                r = compare(name, fn, g, x, bf16, card_name, tag)
                st = stats[name]
                st["max_abs_err"] = max(st["max_abs_err"], r["max_abs_err"])
                st["max_rel_err"] = max(st["max_rel_err"], r["rel_err"])
                if tag == "bench fwd" and d == 256:
                    st.update({k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "share_of_bound")})
                    again = [fn(g.indptr, g.indices, g.weight, x, schedule=g.schedule)
                             for _ in range(2)]
                    same = torch.equal(*again)
                    log(f"  {name:14s} two launches on the bench graph bit-identical: {same}")
                    assert same, f"{name}: two launches differ"
                if tag == "degree boundary fwd" and d == 40:
                    direct = fn(g.indptr, g.indices, g.weight, x)  # builds its schedule
                    same = torch.equal(direct, fn(g.indptr, g.indices, g.weight, x,
                                                  schedule=g.schedule))
                    log(f"  {name:14s} call without a schedule bit-identical: {same}")
                    assert same, f"{name}: the schedule built from indptr differs"
    del graphs, bg, sg  # gb (on the host) returns in phase 8
    torch.cuda.empty_cache()

    log("== phase 3: the slice through the port's main")
    launches, step_ms = {}, {}
    totals = {k: 0 for k in K.LAUNCHES}  # launches over every phase
    for method, kernel in (("auto", "spmm_csr_f32"),
                           ("pallas_bf16", "spmm_csr_bf16")):
        K.reset_launch_counts()
        results = port_main.main(SLICE_ARGS + [f"--spmm_method={method}"])
        counts = dict(K.LAUNCHES)
        log(f"  launch counts after --spmm_method={method}: {counts}")
        assert counts[kernel] > 0, f"{kernel} never launched on the slice"
        expect = {k: (counts[kernel] if k == kernel else 0) for k in K.LAUNCHES}
        assert counts == expect, f"--spmm_method={method} launched {counts}"
        launches[kernel] = counts[kernel]
        rec = results[0].records
        assert rec.shape == (3, 6) and np.isfinite(rec).all(), rec
        for k, v in counts.items():
            totals[k] += v
        step_ms[method] = results[0].step_ms
        log(f"  step_ms ({method}) = {step_ms[method]} [{card_name}]")
    log("  one-step parity, f32 kernel vs plain version (dropout 0):")
    check_step_parity(cfg, pd)

    log("== phase 4: the Cold Brew student")
    student = student_phase(pd, launches["spmm_csr_f32"], card_name, totals)

    log("== phase 5: the trick zoo through the port's main")
    tricks = trick_phase(pd, card_name, totals)

    log("== phase 6: label propagation and Correct & Smooth")
    propagation = propagation_phase(pd, card_name, totals)
    torch.cuda.empty_cache()

    log("== phase 7: link prediction at the ogbl-citation2 shape")
    linkpred = linkpred_phase(card_name, totals, dev)
    torch.cuda.empty_cache()

    log("== phase 8: the reader, the I2-GTL teacher, multi-seed, checkpoints")
    cli = cli_phase(gb, pd, card_name, totals, step_ms)

    assert totals["spmm_csr_plain"] == 0, totals
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[name], "launches": totals[name], **stats[name]}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels, "step_ms": step_ms,
                      "student": student, "trick_step_ms": tricks,
                      "propagation": propagation, "linkpred": linkpred,
                      "cli": cli, "card": card_name}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
