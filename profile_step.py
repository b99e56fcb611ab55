"""Where the device time of each path of the port goes, on one CUDA card,
and where the host time goes on the paths that leave the card idle.

    python3 profile_step.py [--cell NAME ...] [--epochs 6] [--out DIR]

Each cell drives one path that users pay for (PERF.md §1) through the port's
entry points on the card, with TF32 off as ``main`` runs: it builds its
workload (``cells``), runs its window once unprofiled to warm CUDA, cuBLAS
and the kernel build, then runs it again under ``torch.profiler``, ending in
``torch.cuda.synchronize()``, and once more unprofiled on the host clock
(``wall_ms``). ``--cell`` may be repeated; with none, every cell runs, in
the order below. The window of each cell:

- ``auto``, ``pallas_bf16``, ``I2_GTL auto``, ``I2_GTL pallas_bf16``: the
  TeacherGNN on ogbn-arxiv's shape (``chip_smoke.py``'s slice), each SpMM
  route with the node-classification or the I2-GTL edgewise loss; the
  eight tricks of ``chip_smoke.TRICK_RUNS`` (``BatchNorm``, ``GroupNorm``,
  ``PairNorm``, ``DenseNoNorm-attention``, ``Jumping``, ``DropEdge``,
  ``LADIES``, ``FastGCN-bf16``). ``--epochs`` epochs of
  ``train/loops.py:run_experiment``, each one train step and one eval
  forward, on the data ``main`` builds for the same flags (``parse_args``,
  ``build_config``, ``load_prepared``);
- ``bench``: ``bench_torch.py``'s framework step, ``bench_torch.TIMED_STEPS``
  steps; ``sharded S=1``: the same step on one rank's ``prepare_sharded``
  (``bench_torch.py --dist``'s layout, no process group);
- ``semlp part1``, ``semlp part2``: one ``train_semlp_part1`` /
  ``train_semlp_part2`` call of ``--epochs`` epochs (part 2's eval included)
  on the arxiv SEMLP config, after its teacher and SE table, unprofiled;
- ``replace``: one ``ops/topk_attention.py:latent_neighbor_replace`` of
  ``chip_smoke.REPLACE_BATCH`` part-1 queries against that [N, 512] table;
- ``LP``: one ``run_pure_lp`` call (50 propagations at d = 40); ``C&S``: one
  ``propagation/cs.py:run_cs_pipeline`` call (diffusion features,
  ``chip_smoke.CS_EPOCHS`` mid-step epochs);
- ``link bench``, ``link default``: one 16-step epoch of
  ``linkpred/model.py:make_epoch_fn`` on ``bench_linkpred_torch.py``'s
  citation2 split (built once for both), with the twin's bench config and
  with ``LinkPredConfig()``;
- ``DGI``, ``EGI``, ``VGAE``: ``baselines/dgi.py:train_dgi``,
  ``egi.py:train_egi``, ``vgae.py:train_vgae``, ``DGI_EPOCHS`` epochs each,
  on that split's message edges through the baselines' graph pipeline
  (built once for the three), degree one-hot width 64, hidden 64 (VGAE's
  latent 32); ``DGI call``: one ``baselines/api.py:gen_baseline_embs`` of
  DGI for ``DGI_EPOCHS`` epochs on those message edges, the graph pipeline
  and build included;
- ``GIN masking``, ``GIN contextpred``: ``baselines/pretrain_gin.py:
  train_pretrain_gin`` for ``DGI_EPOCHS`` epochs on ``chip_smoke.py``'s
  bench graph (169,343 nodes, 2,501,571 edges; contextpred's 128 centres
  and their context graphs built in the call); ``struct pretrain``: one
  ``StructFeatPretrain`` loss and backward on that graph and its
  30%-edge-masked copy (``chip_smoke.struct_pretrain_inputs``);
- ``edge LP logit``, ``edge LP emb``: one ``linkpred/edge_lp.py:
  run_logit_lp`` / ``run_emb_lp`` call over the bench graph's 1,166,243
  raw edges (cap ``ELP_CAP``, ``ELP_PROPS`` propagations, embeddings of
  width ``ELP_EMB_D``), the edge graph's host build included.

From the profiled window's device events (the chrome trace, written to
``--out``) each cell reports: device ms by op class (``op_class``), with
shares; the busy and idle shares of the device from the window's first
kernel to its last device event; ``steps`` (the epochs, train steps or
calls the window holds) and ``step_ms`` (host ms a step: the trainers'
median step, else the window over its steps); ``device_ms_per_step`` and
``launches_per_step`` (device kernels over steps: how fragmented the eager
passes are); ``kernel_launches``, the SpMM wrappers' counts over the window;
where the window runs SpMMs, ``spmm_bound_ms``, the least time of its SpMMs a
step by ``ops/spmm_kernels.py:spmm_bound`` on the CSR and width each call was
given; and the kernels that took the most device time.

A cell whose unprofiled window takes more than ``HOST_BOUND`` times its
device time (``host_bound``) runs its window once more under ``cProfile``
(``host_profile``) and reports ``host_top``: the ``HOST_TOP`` functions of
the port's package, numpy and scipy (the host library's ctypes wrappers are
the package's) with the most cumulative host seconds, each with its share
of that run's wall time ``host_wall_ms``, which stands beside ``wall_ms``
to show cProfile's overhead. A share is cumulative: a function's callees
are in it, so the shares of a call chain nest and do not add up.

The last line is one JSON object with every cell and the card's name and
power limit. An unknown ``--cell`` exits non-zero naming the known cells.
Exits non-zero without a CUDA card, when a trace holds no device kernels,
or when a window's loss or output is not finite.
"""
import argparse
import collections
import contextlib
import cProfile
import dataclasses
import functools
import gc
import json
import os
import pstats
import re
import statistics
import sys
import time
import types
from typing import Callable

import numpy as np
import torch

import bench_linkpred_torch as BL
import bench_torch as BT
from chip_smoke import (BASELINE_HIDDEN, BENCH_EDGES, BENCH_NODES, CS_EPOCHS, ELP_CAP,
                        ELP_EMB_D, ELP_PROPS, LP_ARGS, REPLACE_BATCH, SEMLP_ARGS, SLICE_ARGS,
                        TRICK_BASE, TRICK_RUNS, struct_pretrain_inputs)

EPOCHS = 6  # --epochs' default
DGI_EPOCHS = 5  # the baselines' and GIN pretrainers' epochs
#: a cell is host-bound when its unprofiled window takes more than this
#: many times its device time
HOST_BOUND = 2.0
HOST_TOP = 10  # functions in a host-bound cell's ``host_top``
#: where a function of ``host_top`` may live: the port's package (with the
#: host library's wrappers), numpy and scipy
HOST_PACKAGES = ("gnn_tail_generalization_tpu_torch", "numpy", "scipy")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the SpMM wrappers' kernels (csrc/spmm_csr.cu): light rows, hub chunks and
#: their reduction
SPMM_KERNEL = re.compile(r"\bspmm_\w+_kernel\b")
#: (class, pattern) of device kernels, tried in order: the first match names
#: the class. A kernel's name carries its functor in the template arguments
#: (a cast runs as an elementwise kernel over ``direct_copy_kernel_cuda``, a
#: random draw as ``distribution_elementwise_grid_stride_kernel``), so the
#: specific classes come before ``elementwise``
KERNEL_CLASSES = (
    ("spmm", SPMM_KERNEL),
    ("gemm", re.compile(r"gemm|gemv|cutlass|cublas|nvjet|splitKreduce", re.I)),
    ("optimizer", re.compile(r"multi_tensor_apply|foreach", re.I)),
    ("rng", re.compile(r"philox|distribution_elementwise|fused_dropout", re.I)),
    ("cast/copy", re.compile(r"copy_kernel|CatArrayBatchedCopy|roll_cuda_kernel")),
    ("sort/top-k", re.compile(r"sort|radix|topk|bitonic|cub::|fill_reverse_indices", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    # ``compute_cuda_kernel`` is ``repeat_interleave``'s
    ("index", re.compile(r"index_elementwise|indexing_|index_select|indexSelect|indexFunc"
                         r"|index_put|gather|scatter|embedding|\bcompute_cuda_kernel\b", re.I)),
    ("reduction", re.compile(r"reduce_kernel|_norm_|norm_kernel|GammaBeta|moments|welford"
                             r"|nll_loss", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel")),
)


def op_class(cat: str, name: str) -> str:
    """The class of one device event: ``copies`` and ``memset`` for the
    memcpy and memset categories, else the first of ``KERNEL_CLASSES`` whose
    pattern the kernel's name matches, else ``other``."""
    if cat != "kernel":
        return "copies" if cat == "gpu_memcpy" else "memset"
    for cls, pattern in KERNEL_CLASSES:
        if pattern.search(name):
            return cls
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals, in ms (trace is in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def summarize(trace_path: str, steps: int = 1) -> dict:
    """Device time by class and the loop's busy and idle shares of the
    chrome trace at ``trace_path``, whose window holds ``steps`` steps."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [e for e in events if e["cat"] == "kernel"]
    if not kernels:
        raise RuntimeError(f"{trace_path} holds no device kernels: the "
                           "profiler did not trace the card")
    by_class = collections.Counter()
    by_kernel = collections.Counter()
    launches = collections.Counter()
    class_of = {}
    for e in events:
        cls = class_of[e["name"]] = op_class(e["cat"], e["name"])
        by_class[cls] += e["dur"] / 1e3
        by_kernel[e["name"]] += e["dur"] / 1e3
        launches[e["name"]] += 1
    spmm_launches = collections.Counter()  # by kernel, over its instances
    for k, n in launches.items():
        m = SPMM_KERNEL.search(k)
        if m:
            spmm_launches[m.group(0)] += n
    total = sum(by_class.values())
    t0 = min(e["ts"] for e in kernels)
    loop = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["ts"] >= t0]
    span = (max(end for _, end in loop) - t0) / 1e3
    busy = busy_ms(loop)
    return {
        "device_ms": total,
        "by_class_ms": dict(by_class),
        "share": {k: v / total for k, v in by_class.items()},
        "loop_span_ms": span,
        "loop_busy_ms": busy,
        "loop_busy_share": busy / span,
        "loop_idle_share": 1.0 - busy / span,
        "device_ms_per_step": total / steps,
        "launches_per_step": len(kernels) / steps,
        "spmm_launches": dict(spmm_launches),
        "top_kernels": [(k[:90], v, launches[k], class_of[k])
                        for k, v in by_kernel.most_common(12)],
    }


@contextlib.contextmanager
def recorded_spmm_calls(calls: list):
    """Appends (indptr, indices, width, bf16) of every call of the SpMM
    wrappers (``ops/spmm_kernels.py``) inside the block to ``calls``."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    def recording(fn, bf16):
        def call(indptr, indices, weight, x, schedule=None):
            calls.append((indptr, indices, x.shape[1], bf16))
            return fn(indptr, indices, weight, x, schedule)
        return call

    saved = K.spmm_csr_f32, K.spmm_csr_bf16
    K.spmm_csr_f32, K.spmm_csr_bf16 = recording(saved[0], False), recording(saved[1], True)
    try:
        yield
    finally:
        K.spmm_csr_f32, K.spmm_csr_bf16 = saved


def spmm_bound_ms(calls) -> float:
    """The least time of the recorded SpMM calls (``spmm_bound`` of each
    call's CSR at its width), in ms."""
    from gnn_tail_generalization_tpu_torch.ops.spmm_kernels import spmm_bound

    memo, total = {}, 0.0  # a CSR's bound at a width, computed once
    for indptr, indices, d, bf16 in calls:
        key = (indptr.data_ptr(), indices.data_ptr(), indices.numel(), d, bf16)
        if key not in memo:
            csr = types.SimpleNamespace(indices=indices, n_node=indptr.numel() - 1,
                                        n_edge=indices.numel())
            memo[key] = spmm_bound(csr, d, bf16)[0]
        total += memo[key]
    return total


@dataclasses.dataclass
class Window:
    """A cell's profiled window. ``run()`` runs it and returns (host ms a
    step, the loss or output that must be finite); it holds ``steps``
    steps."""
    run: Callable[[], tuple]
    steps: int


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _repeat(step, n: int):
    """``step()`` ``n`` times; the last result."""
    for _ in range(n):
        out = step()
    return out


def _timed(dev, steps: int, fn) -> tuple:
    """(host ms a step of ``fn()`` ending in a synchronize, its result)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return (time.perf_counter() - t0) / steps * 1e3, out


def node_workload(argv, n_node=None, n_feat=None, n_hidden=None, n_class=None):
    """(cfg, prepared data) for the flags ``argv`` as the port's ``main``
    builds them (``parse_args``, ``build_config``, ``load_prepared``): the
    dataset's synthetic stand-in at its preset shapes, or at the sizes
    given."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config

    overrides, ns = port_main.parse_args(argv)
    cfg = build_config(**overrides)
    if n_node is not None:
        cfg = dataclasses.replace(cfg, N_nodes=n_node, num_feats=n_feat,
                                  num_classes=n_class, dim_hidden=n_hidden)
    return port_main.load_prepared(cfg, ns.data_root)


def trainer_cell(argv, epochs: int, device="cuda", **size) -> Window:
    """``epochs`` epochs of ``run_experiment`` on ``argv``'s workload."""
    from gnn_tail_generalization_tpu_torch.train.loops import run_experiment
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, pd = node_workload(argv, **size)

    def run():
        res = run_experiment(cfg, pd, seed=cfg.random_seed, epochs=epochs, device=dev)
        return statistics.median(res.step_ms), res.records
    return Window(run, epochs)


def semlp_teacher(dev, **size) -> tuple:
    """(cfg, prepared data, teacher SE table) of the arxiv SEMLP config: the
    teacher trained as ``run_experiment`` trains it, then its SE table."""
    from gnn_tail_generalization_tpu_torch.train.loops import (collect_teacher_se,
                                                               train_teacher)

    cfg, pd = node_workload(SEMLP_ARGS, **size)
    teacher = train_teacher(cfg, pd, cfg.random_seed, device=dev)
    return cfg, pd, collect_teacher_se(cfg, pd, teacher.best_state_dict, device=dev)


def semlp_cell(part: int, epochs: int, device="cuda", **size) -> Window:
    """One ``train_semlp_part1`` (``part`` 1) or ``train_semlp_part2`` call
    of ``epochs`` epochs; part 2 after an unprofiled part 1."""
    from gnn_tail_generalization_tpu_torch.train import loops
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, pd, se = semlp_teacher(dev, **size)
    seed = cfg.random_seed
    if part == 1:
        def call():
            return loops.train_semlp_part1(cfg, pd, se, seed, epochs, device=dev)
    else:
        p1 = loops.train_semlp_part1(cfg, pd, se, seed, device=dev)

        def call():
            return loops.train_semlp_part2(cfg, pd, se, p1, seed, epochs, device=dev)

    def run():
        res = call()
        return statistics.median(res.step_ms), res.records
    return Window(run, epochs)


def replace_cell(device="cuda", **size) -> Window:
    """One ``latent_neighbor_replace`` of ``REPLACE_BATCH`` part-1 outputs
    (of the first nodes' features) against the SEMLP teacher's SE table."""
    from gnn_tail_generalization_tpu_torch.models.semlp import SEMLPPart1
    from gnn_tail_generalization_tpu_torch.ops.topk_attention import latent_neighbor_replace
    from gnn_tail_generalization_tpu_torch.train.loops import train_semlp_part1
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, pd, se = semlp_teacher(dev, **size)
    p1 = train_semlp_part1(cfg, pd, se, cfg.random_seed, device=dev)
    with torch.device("meta"):
        part1 = SEMLPPart1(cfg, se.shape[1])
    part1.load_state_dict(p1.state_dict, assign=True)
    part1.to(dev).eval()
    with torch.no_grad():
        q = part1(torch.as_tensor(pd.x[:REPLACE_BATCH], device=dev))
    k = cfg.SEMLP_topK_2_replace
    return Window(lambda: _timed(dev, 1, lambda: latent_neighbor_replace(q, se, k)), 1)


def lp_cell(device="cuda", **size) -> Window:
    """One ``run_pure_lp`` call: the DAD adjacency on the host, then 50
    propagations on the card."""
    from gnn_tail_generalization_tpu_torch.train.loops import run_pure_lp
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, pd = node_workload(LP_ARGS, **size)
    return Window(lambda: _timed(dev, 1, lambda: np.array(
        list(run_pure_lp(cfg, pd, device=dev).values()))), 1)


def cs_cell(device="cuda", **size) -> Window:
    """One ``run_cs_pipeline`` call as ``chip_smoke.py`` phase 6 runs it:
    diffusion features, ``CS_EPOCHS`` mid-step epochs, C&S."""
    from gnn_tail_generalization_tpu_torch.propagation.cs import run_cs_pipeline
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, pd = node_workload(LP_ARGS + ["--force_set_to_best_config=0"], **size)
    cfg = dataclasses.replace(cfg, preStep=dataclasses.replace(
        cfg.preStep, pre_methods="diffusion"))
    return Window(lambda: _timed(dev, 1, lambda: run_cs_pipeline(
        cfg, pd, epochs=CS_EPOCHS, device=dev)["out"]), 1)


@functools.lru_cache(maxsize=1)
def citation2(n_node=BL.N_NODE, n_edge=BL.N_EDGE, eval_pos=BL.EVAL_POS,
              num_neg_eval=BL.NUM_NEG_EVAL) -> tuple:
    """(n_node, message edges, train edges [2, m]) of
    ``bench_linkpred_torch.py``'s split at seed 0; built once for the cells
    that share it."""
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph

    e = fast_powerlaw_graph(n_node, n_edge, 0)
    _, msg, train, _ = BL.build_split(e, n_node, np.random.default_rng(0), 0,
                                      eval_pos, num_neg_eval)
    return n_node, msg, train


def link_cell(kind: str, device="cuda", steps=BL.TIMED_STEPS, n_feat=BL.N_FEAT,
              batch_size=None, **split) -> Window:
    """One ``steps``-step epoch of the link trainer on the citation2 split:
    ``kind`` "bench" (the twin's config, features drawn on the card) or
    "default" (``LinkPredConfig()``, the trained embedding)."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n, msg, train = citation2(**split)
    cfg = BL.bench_config() if kind == "bench" else lpm.LinkPredConfig()
    if batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    x = None
    if cfg.use_node_feats:
        x = torch.randn(n, n_feat, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    g = lpm.link_graph(cfg, msg, n).to(dev)
    epoch, _, _ = BL.make_link_epoch(cfg, g, x, train, msg, steps)
    return Window(lambda: _timed(dev, steps, epoch), steps)


@functools.lru_cache(maxsize=1)
def baseline_graph(n_hidden=BASELINE_HIDDEN, **split) -> tuple:
    """(host graph, degree one-hot features of width ``n_hidden``) of the
    citation2 split's message edges through ``gen_baseline_embs``'s graph
    pipeline; built once for the DGI, EGI and VGAE cells."""
    from gnn_tail_generalization_tpu_torch.baselines.api import degree_bucketing
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph, standard_pipeline

    n, msg, _ = citation2(**split)
    e = standard_pipeline(msg, n)
    g = build_graph(e, n, with_dense=n <= 4096, with_plans=n > 4096)
    return g, degree_bucketing(e, n, max_degree=n_hidden)


def baseline_cell(alg: str, device="cuda", epochs=DGI_EPOCHS, n_hidden=BASELINE_HIDDEN,
                  **split) -> Window:
    """``train_dgi``, ``train_egi`` or ``train_vgae`` (``alg``) for
    ``epochs`` epochs on ``baseline_graph``, hidden ``n_hidden``."""
    from gnn_tail_generalization_tpu_torch.baselines.dgi import train_dgi
    from gnn_tail_generalization_tpu_torch.baselines.egi import train_egi
    from gnn_tail_generalization_tpu_torch.baselines.vgae import train_vgae
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    g_host, x = baseline_graph(n_hidden, **split)
    g = g_host.to(dev)
    train = {"DGI": train_dgi, "EGI": train_egi, "VGAE": train_vgae}[alg]

    def run():
        stats = {}
        train(g, x, n_hidden, epochs=epochs, device=dev, stats=stats)
        return statistics.median(stats["epoch_ms"]), np.array(stats["loss"])
    return Window(run, epochs)


def dgi_call_cell(device="cuda", epochs=DGI_EPOCHS, n_hidden=BASELINE_HIDDEN,
                  **split) -> Window:
    """One ``gen_baseline_embs(..., "DGI")`` of ``epochs`` epochs on the
    citation2 split's message edges: the API as users call it, its graph
    pipeline and build on the host included."""
    from gnn_tail_generalization_tpu_torch.baselines.api import gen_baseline_embs
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n, msg, _ = citation2(**split)
    return Window(lambda: _timed(dev, 1, lambda: gen_baseline_embs(
        msg, n, "DGI", hidden_dim=n_hidden, epochs=epochs, device=dev)), 1)


@functools.lru_cache(maxsize=1)
def bench_graph(n_node=BENCH_NODES, n_edge=BENCH_EDGES, n_hidden=BASELINE_HIDDEN) -> tuple:
    """(host graph, its edges [2, E] in the forward CSR's order, degree
    one-hot features of width ``n_hidden``) of ``chip_smoke.py``'s bench
    graph, as its phase 9 (iii) feeds the GIN pretrainers."""
    from gnn_tail_generalization_tpu_torch.baselines.api import degree_bucketing
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import (build_graph, edge_rows,
                                                              standard_pipeline)

    g = build_graph(standard_pipeline(fast_powerlaw_graph(n_node, n_edge, 0), n_node),
                    n_node, with_dense=False)
    e = np.stack([g.indices.numpy(), edge_rows(g.indptr, g.n_edge).numpy()])
    return g, e, degree_bucketing(e, n_node, n_hidden)


def gin_cell(variant: str, device="cuda", epochs=DGI_EPOCHS, n_hidden=BASELINE_HIDDEN,
             **size) -> Window:
    """``train_pretrain_gin`` (``variant`` "masking" or "contextpred", its
    default 128 centres) for ``epochs`` epochs on ``bench_graph``."""
    from gnn_tail_generalization_tpu_torch.baselines.pretrain_gin import train_pretrain_gin
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    g, _, x = bench_graph(n_hidden=n_hidden, **size)

    def run():
        stats = {}
        train_pretrain_gin(g, x, variant, hidden_dim=n_hidden, epochs=epochs, device=dev,
                           stats=stats)
        return statistics.median(stats["epoch_ms"]), np.array(stats["loss"])
    return Window(run, epochs)


def struct_cell(device="cuda", n_hidden=BASELINE_HIDDEN, **size) -> Window:
    """One ``StructFeatPretrain`` loss and backward on ``bench_graph`` and
    its 30%-edge-masked copy, with ``chip_smoke.py`` phase 9 (iii)'s link
    and centrality pairs."""
    from gnn_tail_generalization_tpu_torch.baselines.structure_pretrain import (
        StructFeatPretrain)
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    g, e, x = bench_graph(n_hidden=n_hidden, **size)
    gm, *pairs = struct_pretrain_inputs(e, g.n_node)
    model = StructFeatPretrain(n_hidden, n_hidden,
                               generator=torch.Generator().manual_seed(0)).to(dev)
    args = (g.to(dev), gm.to(dev), torch.as_tensor(x, device=dev),
            *(torch.as_tensor(a, device=dev) for a in pairs))

    def step():
        model.zero_grad(set_to_none=True)
        loss = model(*args)
        loss.backward()
        return loss.detach()
    return Window(lambda: _timed(dev, 1, step), 1)


@functools.lru_cache(maxsize=1)
def scored_edges(n_node=BENCH_NODES, n_edge=BENCH_EDGES) -> np.ndarray:
    """[M, 2] the bench graph's raw edges, the scored edges of
    ``chip_smoke.py`` phase 13's edge LP."""
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph

    return np.ascontiguousarray(fast_powerlaw_graph(n_node, n_edge, 0).T)


def edge_lp_cell(kind: str, device="cuda", emb_d=ELP_EMB_D, n_node=BENCH_NODES,
                 n_edge=BENCH_EDGES) -> Window:
    """One ``run_logit_lp`` (``kind`` "logit") or ``run_emb_lp`` ("emb")
    call over ``scored_edges``: the edge graph built on the host at cap
    ``ELP_CAP``, then ``ELP_PROPS`` propagations on the card, of random
    logits or of random node embeddings of width ``emb_d``."""
    from gnn_tail_generalization_tpu_torch.linkpred import edge_lp as elp
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    scored = scored_edges(n_node, n_edge)
    m = len(scored)
    gen = torch.Generator(device=dev).manual_seed(13)
    if kind == "logit":
        logits = torch.randn(m, generator=gen, device=dev)

        def call():
            return elp.run_logit_lp(scored, logits, m // 2, 3 * m // 4,
                                    num_propagations=ELP_PROPS, max_degree=ELP_CAP)
    else:
        h = torch.randn(n_node, emb_d, generator=gen, device=dev)

        def call():
            return elp.run_emb_lp(scored, h, num_propagations=ELP_PROPS, max_degree=ELP_CAP)
    return Window(lambda: _timed(dev, 1, call), 1)


def bench_cell(device="cuda", steps=BT.TIMED_STEPS, **size) -> Window:
    """``steps`` of ``bench_torch.py``'s framework step."""
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, pd = BT.build_workload(**size)
    step, _ = BT.make_framework_step(cfg, pd, dev)
    return Window(lambda: _timed(dev, steps, lambda: _repeat(step, steps)), steps)


def sharded_cell(device="cuda", steps=BT.TIMED_STEPS, **size) -> Window:
    """``steps`` of the framework step on one rank's ``prepare_sharded``
    (``bench_torch.py --dist``'s layout: rb ``DIST_RB``, no process group)."""
    from gnn_tail_generalization_tpu_torch.data.datasets import prepare_sharded
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, data = BT.build_raw_workload(**size)
    comm = Comm(0, 1, dev, "nccl" if dev.type == "cuda" else "gloo")
    pd = prepare_sharded(data, cfg, comm, rb=BT.DIST_RB)
    step, _ = BT.make_framework_step(cfg, pd, dev)
    return Window(lambda: _timed(dev, steps, lambda: _repeat(step, steps)), steps)


def cells(epochs: int = EPOCHS) -> dict:
    """Cell name -> a function that builds the cell's workload on ``device``
    (sizes as keywords, the full shapes by default) and returns its
    ``Window``; ``epochs`` is the teacher, trick and student windows'."""
    teacher = {f"{loss}{m}": functools.partial(
        trainer_cell, SLICE_ARGS + [f"--spmm_method={m}"] + flags, epochs)
        for loss, flags in (("", []), ("I2_GTL ", ["--exp_mode=I2_GTL", "--task=nodeC"]))
        for m in ("auto", "pallas_bf16")}
    tricks = {name: functools.partial(trainer_cell, TRICK_BASE + flags, epochs)
              for name, flags in TRICK_RUNS.items()}
    return {**teacher, "bench": bench_cell, "sharded S=1": sharded_cell,
            "semlp part1": functools.partial(semlp_cell, 1, epochs),
            "semlp part2": functools.partial(semlp_cell, 2, epochs),
            "replace": replace_cell, **tricks, "LP": lp_cell, "C&S": cs_cell,
            "link bench": functools.partial(link_cell, "bench"),
            "link default": functools.partial(link_cell, "default"),
            **{alg: functools.partial(baseline_cell, alg) for alg in ("DGI", "EGI", "VGAE")},
            "DGI call": dgi_call_cell,
            "GIN masking": functools.partial(gin_cell, "masking"),
            "GIN contextpred": functools.partial(gin_cell, "contextpred"),
            "struct pretrain": struct_cell,
            "edge LP logit": functools.partial(edge_lp_cell, "logit"),
            "edge LP emb": functools.partial(edge_lp_cell, "emb")}


def finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return bool(torch.isfinite(out).all())
    return bool(np.isfinite(np.asarray(out)).all())


def host_bound(s: dict) -> bool:
    """Whether the cell's unprofiled window (``wall_ms``) took more than
    ``HOST_BOUND`` times its device time."""
    return s["wall_ms"] > HOST_BOUND * s["device_ms"]


def host_function(file: str, line: int, name: str):
    """``host_top``'s name of a function cProfile saw: "<path from the
    package's parent>:<line>(<name>)" for Python functions of
    ``HOST_PACKAGES``, the name for their C functions (cProfile files these
    under "~"), else None."""
    if file == "~":
        return name if any(f"{p}." in name for p in HOST_PACKAGES) else None
    parts = file.split(os.sep)
    for i, part in enumerate(parts):  # the outermost package directory
        if part in HOST_PACKAGES:
            return f"{'/'.join(parts[i:])}:{line}({name})"
    return None


def host_profile(window: Window, dev, top: int = HOST_TOP) -> tuple:
    """One run of ``window`` under ``cProfile``: (the ``top`` functions of
    ``host_function`` by cumulative seconds, each {"function", "s",
    "share"} with its share of the run's wall time; that wall time in ms)."""
    prof = cProfile.Profile()
    _sync(dev)
    t0 = time.perf_counter()
    prof.enable()
    try:
        window.run()
        _sync(dev)
    finally:
        prof.disable()
    wall_s = time.perf_counter() - t0
    rows = []
    for (file, line, name), (_, _, _, cum_s, _) in pstats.Stats(prof).stats.items():
        label = host_function(file, line, name)
        if label is not None:
            rows.append({"function": label, "s": cum_s, "share": cum_s / wall_s})
    rows.sort(key=lambda r: -r["s"])
    return rows[:top], wall_s * 1e3


def profile_cell(name: str, build, out_dir: str) -> dict:
    """Builds the cell, warms it with one unprofiled run of its window,
    profiles a second run and times a third; a host-bound cell's window
    runs a fourth time under ``host_profile``. The summary of its trace and
    the fields of the module docstring."""
    from gnn_tail_generalization_tpu_torch.ops import _build

    w = build()
    w.run()
    _build.reset_launch_counts()
    calls = []
    with recorded_spmm_calls(calls), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step_ms, out = w.run()
        torch.cuda.synchronize()
    launches = _build.launch_counts("spmm_csr")
    if not finite(out):
        raise RuntimeError(f"cell {name!r}: non-finite loss or output {out}")
    if len(calls) != sum(launches.values()):
        raise RuntimeError(f"cell {name!r}: {len(calls)} SpMM wrapper calls recorded "
                           f"against launch counts {launches}")
    trace = os.path.join(out_dir, f"trace_{re.sub(r'[^A-Za-z0-9]+', '_', name)}.json")
    prof.export_chrome_trace(trace)
    s = summarize(trace, w.steps)
    dev = torch.device("cuda")
    wall_ms, _ = _timed(dev, 1, w.run)
    s.update(steps=w.steps, step_ms=step_ms, wall_ms=wall_ms, kernel_launches=launches,
             spmm_bound_ms=spmm_bound_ms(calls) / w.steps if calls else None)
    s["host_bound"] = host_bound(s)
    if s["host_bound"]:
        s["host_top"], s["host_wall_ms"] = host_profile(w, dev)
    return s


def print_cell(title: str, s: dict) -> None:
    print(f"== {title}")
    print(f"  {s['steps']} steps, step_ms {s['step_ms']:.4f}; device ms "
          f"{s['device_ms']:.3f} ({s['device_ms_per_step']:.4f} a step, "
          f"{s['launches_per_step']:.1f} kernels a step); loop span "
          f"{s['loop_span_ms']:.3f} ms, busy {s['loop_busy_ms']:.3f} ms, "
          f"idle share {s['loop_idle_share']:.4f}; window wall {s['wall_ms']:.3f} ms"
          + (" (host-bound)" if s["host_bound"] else ""))
    for k, v in sorted(s["by_class_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:12s} {v:10.3f} ms  {100 * s['share'][k]:5.1f}%")
    bound = s["spmm_bound_ms"]
    print(f"  kernel launches {s['kernel_launches']}; spmm kernels {s['spmm_launches']}"
          + ("" if bound is None else f"; SpMM bound {bound:.4f} ms a step"))
    for name, ms, n, cls in s["top_kernels"]:
        print(f"    {ms:9.3f} ms {n:6d}x  {cls:11s} {name}")
    if s["host_bound"]:
        print(f"  host, cumulative, of a {s['host_wall_ms']:.3f} ms run under cProfile:")
        for r in s["host_top"]:
            print(f"    {r['s']:9.4f} s {100 * r['share']:5.1f}%  {r['function']}")


def main(argv=None) -> int:
    names = list(cells())
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", action="append", choices=names,
                    help="a cell to profile (repeatable); default: every cell")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: torch finds no CUDA device", file=sys.stderr)
        return 2
    from gnn_tail_generalization_tpu_torch.utils.device import card

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = card()
    os.makedirs(args.out, exist_ok=True)
    registry = cells(args.epochs)
    report = {"card": card_name, "epochs": args.epochs, "cells": {}}
    for name in args.cell or names:
        t0 = time.perf_counter()
        s = profile_cell(name, registry[name], args.out)
        s["cell_s"] = time.perf_counter() - t0
        report["cells"][name] = s
        print_cell(f"{name}: {s['cell_s']:.1f} s, {card_name}", s)
        gc.collect()
        torch.cuda.empty_cache()
    print(card_name)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
