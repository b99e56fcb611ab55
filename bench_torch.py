"""Benchmark: the PyTorch port's TeacherGNN full-graph train step at the
ogbn-arxiv shape, on one CUDA card. The twin of ``bench.py``.

    python3 bench_torch.py          # ONE JSON line on stdout, logs on stderr
    python3 bench_torch.py --dist   # the sharded step alone (run by the above
                                    # in a subprocess)

Workload (``bench.py:37-74``): the port's config chain for ogbn-arxiv's best
config (``InitialBatchNorm``, 2 layers, dropout 0.1, lr 0.005, the
loss-masked last layer; ``whetherHasSE='100'``, which the Initial branch
reads from flag [1], so no SE table) at N = 169,343 nodes, 128 features,
hidden 256, 40 classes, on ``fast_powerlaw_graph(169343, 1_166_243, 0)``
through ``data/datasets.py:prepare`` (plans, so ``pallas_bf16`` runs the
bf16 CSR kernel ``spmm_csr_bf16`` forward and on the transposed CSR
backward), 0.54 of the nodes in train.

Metric: SpMM edges/s = E x layers / step time, the step being forward,
backward and Adam (``train/loops.py:teacher_step_grads`` and the
optimizer's step, as ``train_teacher`` runs them). ``step_ms`` is the best
of 3 windows of 16 eager steps on the host clock, each window ending in
``torch.cuda.synchronize()``, after 16 warm-up steps; the median window and
every window are printed beside it.

``vs_baseline``: the naive step's time over the framework's. The naive
step (``make_naive_step``, ``bench.py:127-182``) is a plainer two-layer GCN
with an SE table on layer 0 (no batch norm, no initial connection), on
permuted edges, aggregated by an unsorted ``index_add_`` with autograd's
backward: what a straight port of the reference's code would run. It never
calls the kernels.

Beside them: ``spmm_bound_ms`` (the step's four full-graph SpMMs, two
layers forward and transposed backward, by ``ops/spmm_kernels.py:
spmm_bound``'s byte rule; the loss-masked last layer aggregates fewer rows,
as ``bench.py`` also counts) and ``pct_spmm_bound`` (100 x that over
``step_ms``); ``mfu`` (the step's model FLOPs, the dense layers' forward
GEMMs x 3 plus 2 x E x d for each of the four SpMMs, over step time x
``mfu_peak``: 67 TFLOP/s, f32 outside the tensor cores, since TF32 is off
and the bf16 kernel sums in f32); ``kernel_launches`` (the SpMM wrappers'
counts over the timed windows); ``peak_gib`` (the framework step's); and
``device`` (the card's name, its ``nvidia-smi`` name and power limit, the
device count).

``--dist`` (``bench.py:234-368``): the workload through
``data/datasets.py:prepare_sharded`` on a one-rank ``parallel/comm.py:Comm``
(no process group) at ``rb = 128``, the teacher's SE padding rows zeroed
and the one-device parameters sliced from the sharded ones; 3 coupled steps
at dropout 0 against the one-device step (loss rel diff < 5e-3), then the
sharded step timed as above with the default config and the loss-masked
view. It runs in a subprocess with a hard timeout; a crash, a timeout or a
rel diff >= 5e-3 makes this script exit non-zero, with the reason on
stderr. Without a CUDA device both modes raise: nothing is measured on the
CPU.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TRAIN_FRACTION = 0.54  # ogbn-arxiv's
TIMED_STEPS, WINDOWS = 16, 3
DIST_RB, DIST_STEPS, DIST_REL_TOL, DIST_TIMEOUT_S = 128, 3, 5e-3, 300
METRIC = "teacher_train_spmm_edges_per_s"

_T0 = time.time()


def _log(*a):
    print(f"[bench {time.time() - _T0:6.1f}s]", *a, file=sys.stderr, flush=True)


def build_raw_workload(n_node=169343, n_feat=128, n_hidden=256, n_class=40,
                       n_edge=1_166_243, seed=0):
    from gnn_tail_generalization_tpu_torch.config import (apply_arch_configs,
                                                          build_config)
    from gnn_tail_generalization_tpu_torch.data.datasets import NodeData
    from gnn_tail_generalization_tpu_torch.data.synthetic import (
        fast_powerlaw_graph, synthetic_features_labels)

    cfg = build_config(dataset="ogbn-arxiv", train_which="TeacherGNN",
                       whetherHasSE="100", se_reg=0.5)
    cfg = dataclasses.replace(cfg, use_special_split=False,
                              do_deg_analyze=False, want_headtail=False,
                              spmm_method="pallas_bf16",
                              N_nodes=n_node, num_feats=n_feat,
                              num_classes=n_class, dim_hidden=n_hidden)
    cfg = apply_arch_configs(cfg)
    x, y = synthetic_features_labels(n_node, n_feat, n_class, seed)
    e = fast_powerlaw_graph(n_node, n_edge, seed)
    train = np.random.default_rng(seed).random(n_node) < TRAIN_FRACTION
    data = NodeData(x=x, y=y, edge_index=e, train_mask=train, val_mask=None,
                    test_mask=~train, name="bench-arxiv")
    return cfg, data


def build_workload(**kw):
    from gnn_tail_generalization_tpu_torch.data.datasets import prepare

    cfg, data = build_raw_workload(**kw)
    return cfg, prepare(data, cfg)


def make_framework_step(cfg, pd, device="cuda", init_state=None, seed=0):
    """(step, model): ``step()`` runs one train step of the teacher on
    ``pd`` (one device's ``prepare``, or one rank's ``prepare_sharded``)
    and returns the loss on the device. The model is
    drawn from a ``torch.Generator`` seeded ``seed`` (on a rank: the whole
    model with zeroed SE padding rows, the rank's rows kept), or loaded
    from ``init_state``; dropout draws from a card generator seeded
    ``seed + 1``. The loss-masked last layer comes from the trainer's own
    gate, ``train/loops.py:final_agg_view``."""
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import ShardedGraph
    from gnn_tail_generalization_tpu_torch.train.loops import (
        _teacher_model, final_agg_view, teacher_step_grads)
    from gnn_tail_generalization_tpu_torch.train.optim import make_optimizer
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    g_dist = pd.graph if isinstance(pd.graph, ShardedGraph) else None
    model = _teacher_model(cfg, seed, init_state, g_dist).to(device)
    opt = make_optimizer(cfg, model.parameters())
    g = pd.graph.to(device)
    g_last = final_agg_view(cfg, pd)
    if g_last is not None:
        g_last = g_last.to(device)
    x = torch.as_tensor(pd.x).to(device)
    y = torch.as_tensor(pd.y).to(device)
    mask = torch.as_tensor(pd.train_mask).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        loss, _ = teacher_step_grads(cfg, model, g, x, y, mask, g_last=g_last,
                                     generator=gen)
        opt.step()
        return loss.detach()

    return step, model


def make_naive_step(cfg, pd, device="cuda", params=None, seed=0):
    """(step, params): the straight-port baseline of ``bench.py:127-182``.
    ``step(keep=None)`` runs one step and returns the loss; ``keep`` is the
    input dropout's [N, F] keep mask (drawn at 0.9 from a card generator
    seeded ``seed + 1`` when None). ``params``: numpy arrays ``w0``, ``b0``,
    ``se0``, ``w1``, ``b1`` to start from instead of the seeded draw
    (xavier-uniform kernels, a standard-normal SE table, zero biases).
    Adam with optax's defaults (eps 1e-8, no weight decay)."""
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    e = pd.edge_index
    perm = np.random.default_rng(1).permutation(e.shape[1])  # no dst order
    send = torch.as_tensor(e[0][perm], dtype=torch.int64, device=device)
    recv = torch.as_tensor(e[1][perm], dtype=torch.int64, device=device)
    n = pd.n_node
    x = torch.as_tensor(pd.x).to(device)
    y = torch.as_tensor(pd.y).to(device)
    m = torch.as_tensor(pd.train_mask).to(device).float()

    def inv_sqrt_deg(ids):
        deg = torch.as_tensor(np.bincount(ids, minlength=n), device=device)
        return deg.clamp(min=1).float().pow(-0.5)[:, None]

    dout, din = inv_sqrt_deg(e[0]), inv_sqrt_deg(e[1])
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = {"w0": torch.empty(cfg.num_feats, cfg.dim_hidden),
                  "b0": torch.zeros(cfg.dim_hidden),
                  "se0": torch.empty(n, cfg.dim_hidden),
                  "w1": torch.empty(cfg.dim_hidden, cfg.num_classes),
                  "b1": torch.zeros(cfg.num_classes)}
        torch.nn.init.xavier_uniform_(params["w0"], generator=gen)
        torch.nn.init.normal_(params["se0"], generator=gen)
        torch.nn.init.xavier_uniform_(params["w1"], generator=gen)
    p = {k: torch.nn.Parameter(torch.as_tensor(np.array(v, np.float32)).to(device))
         for k, v in params.items()}
    opt = torch.optim.Adam(p.values(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    drop_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def agg(h):
        return h.new_zeros(n, h.shape[1]).index_add(0, recv, h[send])

    def step(keep=None):
        if keep is None:
            keep = torch.rand(x.shape, generator=drop_gen, device=device) < 0.9
        opt.zero_grad(set_to_none=True)
        h = x * keep.to(device) / 0.9
        h = (h * dout) @ p["w0"] + p["se0"]
        h = torch.relu(agg(h) * din + p["b0"])
        h = (h * dout) @ p["w1"]
        logits = agg(h) * din + p["b1"]
        picked = torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
        loss = -(picked * m).sum() / m.sum()
        loss = loss + cfg.se_reg * torch.linalg.vector_norm(p["se0"])
        loss.backward()
        opt.step()
        return loss.detach()

    return step, p


def time_step(step, iters=TIMED_STEPS, windows=WINDOWS):
    """Per-step seconds of each of ``windows`` windows of ``iters`` eager
    steps, after ``iters`` warm-up steps; every window starts and ends in
    ``torch.cuda.synchronize()`` (host clock). The SpMM wrappers' launch
    counts are reset after the warm-up, so they hold the windows' launches."""
    from gnn_tail_generalization_tpu_torch.ops import _build

    for _ in range(iters):
        loss = step()
    if not torch.isfinite(loss):
        raise RuntimeError(f"non-finite loss after the warm-up: {loss.item()}")
    _build.reset_launch_counts()
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / iters)
    if not torch.isfinite(loss):
        raise RuntimeError(f"non-finite loss in the timed windows: {loss.item()}")
    return out


def conv_widths(model) -> list:
    """The output width of each GCN conv of ``model``: the width its SpMM
    aggregates."""
    from gnn_tail_generalization_tpu_torch.nn.gcn import GCNConv

    return [m.out_feats for m in model.modules() if isinstance(m, GCNConv)]


def step_spmm_bound_ms(g, widths, bf16: bool) -> float:
    """The least time of the step's full-graph SpMMs: per conv, the forward
    on ``g`` and the backward on its transpose (``spmm_bound``)."""
    from gnn_tail_generalization_tpu_torch.ops.spmm_kernels import spmm_bound

    gt = g.transpose()
    return sum(spmm_bound(g, d, bf16)[0] + spmm_bound(gt, d, bf16)[0]
               for d in widths)


def step_model_flops(model, n_node: int, n_edge: int) -> float:
    """The step's model FLOPs: each dense kernel's forward GEMM (2 N in out)
    x 3 for forward and backward, plus 2 E d for each conv's forward and
    transposed-backward SpMM."""
    gemm = sum(2 * n_node * p.numel() for name, p in model.named_parameters()
               if p.dim() == 2 and name.rsplit(".", 1)[-1] != "se")
    return 3 * gemm + sum(2 * 2 * n_edge * d for d in conv_widths(model))


def dist_numerics(cfg, data, device, rb=DIST_RB, steps=DIST_STEPS, seed=0):
    """The loss rel diffs of ``steps`` coupled steps at dropout 0: the
    sharded teacher on a one-rank ``prepare_sharded`` (padded to
    ``round_up(n, rb)`` rows, SE padding rows zero) against the one-device
    teacher from the same parameters (the SE tables sliced to n rows)."""
    from gnn_tail_generalization_tpu_torch.data.datasets import (
        prepare, prepare_sharded)
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    comm = Comm(0, 1, device, "nccl" if device.type == "cuda" else "gloo")
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    pd_d = prepare_sharded(data, cfg0, comm, rb=rb)
    pd_s = prepare(data, cfg0)
    n = pd_s.n_node
    # the coupled steps run without the loss-masked view, as bench.py's do
    cfg0 = dataclasses.replace(cfg0, optimize_final_layer_agg=False)
    step_d, model_d = make_framework_step(cfg0, pd_d, device, seed=seed)
    state_s = {k: (v[:n] if k.rsplit(".", 1)[-1] == "se" else v).detach().cpu()
               for k, v in model_d.state_dict().items()}
    step_s, _ = make_framework_step(cfg0, pd_s, device, init_state=state_s)
    rel = []
    for i in range(steps):
        ld, ls = step_d().item(), step_s().item()
        rel.append(abs(ld - ls) / max(abs(ls), 1e-9))
        _log(f"dist numerics step {i}: loss dist={ld:.6f} single={ls:.6f}")
    return rel


def run_dist():
    """``--dist``: the numerics check, then the sharded step timed. Prints
    one JSON line; exits 1 when the rel diff reaches DIST_REL_TOL."""
    from gnn_tail_generalization_tpu_torch.data.datasets import prepare_sharded
    from gnn_tail_generalization_tpu_torch.ops import _build
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, data = build_raw_workload()
    rel = dist_numerics(cfg, data, device)
    rel_max = max(rel)
    pd_d = prepare_sharded(data, cfg, Comm(0, 1, device, "nccl"), rb=DIST_RB)
    _log(f"dist workload built: n_pad={pd_d.graph.n_node_pad}")
    step, _ = make_framework_step(cfg, pd_d, device)
    windows = time_step(step)
    launches = _build.launch_counts("spmm_csr")
    t = min(windows)
    n_edges = pd_d.edge_index.shape[1]
    _log(f"dist step: {t * 1e3:.3f} ms (numerics rel diff {rel_max:.3e})")
    ok = rel_max < DIST_REL_TOL
    print(json.dumps({
        "dist_step_ms": t * 1e3,
        "dist_step_ms_windows": [w * 1e3 for w in windows],
        "dist_edges_per_s": round(n_edges * cfg.num_layers / t),
        "dist_numerics_ok": ok,
        "dist_loss_rel_diff_max": rel_max,
        "dist_layout": "one rank of parallel/distgraph.py:DistGraph, no process group",
        "dist_rb": DIST_RB,
        "dist_kernel_launches": launches,
    }), flush=True)
    if not ok:
        print(f"--dist: loss rel diff {rel_max:.3e} >= {DIST_REL_TOL}",
              file=sys.stderr)
        sys.exit(1)


def dist_fields() -> dict:
    """``run_dist`` in a subprocess with a hard timeout; its JSON line. A
    crash, a timeout or a failed numerics check raises."""
    out = subprocess.run([sys.executable, "-u", __file__, "--dist"],
                         stdout=subprocess.PIPE, text=True, check=True,
                         timeout=DIST_TIMEOUT_S)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    from gnn_tail_generalization_tpu_torch.ops import _build
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.utils.device import device_info, resolve_device

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, pd = build_workload()
    n_edges = pd.graph.n_edge
    _log("workload built:", n_edges, "edges, plans:", pd.graph.has_plans)

    fw_step, model = make_framework_step(cfg, pd, device)
    torch.cuda.reset_peak_memory_stats()
    windows = time_step(fw_step)
    launches = _build.launch_counts("spmm_csr")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t_fw = min(windows)
    _log(f"framework: {[round(w * 1e3, 3) for w in windows]} ms/step, "
         f"launches {launches}")
    g = pd.graph.to(device)
    bf16 = cfg.spmm_method == "pallas_bf16" and g.has_plans
    bound_ms = step_spmm_bound_ms(g, conv_widths(model), bf16)
    flops = step_model_flops(model, pd.n_node, n_edges)
    del fw_step, model, g

    nv_step, _ = make_naive_step(cfg, pd, device)
    t_nv = min(time_step(nv_step))
    _log(f"naive: {t_nv * 1e3:.3f} ms/step")
    del nv_step
    torch.cuda.empty_cache()

    dist = dist_fields()
    print(json.dumps({
        "metric": METRIC,
        "value": round(n_edges * cfg.num_layers / t_fw),
        "unit": "edges/s",
        "vs_baseline": t_nv / t_fw,
        "step_ms": t_fw * 1e3,
        "step_ms_median": statistics.median(windows) * 1e3,
        "step_ms_windows": [w * 1e3 for w in windows],
        "naive_step_ms": t_nv * 1e3,
        "n_edges": n_edges,
        "num_layers": cfg.num_layers,
        "spmm_bound_ms": bound_ms,
        "pct_spmm_bound": 100 * bound_ms / (t_fw * 1e3),
        "mfu": flops / (t_fw * K.F32_FLOPS),
        "mfu_peak": "67 TFLOP/s: H100 SXM f32 outside the tensor cores (TF32 off)",
        "step_definition": (f"train fwd+bwd+adam, eager; best of {WINDOWS} windows of "
                            f"{TIMED_STEPS} steps after {TIMED_STEPS} warm-up steps, "
                            "each window ending in torch.cuda.synchronize()"),
        "masked_final_layer": bool(cfg.optimize_final_layer_agg),
        "timed_steps": WINDOWS * TIMED_STEPS,
        "kernel_launches": launches,
        "peak_gib": peak_gib,
        "device": device_info(),
        **dist,
    }))


if __name__ == "__main__":
    if "--dist" in sys.argv:
        run_dist()
    else:
        main()
