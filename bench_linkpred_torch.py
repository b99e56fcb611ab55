"""Link prediction at the ogbl-citation2 shape on one CUDA card, through the
PyTorch port. The twin of ``bench_linkpred.py``.

    python3 bench_linkpred_torch.py   # ONE JSON line on stdout, logs on stderr

The workload (``bench_linkpred.py:49-98``): ``fast_powerlaw_graph(2_927_963,
15_193_997, 0)``; 128 features drawn on the card from a seeded
``torch.Generator`` (the original draws them with ``jax.random`` on its
device, so the two tables differ); the split of ``build_split``: from a
``default_rng(seed)`` permutation, 8,192 valid and 8,192 test positives,
50 sampled non-edges each (``linkpred/sampling.py:
rejection_sample_non_edges`` at ``default_rng(seed + 1)``), the rest train,
and the message edges the symmetrized train edges.

Then, in the original's order:
1. the JAX bench config (SAGE + DOT, ``ce_loss``, features, no embedding,
   ``num_neg=3``, batch 65,536, ``pallas_bf16``) through
   ``linkpred/model.py:train_linkpred``: 2 epochs of 8 steps, ``mrr_test``
   finite;
2. the step timed: the same library pieces assembled once (the message
   graph, the hoisted layer-1 aggregation cast to bf16, clip + Adam, the
   device epoch of ``make_epoch_fn``), one warm 16-step epoch, then the best
   of 4 timed epochs (host clock, each ending in ``torch.cuda.synchronize()``);
   ``step_ms`` = that epoch / 16. The step runs 2 SpMMs on the bf16 kernel
   (layer 2's forward and its transposed backward); ``spmm_bound_ms`` is
   their least time by ``ops/spmm_kernels.py:spmm_bound``, and
   ``kernel_launches`` the SpMM wrappers' counts over the timed epochs;
3. the OGB protocol (``bench_linkpred.py:190-246``): 1,000 uniform negative
   destinations for each of 8,192 valid positives, drawn from the script's
   ``rng``; one encode, ``predict_chunked`` (one launch of the pair-scoring
   kernel a split for this DOT model), the grouped MRR of
   ``linkpred/metrics.py``, warm.

The JSON line carries the original's keys, ``kernel_launches``, ``peak_gib``
(over the run) and ``device``; unlike the original it writes no file.
Without a CUDA device ``main`` raises: nothing is measured on the CPU.
"""
import contextlib
import json
import sys
import time

import numpy as np
import torch

N_NODE, N_EDGE, N_FEAT = 2_927_963, 30_387_995 // 2, 128
EVAL_POS, NUM_NEG_EVAL, OGB_NEG = 8192, 50, 1000
TIMED_STEPS, TIMED_EPOCHS = 16, 4

_T0 = time.time()


def _log(*a):
    print(f"[lp {time.time() - _T0:6.1f}s]", *a, file=sys.stderr, flush=True)


def bench_config():
    """The JAX package's bench config (``bench_linkpred.py:100-105``)."""
    from gnn_tail_generalization_tpu_torch.linkpred.model import LinkPredConfig

    return LinkPredConfig(
        encoder="SAGE", predictor="DOT", loss_func="ce_loss",
        use_node_feats=True, train_node_emb=False, eval_metric="mrr",
        num_neg=3, batch_size=64 * 1024, spmm_method="pallas_bf16")


def build_split(e, n_node, rng, seed, eval_pos=EVAL_POS, num_neg_eval=NUM_NEG_EVAL):
    """``bench_linkpred.py:68-98``: (split_edge, message edges, train [2, m],
    valid [2, eval_pos]). ``rng`` draws the permutation (the caller keeps
    drawing from it)."""
    from gnn_tail_generalization_tpu_torch.graph.core import symmetrize
    from gnn_tail_generalization_tpu_torch.linkpred import sampling

    perm = rng.permutation(e.shape[1])
    val = e[:, perm[:eval_pos]]
    test = e[:, perm[eval_pos: 2 * eval_pos]]
    train = e[:, perm[2 * eval_pos:]]
    negs = np.asarray(sampling.rejection_sample_non_edges(
        np.random.default_rng(seed + 1), sampling.edge_keys(e, n_node), n_node,
        2 * eval_pos * num_neg_eval))
    split_edge = {
        "train": {"edge": train.T},
        "valid": {"edge": val.T, "edge_neg": negs[: eval_pos * num_neg_eval]},
        "test": {"edge": test.T, "edge_neg": negs[eval_pos * num_neg_eval:]},
    }
    return split_edge, symmetrize(train, n_node), train, val


def ogb_eval_pairs(val, rng, n_node, n_pos=EVAL_POS, n_neg=OGB_NEG):
    """``bench_linkpred.py:199-204``: the first ``n_pos`` valid positives
    [n_pos, 2] and their ``n_neg`` uniform negative destinations each, as
    pairs [n_pos * n_neg, 2] grouped by positive."""
    pos = val.T[:n_pos].astype(np.int64)
    neg_dst = rng.integers(0, n_node, (n_pos, n_neg))
    neg = np.stack([np.repeat(pos[:, 0], n_neg), neg_dst.reshape(-1)], axis=1)
    return pos, neg


def make_link_epoch(cfg, g, x, train, msg_edges, steps=TIMED_STEPS, seed=0):
    """(epoch, model, const): the link step as ``train_linkpred`` assembles
    it (``link_const``'s hoisted layer-1 aggregation, clip + Adam, the device
    epoch of ``make_epoch_fn``) on the message graph ``g`` (on the card) and
    features ``x`` (None: the config's trained embedding alone). ``epoch()``
    runs ``steps`` train steps over the first ``steps`` x batch positives of
    ``train`` [2, m] and returns their losses on the device; one generator
    seeded ``seed`` draws the model, then each epoch's permutation and
    negatives."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.linkpred import sampling

    dev, n_node = g.indptr.device, g.n_node
    const = lpm.link_const(cfg, g, x)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        model = lpm.LinkPredModel(cfg, n_node, 0 if x is None else x.shape[1],
                                  generator=gen)
    bsz = cfg.batch_size
    pos_all = torch.as_tensor(train.T[: steps * bsz].astype(np.int64), device=dev)
    epoch = lpm.make_epoch_fn(cfg, model, lpm.make_optimizer(cfg, model.parameters()),
                              n_node, steps, bsz, pos_all.shape[0])
    keys = sampling.build_membership(sampling.edge_keys(msg_edges, n_node)).to(dev)
    model.train()
    return (lambda: epoch(const, pos_all, keys, gen)), model, const


def main(n_node=N_NODE, n_edge=N_EDGE, n_feat=N_FEAT, eval_pos=EVAL_POS,
         num_neg_eval=NUM_NEG_EVAL, seed=0):
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.linkpred import metrics as M
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.ops import _build
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.utils.device import device_info, resolve_device

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    e = fast_powerlaw_graph(n_node, n_edge, seed)
    _log(f"graph built: {e.shape[1]} directed edges")
    x = torch.randn(n_node, n_feat, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    split_edge, msg_edges, train, val = build_split(e, n_node, rng, seed,
                                                    eval_pos, num_neg_eval)
    _log(f"split built: train={train.shape[1]} msg={msg_edges.shape[1]}")
    cfg = bench_config()

    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON line only
        out = lpm.train_linkpred(
            cfg, x, e, n_node, epochs=2, runs=1, eval_steps=2, seed=seed,
            split_edge=split_edge, msg_edges=msg_edges, max_steps_per_epoch=8,
            log_every=1, device=dev)
    wall = time.time() - t0
    mrr_test = out["stats"]["test_mean"]
    _log(f"train_linkpred: {out['stats']} wall={wall:.1f}s")
    if not np.isfinite(mrr_test):
        raise RuntimeError(f"train_linkpred: mrr_test {mrr_test}")
    del out

    # the step timed: the library pieces train_linkpred uses, assembled once
    g = lpm.link_graph(cfg, msg_edges, n_node).to(dev)
    epoch, model, const = make_link_epoch(cfg, g, x, train, msg_edges, seed=seed)
    bsz = cfg.batch_size

    def timed_epoch() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = epoch()
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        if not torch.isfinite(losses).all():
            raise RuntimeError(f"non-finite losses {losses.tolist()}")
        return t

    timed_epoch()  # warm
    _build.reset_launch_counts()
    epoch_s = [timed_epoch() for _ in range(TIMED_EPOCHS)]
    launches = _build.launch_counts("spmm_csr")
    warm_epoch = min(epoch_s)
    step_ms = warm_epoch / TIMED_STEPS * 1e3
    bf16 = cfg.spmm_method == "pallas_bf16" and g.has_plans
    d = cfg.gnn_hidden_channels
    bound_ms = K.spmm_bound(g, d, bf16)[0] + K.spmm_bound(g.transpose(), d, bf16)[0]
    _log(f"step: {step_ms:.3f} ms; epochs s {epoch_s}; launches {launches}")

    pos_eval, neg_edges = ogb_eval_pairs(val, rng, n_node, eval_pos, OGB_NEG)
    pos_t = torch.as_tensor(pos_eval, device=dev)
    neg_t = torch.as_tensor(neg_edges, device=dev)

    def ogb_eval() -> float:
        model.eval()
        with torch.no_grad():
            h = lpm.encode_all(model, const)
            pos_s = lpm.predict_chunked(model, h, pos_t)
            neg_s = lpm.predict_chunked(model, h, neg_t)
        return M.mrr(pos_s, neg_s.reshape(len(pos_eval), OGB_NEG))  # reads back

    ogb_eval()  # warm
    t0 = time.perf_counter()
    mrr_1000 = ogb_eval()
    eval_s = time.perf_counter() - t0
    _log(f"OGB eval: {len(pos_eval)} x {OGB_NEG} in {eval_s:.3f}s, MRR={mrr_1000:.4f}")
    if not np.isfinite(mrr_1000):
        raise RuntimeError(f"OGB eval MRR {mrr_1000}")

    print(json.dumps({
        "metric": "linkpred_citation2_scale",
        "n_node": n_node,
        "n_msg_edges": int(msg_edges.shape[1]),
        "train_positives": int(train.shape[1]),
        "encoder": cfg.encoder, "predictor": cfg.predictor,
        "mrr_test": float(mrr_test),
        "eval_protocol": f"MRR over {num_neg_eval} sampled uniform negatives per "
                         "positive (train-loop eval); the fixed-1000-negative OGB "
                         "protocol is timed separately",
        "ogb_1000neg_eval": {
            "n_pos": len(pos_eval), "n_neg_per_pos": OGB_NEG, "mrr": mrr_1000,
            "warm_eval_s": eval_s,
            "definition": "full-graph encode + chunked predict of "
                          f"[{len(pos_eval)} pos + {len(pos_eval)}x{OGB_NEG} neg] "
                          "pairs, grouped MRR"},
        "wall_s_2epochs_8steps_cold": wall,
        "warm_epoch_steps": TIMED_STEPS,
        "timed_epochs": TIMED_EPOCHS,
        "warm_epoch_s": warm_epoch,
        "epoch_s": epoch_s,
        "step_ms": step_ms,
        "step_definition": (f"train fwd+bwd+clip+adam, {bsz}-edge batch, full-graph "
                            f"encode; step_ms = best of {TIMED_EPOCHS} eager "
                            f"{TIMED_STEPS}-step epochs (after a warm one, each "
                            f"ending in torch.cuda.synchronize()) / {TIMED_STEPS}; "
                            "layer-1 aggregation hoisted (2 SpMMs a step)"),
        "spmm_bound_ms": bound_ms,
        "pct_spmm_bound": 100 * bound_ms / step_ms,
        "kernel_launches": launches,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
