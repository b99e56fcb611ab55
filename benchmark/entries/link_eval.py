"""The link predictor's OGB evaluation: calls of the port's
``linkpred/model.py:evaluate`` under the configuration's ``eval_metric``
(``mrr``).

Set-up makes the citation2-shaped split, the model's weights and each
held-out positive's ``n_eval_neg`` uniform negative destinations from the
seed (all on the card), runs the port's preparation of the message graph
(``prep``), and makes the first call, whose valid and test MRRs, and the
scores behind them (read by a forward hook on the predictor), the check
holds to the reference. A unit is one call: the eval-mode
encode of every node, the scores of every positive and negative pair in
``predict_chunked``'s chunks, and the MRR of each split over each
positive's own negatives.
"""
from __future__ import annotations

import math

import torch

from entries import linkpred as lp
from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
from harness import check, gen, roofline
from harness.capture import EvalOutputs

SPLITS = ("valid", "test")


class LinkEvalCell:
    def __init__(self, ctx, cfg, inp, init, model, const, split_edge, first):
        self.ctx, self.cfg, self.inp, self.init = ctx, cfg, inp, init
        self.device = ctx.device
        self.model, self.const, self.split_edge, self.first = model, const, split_edge, first

    def unit(self):
        mrr = lpm.evaluate(self.cfg, self.model, self.const, self.split_edge)["MRR"]
        return 1, int(not all(math.isfinite(v) for v in mrr))

    def work(self):
        c, n = self.cfg, self.inp.n_node
        g = self.inp.graph(self.device)
        nnz = int(g["src"].numel())
        n_src = int(torch.unique(g["src"]).numel())
        d = c.gnn_hidden_channels
        pairs = sum(self.split_edge[s]["edge"].shape[0] + self.split_edge[s]["edge_neg"].shape[0]
                    for s in SPLITS)
        flops = (lp.encode_flops(c, n) + c.gnn_num_layers * roofline.spmm_flops(nnz, d)
                 + roofline.gemm_flops(pairs, d, 1))
        return {"flops": flops,
                "spmm_least_s": c.gnn_num_layers * roofline.spmm_least_s(n, n_src, nnz, d)}

    def release(self):
        self.model = self.const = None

    def program_outputs(self):
        return self.first

    def reference(self, tf32: bool = False, fault=None):
        """The reference's evaluation from the benchmark's weights
        (``evaluate`` of the configuration's reference); ``tf32``: the
        control; ``fault``: a fault planted in it."""
        return self.inp.reference.evaluate(self.inp.graph(self.device), self.init,
                                           self.split_edge, self.ctx.config["model"],
                                           tf32=tf32, fault=fault)

    def compare(self, prog, ref):
        return check.ranking(prog, ref, self.inp.reference.ogb_reciprocal_ranks,
                             self.ctx.traffic["limits"])

    def check(self):
        return self.compare(self.first, self.reference())


def build(ctx):
    dev = ctx.device
    with ctx.stage("generate"):
        cfg = lp.port_config(ctx.config)
        if cfg.eval_metric != "mrr":
            raise ValueError(f"the evaluation cell reads MRRs; the configuration's "
                             f"eval_metric is {cfg.eval_metric!r}")
        inp = lp.inputs(ctx.config, ctx.seed, dev)
        init = gen.weights(lp.model_inits(cfg, inp.n_node), ctx.seed, dev)
        k = int(ctx.config["dataset"]["n_eval_neg"])
        split_edge = {}
        for i, s in enumerate(SPLITS):
            pos = torch.as_tensor(inp.split[s], device=dev)
            split_edge[s] = {"edge": pos,
                             "edge_neg": gen.eval_negatives(pos, inp.n_node, k, ctx.seed, 7 + i)}
    with ctx.stage("prep"):
        g, _ = lp.port_message_graph(cfg, inp, dev, with_keys=False)
    with ctx.stage("warmup"):
        model = lp.port_model(cfg, inp.n_node, init, ctx.seed, dev)
        const = lpm.link_const(cfg, g, torch.zeros(inp.n_node, 1, device=dev))
        scores = EvalOutputs(type(model.predictor))
        with scores:
            mrr = lpm.evaluate(cfg, model, const, split_edge)["MRR"]
    first = program_outputs(mrr, scores.outputs, split_edge)
    return LinkEvalCell(ctx, cfg, inp, init, model, const, split_edge, first)


def program_outputs(mrr, chunks, split_edge):
    """{split: {"mrr", "pos", "neg"}}: the MRRs the call reported and the
    scores its predictor gave, in ``evaluate``'s order (valid positives,
    valid negatives, test positives, test negatives), kept on the host so
    that the window's memory holds none of them; the scores None where the
    call scored another number of pairs."""
    flat = torch.cat(chunks).cpu() if chunks else torch.zeros(0)
    sizes = [n for s in SPLITS for n in (split_edge[s]["edge"].shape[0],
                                         split_edge[s]["edge_neg"].shape[0])]
    parts = list(torch.split(flat, sizes)) if flat.numel() == sum(sizes) else [None] * 4
    out = {}
    for i, s in enumerate(SPLITS):
        pos, neg = parts[2 * i], parts[2 * i + 1]
        out[s] = {"mrr": mrr[i], "pos": pos,
                  "neg": None if neg is None else neg.view(pos.shape[0], -1)}
    return out
