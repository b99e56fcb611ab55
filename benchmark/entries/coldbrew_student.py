"""The Cold Brew student's second part: calls of the port's
``train/loops.py:train_semlp_part2``.

Set-up makes the node inputs, the teacher's SE table ([N, se_dim], N(0,
1)) and part 1's weights from the seed on the card (not trained: part 2
only reads them), runs the port's ``prepare`` (``prep``) for the split and
the head / tail / isolation subsets, and makes the first call of
``check_steps`` epochs, whose per-epoch losses, eval predictions (read by
a forward hook) and accuracies, and final parameters the check holds to
the reference. The window calls ``train_semlp_part2`` with
``epochs_per_call`` epochs. A step is one epoch: a train step on a batch
of train nodes, then the eval forwards of a test batch and of the head,
tail and isolation subsets, every row through the latent-neighbour
replacement against all N rows of the SE table.
"""
from __future__ import annotations

import numpy as np
import torch

from entries import coldbrew as cb
from gnn_tail_generalization_tpu_torch.data.datasets import prepare
from gnn_tail_generalization_tpu_torch.models.semlp import SEMLPPart1, SEMLPPart2
from gnn_tail_generalization_tpu_torch.train.loops import TrainResult, train_semlp_part2
from harness import gen, roofline, spec
from harness.capture import EvalOutputs


def part1_inits(cfg, se_dim: int):
    """(shape, init) of part 1's leaves: Dense kernels of lecun variance,
    LayerNorm scales 1, biases 0."""
    with torch.device("meta"):
        state = SEMLPPart1(cfg, se_dim=se_dim).state_dict()
    inits = {}
    for k, t in state.items():
        shape = tuple(t.shape)
        if k.endswith(".weight") and len(shape) == 2:
            inits[k] = (shape, ("normal", shape[1] ** -0.5))
        elif k.endswith(".weight"):
            inits[k] = (shape, ("ones",))
        elif k.endswith(".bias"):
            inits[k] = (shape, ("zeros",))
        else:
            raise ValueError(f"no initialiser for part 1's leaf {k} {shape}")
    return inits


class StudentCell:
    def __init__(self, ctx, cfg, pd, inp, se, part1, first):
        self.ctx, self.cfg, self.pd, self.inp, self.se, self.part1 = ctx, cfg, pd, inp, se, part1
        self.device = ctx.device
        self.first = first
        self.epochs = int(ctx.traffic["epochs_per_call"])

    def unit(self):
        res = train_semlp_part2(self.cfg, self.pd, self.se, self.part1, self.ctx.seed,
                                epochs=self.epochs, device=self.device)
        loss = res.records[:, res.columns.index("loss_train")]
        return self.epochs, int((~np.isfinite(loss)).sum())

    def ref_conf(self):
        s, d = self.ctx.config["student"], self.ctx.config["dataset"]
        return {"batch_size": s["batch_size"], "dropout_MLP": s["dropout_MLP"],
                "top_k": s["SEMLP_topK_2_replace"], "hidden": s["hidden"],
                "n_class": d["n_class"], "lr": s["lr"], "weight_decay": s["weight_decay"]}

    def work(self):
        c, s = self.cfg, self.ctx.config["student"]
        n, f, k, h = c.N_nodes, c.num_feats, c.num_classes, s["hidden"]
        e = self.se.shape[1]
        n_train = int(self.inp.train_mask.sum())
        bsz = min(s["batch_size"], n_train)
        g = self.inp.graph()
        eval_rows = bsz + sum(len(g[k_]) for k_ in ("head", "tail", "iso"))
        part1 = roofline.gemm_flops(1, f, 256) + roofline.gemm_flops(1, 256, e)
        replace = roofline.gemm_flops(1, e, n) + roofline.gemm_flops(1, s["SEMLP_topK_2_replace"], e)
        part2 = roofline.gemm_flops(1, f + 2 * e, h) + roofline.gemm_flops(1, h, k)
        flops = bsz * (part1 + replace + 3 * part2) + eval_rows * (part1 + replace + part2)
        return {"flops": flops, "spmm_least_s": None}

    def release(self):
        self.pd = None

    def program_outputs(self):
        return self.first

    def reference(self, tf32: bool = False, fault=None):
        ref = spec.load_module("reference", self.ctx.config["name"])
        m = self.inp.train_mask
        g = self.inp.graph()
        subsets = {k: torch.as_tensor(g[k], device=self.device) for k in ("head", "tail", "iso")}
        return ref.student_steps(self.inp.x, self.inp.y, m.nonzero()[:, 0], (~m).nonzero()[:, 0],
                                 subsets, self.se, self.part1.state_dict, self.ref_conf(),
                                 self.ctx.seed, len(self.first[0]), tf32=tf32, fault=fault)

    def compare(self, prog, ref):
        return cb.compare(prog, ref, ref[5], self.ctx.traffic["limits"])

    def frozen(self, ref):
        """What a step that leaves its state unchanged would give: every
        step the first step's loss, the parameters as they started (the
        eval as the reference's: this fault is the train step's)."""
        return [ref[0][0]] * len(ref[0]), ref[5], None, ref[3], ref[4]

    def check(self):
        return self.compare(self.first, self.reference())


def build(ctx):
    dev = ctx.device
    with ctx.stage("generate"):
        cfg = cb.port_config(ctx.config, "student")
        inp = cb.node_inputs(ctx.config, ctx.seed, dev)
        data = cb.port_node_data(inp, ctx.config["name"])
        se_dim = ctx.config["student"]["se_dim"]
        se = torch.randn(cfg.N_nodes, se_dim, generator=gen.generator(ctx.seed, dev, 5),
                         device=dev)
        part1 = TrainResult(columns=[], records=np.zeros((0, 0)), step_ms=[],
                            state_dict=gen.weights(part1_inits(cfg, se_dim), ctx.seed, dev))
    with ctx.stage("prep"):
        pd = prepare(data, cfg)
    predicted = EvalOutputs(SEMLPPart2, lambda out: out.argmax(dim=1))
    with ctx.stage("warmup"), predicted:
        res = train_semlp_part2(cfg, pd, se, part1, ctx.seed,
                                epochs=int(ctx.traffic["check_steps"]), device=dev)
    first = cb.program_outputs(res, predicted.outputs)
    return StudentCell(ctx, cfg, pd, inp, se, part1, first)
