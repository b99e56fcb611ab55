"""The Cold Brew teacher: calls of the port's ``train/loops.py:train_teacher``.

Set-up makes the node inputs and the teacher's initial weights from the
seed (on the card), runs the port's ``data/datasets.py:prepare`` (the
``prep`` stage), and makes the first call: ``check_steps`` epochs from
those weights, whose per-epoch losses, eval predictions (read by a
forward hook) and accuracies, and final parameters the check holds to the
reference. The window then calls ``train_teacher`` with
``epochs_per_call`` epochs, from the same weights, each call paying its own
set-up as a user's run does. A step is one epoch: the train step and the
eval forward with its head / tail / isolation accuracies.
"""
from __future__ import annotations

import numpy as np
import torch

from entries import coldbrew as cb
from gnn_tail_generalization_tpu_torch.data.datasets import prepare
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.train.loops import train_teacher
from harness import gen, roofline, spec
from harness.capture import EvalOutputs


def teacher_inits(cfg):
    """(shape, init) of every leaf of the port's teacher: structural
    embeddings N(0, 1), conv kernels ``[in, out]`` of xavier variance
    2 / (in + out), Dense kernels ``[out, in]`` of lecun variance 1 / in,
    biases 0."""
    with torch.device("meta"):
        state = TeacherGNN(cfg).state_dict()
    inits = {}
    for k, t in state.items():
        shape = tuple(t.shape)
        if k.endswith(".se"):
            inits[k] = (shape, ("normal", 1.0))
        elif ".convs." in k and k.endswith(".weight"):
            inits[k] = (shape, ("normal", (2.0 / sum(shape)) ** 0.5))
        elif k.endswith(".weight") and len(shape) == 2:
            inits[k] = (shape, ("normal", shape[1] ** -0.5))
        elif k.endswith(".bias"):
            inits[k] = (shape, ("zeros",))
        else:
            raise ValueError(f"no initialiser for the teacher's leaf {k} {shape}")
    return inits


class TeacherCell:
    def __init__(self, ctx, cfg, pd, inp, init, first):
        self.ctx, self.cfg, self.pd, self.inp, self.init = ctx, cfg, pd, inp, init
        self.device = ctx.device
        self.first = first  # (losses, final state) of the check's call
        self.epochs = int(ctx.traffic["epochs_per_call"])

    def unit(self):
        res = train_teacher(self.cfg, self.pd, self.ctx.seed, epochs=self.epochs,
                            init_state=self.init, device=self.device)
        loss = res.records[:, res.columns.index("loss_train")]
        return self.epochs, int((~np.isfinite(loss)).sum())

    def work(self):
        c = self.cfg
        n, f, h, k, layers = c.N_nodes, c.num_feats, c.dim_hidden, c.num_classes, c.num_layers
        s = cb.graph_shapes(self.inp.graph(), n, self.inp.train_mask.cpu().numpy())
        fwd = (roofline.gemm_flops(n, f, h) + layers * roofline.gemm_flops(n, h, h)
               + roofline.gemm_flops(n, h, k))
        full = roofline.spmm_least_s(n, s["n_src"], s["nnz"], h)
        # train: the first layers forward and backward on the full graph, the
        # last on its loss-masked view; eval: every layer forward, full graph
        spmm_s = ((layers - 1) * 2 + layers) * full + (
            roofline.spmm_least_s(n, s["n_src_masked"], s["nnz_masked"], h)
            + roofline.spmm_least_s(n, s["n_dst_masked"], s["nnz_masked"], h))
        spmm_flops = (((layers - 1) * 2 + layers) * roofline.spmm_flops(s["nnz"], h)
                      + 2 * roofline.spmm_flops(s["nnz_masked"], h))
        return {"flops": 4 * fwd + spmm_flops, "spmm_least_s": spmm_s}

    def release(self):
        self.pd = None

    def reference(self, tf32: bool = False, fault=None):
        """(losses, parameters after, first gradient norms, eval accuracies,
        eval predictions) of the reference over the check's steps;
        ``tf32``: the control; ``fault``: a fault planted in it."""
        ref = spec.load_module("reference", self.ctx.config["name"])
        graph = {k: torch.as_tensor(v, device=self.device) for k, v in self.inp.graph().items()}
        return ref.teacher_steps(graph, self.inp.x, self.inp.y, self.inp.train_mask, self.init,
                                 dict(self.ctx.config["teacher"]), self.ctx.seed,
                                 len(self.first[0]), tf32=tf32, fault=fault)

    def program_outputs(self):
        return self.first

    def compare(self, prog, ref):
        return cb.compare(prog, ref, self.init, self.ctx.traffic["limits"])

    def frozen(self, ref):
        """What a step that leaves its state unchanged would give: every
        step the first step's loss, the parameters as they started (the
        eval as the reference's: this fault is the train step's)."""
        return [ref[0][0]] * len(ref[0]), self.init, None, ref[3], ref[4]

    def check(self):
        return self.compare(self.first, self.reference())


def build(ctx):
    with ctx.stage("generate"):
        cfg = cb.port_config(ctx.config, "teacher")
        inp = cb.node_inputs(ctx.config, ctx.seed, ctx.device)
        data = cb.port_node_data(inp, ctx.config["name"])
        init = gen.weights(teacher_inits(cfg), ctx.seed, ctx.device)
    with ctx.stage("prep"):
        pd = prepare(data, cfg)
    predicted = EvalOutputs(TeacherGNN, lambda out: out[1].argmax(dim=1))
    with ctx.stage("warmup"), predicted:
        res = train_teacher(cfg, pd, ctx.seed, epochs=int(ctx.traffic["check_steps"]),
                            init_state=init, device=ctx.device)
    first = cb.program_outputs(res, predicted.outputs)
    return TeacherCell(ctx, cfg, pd, inp, init, first)
