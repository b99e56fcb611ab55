"""Cold Brew's teacher under I2-GTL's edgewise loss: calls of the port's
``train/loops.py:train_teacher`` with the traffic's ``teacher`` keys
(``exp_mode=I2_GTL``, ``task=nodeC`` and the pair counts) over the
configuration's teacher.

As ``coldbrew_teacher``'s cell, but the loss is the mean binary
cross-entropy of DistMult scores over ``samp_size_p`` positive pairs and
``samp_size_n_train`` negatives, drawn on the card each epoch, plus the SE
regulariser (no NLL, so every layer runs on the full graph), and each
epoch's eval also scores ``samp_size_p`` test positives against 20 times
as many negatives. The records gain the two MRRs, which the check holds to
the reference's (``mrr_gap``) beside the teacher's numbers.
"""
from __future__ import annotations

import dataclasses

import torch

from entries import coldbrew as cb
from entries import coldbrew_teacher as ct
from gnn_tail_generalization_tpu_torch.config import apply_arch_configs
from gnn_tail_generalization_tpu_torch.data.datasets import prepare
from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
from gnn_tail_generalization_tpu_torch.train.loops import train_teacher
from harness import check, gen, roofline, spec
from harness.capture import EvalOutputs

MRRS = ("linkp_train", "linkp_test")


def port_config(ctx):
    """The port's teacher ``Config`` with the traffic's ``teacher`` keys;
    raises where the port's teacher then trains anything but the edgewise
    loss."""
    keys = ctx.traffic["teacher"]
    cfg = apply_arch_configs(dataclasses.replace(cb.port_config(ctx.config, "teacher"), **keys))
    if not cfg.has_loss_component_edgewise or cfg.has_loss_component_nodewise:
        raise ValueError(f"the port's teacher with {keys} does not train the edgewise loss alone")
    return cfg


def mrr_gap(prog, ref, limit: float) -> check.Compared:
    """The largest distance, over the steps and ``MRRS``, of an MRR the
    program records from the range of the reference's (``{name: (MRR,
    lowest, highest)}`` a step; an MRR of the reference in the program's
    place counts as its first); inf where the program lacks one."""
    gaps = {}
    for step, r in enumerate(ref):
        p = prog[step] if step < len(prog) else {}
        for name in MRRS:
            got = p.get(name)
            got = got[0] if isinstance(got, tuple) else got
            gaps[f"{name}@{step}"] = (float("inf") if got is None
                                      else max(r[name][1] - got, got - r[name][2], 0.0))
    worst = max(gaps, key=gaps.get)
    return check.Compared("mrr_gap", gaps[worst], limit, worst)


class EdgewiseCell(ct.TeacherCell):
    def work(self):
        c, t = self.cfg, self.ctx.traffic["teacher"]
        n, f, h, k, layers = c.N_nodes, c.num_feats, c.dim_hidden, c.num_classes, c.num_layers
        s = cb.graph_shapes(self.inp.graph(), n, self.inp.train_mask.cpu().numpy())
        fwd = (roofline.gemm_flops(n, f, h) + layers * roofline.gemm_flops(n, h, h)
               + roofline.gemm_flops(n, h, k))
        # every layer forward and backward on the full graph, then the eval
        # forward; a scored pair is 2k FLOPs, x3 in training
        spmm = 3 * layers
        p = t["samp_size_p"]
        pairs = 3 * (p + t["samp_size_n_train"]) + p * (1 + t["samp_size_n_test_times_p"])
        return {"flops": 4 * fwd + spmm * roofline.spmm_flops(s["nnz"], h) + pairs * 2 * k,
                "spmm_least_s": spmm * roofline.spmm_least_s(n, s["n_src"], s["nnz"], h)}

    def reference(self, tf32: bool = False, fault=None):
        """(losses, parameters after, first gradient norms, eval accuracies,
        eval predictions, MRRs) of ``reference/edgewise.py`` over the
        check's steps; ``tf32``: the control; ``fault``: planted in it."""
        ref = spec.load_module("reference", "edgewise")
        graph = {k: torch.as_tensor(v, device=self.device) for k, v in self.inp.graph().items()}
        conf = {**self.ctx.config["teacher"], **self.ctx.traffic["teacher"]}
        return ref.teacher_steps(graph, self.inp.x, self.inp.y, self.inp.train_mask, self.init,
                                 conf, self.ctx.seed, len(self.first[0]), tf32=tf32,
                                 fault=fault)

    def compare(self, prog, ref):
        limits = self.ctx.traffic["limits"]
        return cb.compare(prog, ref, self.init, limits) + [
            mrr_gap(prog[5], ref[5], limits["mrr_gap"])]

    def frozen(self, ref):
        """What a step that leaves its state unchanged would give: every
        step the first step's loss, the parameters as they started, the
        eval and the MRRs as the reference's."""
        return [ref[0][0]] * len(ref[0]), self.init, None, ref[3], ref[4], ref[5]


def build(ctx):
    with ctx.stage("generate"):
        cfg = port_config(ctx)
        inp = cb.node_inputs(ctx.config, ctx.seed, ctx.device)
        data = cb.port_node_data(inp, ctx.config["name"])
        init = gen.weights(ct.teacher_inits(cfg), ctx.seed, ctx.device)
    with ctx.stage("prep"):
        pd = prepare(data, cfg)
    predicted = EvalOutputs(TeacherGNN, lambda out: out[1].argmax(dim=1))
    with ctx.stage("warmup"), predicted:
        res = train_teacher(cfg, pd, ctx.seed, epochs=int(ctx.traffic["check_steps"]),
                            init_state=init, device=ctx.device)
    first = cb.program_outputs(res, predicted.outputs)
    mrrs = [{k: e[k] for k in MRRS if k in e} for e in first[3]]
    return EdgewiseCell(ctx, cfg, pd, inp, init, (*first, mrrs))
