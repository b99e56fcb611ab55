"""The link predictor's training: slices of the port's device epoch
(``linkpred/model.py:make_epoch_fn``), walking through the train
positives.

Set-up makes the citation2-shaped split and the model's weights from the
seed, runs the port's preparation of the message graph and the negative
sampler's membership table (``prep``), and assembles the step as
``train_linkpred`` assembles it: the model holding those weights, clip +
Adam, the step constants, and one train generator seeded ``seed + 1``.
Its first slice, of ``check_steps`` steps, drives that one object through
its first steps; the check holds their losses and the parameters after
them to the reference. The window goes on with slices of
``steps_per_slice`` steps over the next positives, reading each slice's
losses back once, as ``train_linkpred`` reads an epoch's. A step is one
train step: full-graph encode, the batch's scores, backward, clip, Adam.
"""
from __future__ import annotations

import torch

from entries import linkpred as lp
from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
from harness import check, gen, roofline, spec


class LinkTrainCell:
    def __init__(self, ctx, cfg, inp, init, model, epoch_fn, const, keys, pos, gen_, first,
                 cursor):
        self.ctx, self.cfg, self.inp, self.init = ctx, cfg, inp, init
        self.device = ctx.device
        self.model, self.epoch_fn, self.const, self.keys = model, epoch_fn, const, keys
        self.pos, self.gen, self.first, self.cursor = pos, gen_, first, cursor
        self.steps = int(ctx.traffic["steps_per_slice"])

    def unit(self):
        n = self.steps * self.cfg.batch_size
        if self.cursor + n > self.pos.shape[0]:
            self.cursor = 0
        losses = self.epoch_fn(self.const, self.pos[self.cursor:self.cursor + n], self.keys,
                               self.gen)
        self.cursor += n
        return self.steps, int((~torch.isfinite(losses)).sum())  # the slice's one read

    def work(self):
        c, n = self.cfg, self.inp.n_node
        g = self.inp.graph(self.device)
        nnz = int(g["src"].numel())
        n_src = int(torch.unique(g["src"]).numel())
        d = c.gnn_hidden_channels
        agg = c.gnn_num_layers * 2  # each layer's aggregation forward and backward
        pairs = c.batch_size * (1 + c.num_neg)
        flops = (3 * lp.encode_flops(c, n) + agg * roofline.spmm_flops(nnz, d)
                 + 3 * roofline.gemm_flops(pairs, d, 1))
        return {"flops": flops, "spmm_least_s": agg * roofline.spmm_least_s(n, n_src, nnz, d)}

    def release(self):
        self.model = self.epoch_fn = self.const = self.keys = None

    def program_outputs(self):
        return self.first

    def reference(self, tf32: bool = False, fault=None):
        ref = spec.load_module("reference", self.ctx.config["name"])
        k = len(self.first[0])
        pos = self.pos[: k * self.cfg.batch_size]
        return ref.train_steps(self.inp.graph(self.device), pos, self.init, self.ctx.config["model"],
                               self.ctx.seed, k, tf32=tf32, fault=fault)

    def compare(self, prog, ref):
        return check.training(prog, ref, self.init, self.ctx.traffic["limits"])

    def frozen(self, ref):
        """What a step that leaves its state unchanged would give: every
        step the first step's loss, the parameters as they started."""
        return [ref[0][0]] * len(ref[0]), self.init

    def check(self):
        return self.compare(self.first, self.reference())


def build(ctx):
    dev = ctx.device
    with ctx.stage("generate"):
        cfg = lp.port_config(ctx.config)
        inp = lp.inputs(ctx.config, ctx.seed, dev)
        init = gen.weights(lp.model_inits(cfg, inp.n_node), ctx.seed, dev)
        pos = torch.as_tensor(inp.split["train"], device=dev)
    with ctx.stage("prep"):
        g, keys = lp.port_message_graph(cfg, inp, dev, with_keys=True)
    with ctx.stage("warmup"):
        model = lp.port_model(cfg, inp.n_node, init, ctx.seed, dev)
        opt = lpm.make_optimizer(cfg, model.parameters())
        const = lpm.link_const(cfg, g, torch.zeros(inp.n_node, 1, device=dev))
        gen_ = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
        bsz, k = cfg.batch_size, int(ctx.traffic["check_steps"])
        s = int(ctx.traffic["steps_per_slice"])
        first_fn = lpm.make_epoch_fn(cfg, model, opt, inp.n_node, k, bsz, k * bsz)
        epoch_fn = lpm.make_epoch_fn(cfg, model, opt, inp.n_node, s, bsz, s * bsz)
        model.train()
        losses = first_fn(const, pos[: k * bsz], keys, gen_)
        first = ([float(v) for v in losses.cpu()],
                 {n: t.detach().clone() for n, t in model.state_dict().items()})
        cell = LinkTrainCell(ctx, cfg, inp, init, model, epoch_fn, const, keys, pos, gen_,
                             first, k * bsz)
        cell.unit()  # the window's slice, once, so that every shape it uses has run
    return cell
