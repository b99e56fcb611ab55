"""The graph-transformer link predictor's training: the ``link_train`` cell
(slices of the port's device epoch, ``linkpred/model.py:make_epoch_fn``,
walking through the train positives) with an encoder whose layers attend
over the in-neighbourhoods (``encoder: Transformer``).

Set-up and the window are ``link_train``'s. The work a step
differs: each layer's four Dense GEMMs (query, key, value, skip) over every
node, three times for the training step; the attention's edge scores and
softmax (2·d FLOPs an edge forward) and its aggregation (2·d), and in the
backward ``dv``, the scores' gradient, ``dq`` and ``dk`` (2·d each); the
pair scores. The aggregations run in B1 (``spmm_least_s``: one a layer
forward, three backward); the attention rows' kernels have their own
least time (``attn_least_s``, ``harness/attn_roofline.py``: one call a
layer forward and one backward).

The check adds ``attn_gap``. At the model's initial scale the logits are
about 1e-6, so the weights are uniform to about 1e-5 and the query and key
leaves barely move in the check's steps: the training numbers cannot see
the softmax or its gradient. So set-up also runs the port's attention op
alone on the cell's message graph, on seeded operands of unit scale
(logits of about unit spread), forward and backward under a seeded output
gradient, and keeps the output and the three gradients, each projected on
``PROBE_COLS`` seeded columns. ``attn_gap`` is the largest, over the four,
of the norm of their difference from the reference's
(``attention_probe``) over the reference's norm.
"""
from __future__ import annotations

from typing import Dict

import torch

from entries import link_train as lt
from gnn_tail_generalization_tpu_torch.ops.edge_attention import edge_attention
from harness import attn_roofline, check, roofline, spec

#: seeded columns that the probe's [N, d] tensors are projected on
PROBE_COLS = 16


def probe_operands(n: int, d: int, seed: int, device):
    """q, k, v, the output gradient ([n, d] each, N(0, 1)) and the
    projection [d, PROBE_COLS], from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    return [torch.randn(n, d, generator=gen, device=device) for _ in range(4)] + [
        torch.randn(d, PROBE_COLS, generator=gen, device=device)]


def port_probe(g, q, k, v, d_out, proj) -> Dict[str, torch.Tensor]:
    """The port's ``attention_probe``: its op's output and gradients."""
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = edge_attention(g, q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), d_out)
    return {name: (t.detach() @ proj) for name, t in zip(("out", "dq", "dk", "dv"),
                                                          (out, *grads))}


def attn_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             limit: float) -> check.Compared:
    """The largest relative gap of the probe's tensors (module docstring)."""
    gaps = {k: float(torch.linalg.vector_norm(prog[k].double() - r.double())
                     / max(float(torch.linalg.vector_norm(r.double())), 1e-30))
            for k, r in ref.items()}
    worst = max(gaps, key=gaps.get)
    return check.Compared("attn_gap", gaps[worst], limit, worst, gaps)


class LinkTrainAttnCell(lt.LinkTrainCell):
    def work(self):
        c, n = self.cfg, self.inp.n_node
        g = self.inp.graph(self.device)
        nnz = int(g["src"].numel())
        n_src = int(torch.unique(g["src"]).numel())
        n_dst = int(torch.unique(g["dst"]).numel())
        d, layers = c.gnn_hidden_channels, c.gnn_num_layers
        gemms = layers * 4 * roofline.gemm_flops(n, d, d)
        attn = layers * (4 + 8) * d * nnz
        pairs = c.batch_size * (1 + c.num_neg)
        flops = 3 * gemms + attn + 3 * roofline.gemm_flops(pairs, d, 1)
        spmm = layers * 4 * roofline.spmm_least_s(n, n_src, nnz, d)
        rows = layers * (attn_roofline.attn_rows_least_s(n_dst, n_src, nnz, d, False)
                         + attn_roofline.attn_rows_least_s(n_dst, n_src, nnz, d, True))
        return {"flops": flops, "spmm_least_s": spmm, "attn_least_s": rows}

    def program_outputs(self):
        """(the training outputs, the probe)."""
        return self.first, self.probe

    def check(self):
        return self.compare(self.program_outputs(), self.reference())

    def reference(self, tf32: bool = False, fault=None):
        """(the training reference, the reference's probe)."""
        ref = spec.load_module("reference", self.ctx.config["name"])
        probe = ref.attention_probe(self.inp.graph(self.device), *probe_operands(
            self.inp.n_node, self.cfg.gnn_hidden_channels, self.ctx.seed, self.device),
            fault=fault)
        return super().reference(tf32, fault), probe

    def compare(self, prog, ref):
        """``prog`` and ``ref`` alike: (the training outputs, the probe)."""
        limits = self.ctx.traffic["limits"]
        return (check.training(prog[0], ref[0], self.init, limits)
                + [attn_gap(prog[1], ref[1], limits["attn_gap"])])

    def frozen(self, ref):
        """A frozen state's training outputs; the attention op is not
        trained, so its probe is the reference's."""
        return super().frozen(ref[0]), ref[1]


def build(ctx):
    cell = lt.build(ctx)
    cell.__class__ = LinkTrainAttnCell  # link_train's set-up, with this cell's check
    with ctx.stage("check"):
        cell.probe = port_probe(cell.const["g"], *probe_operands(
            cell.inp.n_node, cell.cfg.gnn_hidden_channels, ctx.seed, ctx.device))
    return cell
