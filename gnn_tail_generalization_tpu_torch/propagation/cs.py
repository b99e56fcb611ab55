"""Correct & Smooth pipeline: PreStep -> MidStep -> LPStep.

The port of ``gnn_tail_generalization_tpu/propagation/cs.py`` (the
reference's ``Label_propagation_model/LP_Adj.py:18-224``):
- PreStep (162-178): concat of diffusion/spectral/community features, on
  the host (propagation/diffusion.py), optionally cached as npy files;
- MidStep (180-224): BatchNorm-MLP (or linear) on [x, embs], log_softmax,
  trained full-batch with Adam; keeps the best-by-valid exp(out);
- LPStep (109-160): Correct & Smooth via double_correlation_{fixed,autoscale}
  or only_outcome_correlation on the configured DAD/DA/AD graphs, on the
  model's device (the reference forces it onto the CPU, LP_Adj.py:149-152).

no_prep=True (the LP-only default, base_options.py:397-402) routes to plain
label_propagation from the train labels.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..data.datasets import PreparedData
from ..nn.dropout import dropout as apply_dropout
from ..nn.mlp import dense_layer
from ..nn.norms import BatchNorm
from ..train.evalutil import masked_accuracy
from ..utils.device import resolve_device
from . import correlation as corr
from . import diffusion as diff


class CSMLp(nn.Module):
    """MidStep 'mlp' model (diffusion_feature.py:20-51): Linear ->
    [relu -> BN -> dropout] x (L-1) -> Linear -> log_softmax. Batch norm is
    flax's (momentum 0.9, eps 1e-5); dropout is the module's own 0.5, not the
    config's."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int,
                 dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out]
        self.lins = nn.ModuleList(dense_layer(a, b, generator)
                                  for a, b in zip(dims[:-1], dims[1:]))
        self.bns = nn.ModuleList(BatchNorm(hidden, decay=0.9)
                                 for _ in range(num_layers - 1))

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for lin, bn in zip(self.lins[:-1], self.bns):
            x = bn(torch.relu(lin(x)))
            x = apply_dropout(x, self.dropout, train=self.training,
                              generator=generator)
        return torch.log_softmax(self.lins[-1](x), dim=-1)


class CSLinear(nn.Module):
    def __init__(self, in_dim: int, out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = dense_layer(in_dim, out, generator)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.log_softmax(self.lin(x), dim=-1)


def pre_step(cfg: Config, data: PreparedData,
             cache_dir: Optional[str] = None) -> np.ndarray:
    """PreStep.forward (LP_Adj.py:168-178). ``cache_dir``: the reference's
    per-method embedding cache (diffusion_feature.py:132-140) as npy files
    keyed by method, dataset, propagation count and graph shape."""
    embs = []
    for m in cfg.preStep.pre_methods.split("+"):
        path = None
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            key = (f"{m}_{cfg.dataset}_{cfg.preStep.num_propagations}"
                   f"_{data.n_node}_{data.edge_index.shape[1]}")
            path = os.path.join(cache_dir, f"{key}.npy")
            if os.path.exists(path):
                embs.append(np.load(path))
                continue
        emb = diff.preprocess(
            m, data.x, data.edge_index, data.n_node, labels=data.y,
            train_idx=data.train_idx,
            num_propagations=cfg.preStep.num_propagations)
        if path is not None:
            np.save(path, emb)
        embs.append(emb)
    return np.concatenate(embs, axis=-1)


def lp_step(cfg: Config, data: PreparedData, model_out: torch.Tensor,
            label_idx: torch.Tensor, residual_idx: torch.Tensor, *,
            spmm_method: str = "auto") -> torch.Tensor:
    """LPStep.forward (LP_Adj.py:146-160) on ``model_out``'s device. Only
    the adjacencies the configured function needs are built."""
    lp = cfg.lpStep
    nc = cfg.num_classes
    dev = model_out.device
    need = ({lp.A} if (lp.no_prep or lp.fn == "only_outcome_correlation")
            else {lp.A1, lp.A2})
    adjs = corr.gen_normalized_adjs(data.edge_index, data.n_node, which=need)
    by_name = {k: v.to(dev) for k, v in zip(("DAD", "DA", "AD"), adjs)
               if v is not None}
    y = torch.as_tensor(data.y, device=dev)
    if lp.no_prep:
        return corr.label_propagation(
            y, torch.as_tensor(data.train_idx, device=dev), by_name[lp.A],
            lp.alpha, lp.num_propagations, nc, spmm_method)
    if lp.fn == "double_correlation_autoscale":
        _, out = corr.double_correlation_autoscale(
            y, model_out, label_idx, residual_idx,
            by_name[lp.A1], lp.alpha1, lp.num_propagations1,
            by_name[lp.A2], lp.alpha2, lp.num_propagations2, nc,
            spmm_method=spmm_method)
    elif lp.fn == "double_correlation_fixed":
        _, out = corr.double_correlation_fixed(
            y, model_out, label_idx, residual_idx,
            by_name[lp.A1], lp.alpha1, lp.num_propagations1,
            by_name[lp.A2], lp.alpha2, lp.num_propagations2, nc, 1.0,
            spmm_method=spmm_method)
    else:
        _, out = corr.only_outcome_correlation(
            y, model_out, label_idx, by_name[lp.A], lp.alpha,
            lp.num_propagations, nc, spmm_method=spmm_method)
    return out


def run_cs_pipeline(cfg: Config, data: PreparedData, seed: int = 0,
                    epochs: int = 100, *, device="cuda") -> Dict:
    """LabelPropagation_Adj.train_net (LP_Adj.py:37-66) run to completion:
    preprocess once on the host, train the mid MLP full-batch (Adam at
    ``cfg.lr``), C&S the best-by-valid output with the train nodes as the
    labels. Returns acc_train / acc_test (x100), the mid step's best
    valid accuracy, and the C&S output ``out``."""
    device = resolve_device(device)
    cfg = dataclasses.replace(
        cfg, lpStep=dataclasses.replace(cfg.lpStep, no_prep=False))
    embs = pre_step(cfg, data)
    x = torch.as_tensor(np.concatenate([data.x, embs], axis=-1), device=device)
    y = torch.as_tensor(data.y, device=device)
    train_mask = torch.as_tensor(data.train_mask, device=device)
    val_mask = torch.as_tensor(
        data.val_mask if data.val_mask is not None else ~data.train_mask,
        device=device)
    test_mask = torch.as_tensor(data.test_mask, device=device)

    init_gen = torch.Generator().manual_seed(seed)
    if cfg.midStep.model == "mlp":
        model = CSMLp(x.shape[1], cfg.midStep.hidden_channels, cfg.num_classes,
                      cfg.midStep.num_layers, generator=init_gen)
    else:
        model = CSLinear(x.shape[1], cfg.num_classes, generator=init_gen)
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)

    best_valid, best_out = -1.0, None
    for _ in range(epochs):
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(x, generator=gen)
        picked = out.gather(1, y[:, None])[:, 0]
        m = train_mask.float()
        loss = -(picked * m).sum() / m.sum().clamp(min=1.0)
        loss.backward()
        opt.step()
        model.eval()
        with torch.no_grad():
            out = model(x)
            v = masked_accuracy(out, y, val_mask).item()
            if v > best_valid:
                best_valid, best_out = v, torch.exp(out)

    label_idx = torch.as_tensor(data.train_idx, device=device)  # train_only
    out = lp_step(cfg, data, best_out, label_idx, label_idx)
    return {
        "acc_train": masked_accuracy(out, y, train_mask).item() * 100,
        "acc_test": masked_accuracy(out, y, test_mask).item() * 100,
        "acc_valid_mid": best_valid * 100,
        "out": out,
    }
