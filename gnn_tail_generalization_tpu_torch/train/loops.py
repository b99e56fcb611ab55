"""TeacherGNN training loop.

The port of ``train_teacher`` and its helpers in
``gnn_tail_generalization_tpu/train/loops.py`` (the reference's
``trainer_node_classification.py``: train_teacherGNN 303-372 and
run_trainSet/run_testSet 382-495): full-graph epochs, masked NLL +
se_reg * sum ||E^l||_F, Adam, and an eval-mode full forward with the
head/tail/iso breakdown after every step.

Each epoch is one eager step. The JAX package's epoch-block scans and
vmapped multi-seed training exist to amortise TPU dispatch and are not
carried over; main.py loops over seeds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..data.datasets import PreparedData
from ..graph.core import Graph, loss_masked_view
from ..models.teacher import TeacherGNN
from ..nn.norms import norm_applies
from .evalutil import headtail_accuracies, masked_accuracy
from .optim import make_optimizer


@dataclass
class TrainResult:
    columns: List[str]
    records: np.ndarray  # [epochs, len(columns)]
    state_dict: Dict[str, torch.Tensor]  # final parameters
    step_ms: List[float]  # per epoch: forward, backward and Adam, synchronised


def _nll_masked(logits: torch.Tensor, y: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    picked = torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
    # where (not *0) so masked-out rows can hold non-finite values
    picked = torch.where(mask, picked, torch.zeros_like(picked))
    return -picked.sum() / mask.float().sum().clamp(min=1.0)


def final_agg_view(cfg: Config, data: PreparedData) -> Optional[Graph]:
    """The loss-masked final-layer graph (Config.optimize_final_layer_agg)
    or None. The single gate for the optimization: valid only when the
    train-mode last-conv output reaches the loss exclusively through the
    row-masked NLL — no edgewise loss, no cross-row norm trick, no graph
    dropout, and a real nodewise loss."""
    if not (cfg.optimize_final_layer_agg
            and cfg.has_loss_component_nodewise
            and not cfg.has_loss_component_edgewise
            and not cfg.apply_graph_dropout):
        return None
    if norm_applies(cfg.type_trick):
        return None
    m = np.zeros(data.graph.n_node, bool)
    m[np.asarray(data.train_idx)] = True
    return loss_masked_view(data.graph, data.edge_index, m)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_teacher(
    cfg: Config,
    data: PreparedData,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    *,
    device="cpu",
    init_state: Optional[Mapping[str, Any]] = None,
) -> TrainResult:
    """Train the teacher for ``epochs`` steps on ``device``. ``seed`` seeds
    the parameter init and the dropout generator (main.py passes
    ``cfg.random_seed + run``). ``init_state``: starting parameters (a
    state_dict, e.g. from utils/convert.params_from_jax) instead of the
    random init. ``step_ms`` of the result holds each epoch's train-step
    time on the host clock."""
    if cfg.has_loss_component_edgewise:
        raise NotImplementedError(
            "exp_mode=I2_GTL: the edgewise loss is not ported yet (ROADMAP A8)")
    epochs = cfg.epochs if epochs is None else epochs
    device = torch.device(device)

    model = TeacherGNN(cfg, generator=torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    model.to(device)
    drop_gen = torch.Generator(device=device).manual_seed(seed)
    opt = make_optimizer(cfg, model.parameters())

    g = data.graph.to(device)
    g_last = final_agg_view(cfg, data)
    if g_last is not None:
        g_last = g_last.to(device)
    x = torch.as_tensor(data.x).to(device)
    y = torch.as_tensor(data.y).to(device)
    train_mask = torch.as_tensor(data.train_mask).to(device)
    test_mask = torch.as_tensor(data.test_mask).to(device)
    s = data.splits
    want_ht = cfg.want_headtail and s is not None
    if want_ht:
        large = torch.as_tensor(s.large_deg_mask).to(device)
        small = torch.as_tensor(s.small_deg_mask).to(device)
        zero = (None if s.zero_deg_mask is None
                else torch.as_tensor(s.zero_deg_mask).to(device))

    cols = ["loss_train", "acc_train", "acc_test"]
    if want_ht:
        cols += ["head", "tail"] + (["iso"] if zero is not None else [])
    records = np.zeros((epochs, len(cols)), np.float64)
    step_ms: List[float] = []

    for epoch in range(epochs):
        _sync(device)
        t0 = time.perf_counter()
        model.train()
        opt.zero_grad(set_to_none=True)
        _, classi, se_reg_all, _ = model(g, x, generator=drop_gen, g_last=g_last)
        loss = torch.zeros((), device=device)
        if cfg.has_loss_component_nodewise:
            loss = _nll_masked(classi, y, train_mask) * cfg.TeacherGNN.lossa_semantic
        if se_reg_all is not None:
            loss = loss + cfg.se_reg * se_reg_all
        loss.backward()
        opt.step()
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)

        # eval-mode full forward (run_testSet)
        model.eval()
        with torch.no_grad():
            _, classi, _, _ = model(g, x)
            metrics = {
                "loss_train": loss.detach(),
                "acc_train": masked_accuracy(classi, y, train_mask) * 100.0,
                "acc_test": masked_accuracy(classi, y, test_mask) * 100.0,
            }
            if want_ht:
                metrics.update(headtail_accuracies(classi, y, train_mask,
                                                   large, small, zero))
            # one device->host copy per epoch
            records[epoch] = torch.stack(
                [metrics[c].float() for c in cols]).cpu().numpy()
        if log_every and epoch % log_every == 0:
            print(f"Ep{epoch:03d} " + " ".join(
                f"{c}={records[epoch, i]:.2f}" for i, c in enumerate(cols)))

    return TrainResult(
        columns=cols,
        records=records,
        state_dict={k: v.detach() for k, v in model.state_dict().items()},
        step_ms=step_ms,
    )
