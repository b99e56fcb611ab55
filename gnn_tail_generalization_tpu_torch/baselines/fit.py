"""The training loop that the baselines' trainers share.

The JAX package writes one loop per trainer (``baselines/dgi.py:82-94``,
``egi.py:230-244``, ``vgae.py:115-119``, ``pretrain_gin.py:231-234``); they
differ only in what each epoch draws and in whether they stop early, so
here each trainer passes its epoch's loss as a function.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn


def snapshot(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the parameters and batch statistics of ``model``."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def fit(model: nn.Module, loss_of: Callable[[int], torch.Tensor], epochs: int,
        lr: float, name: str, *, patience: Optional[int] = None,
        log_every: int = 0, stats: Optional[dict] = None
        ) -> Dict[str, torch.Tensor]:
    """Adam (optax's defaults) at ``lr`` over ``model``'s parameters, one
    step an epoch on ``loss_of(epoch)``, computed in train mode. Returns the
    state to embed with: with ``patience``, the state after the step whose
    loss (taken before its update, as in the JAX loops) was the lowest so
    far, the run stopping after ``patience`` epochs without a new lowest;
    otherwise the last state. ``stats``, where given, receives each
    epoch's ``loss`` and ``epoch_ms`` (host clock, up to the read of the
    loss, which waits for the step) and ``epochs_run`` and ``best_epoch``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, epoch_ms = [], []
    best_loss, best, best_epoch, bad = math.inf, snapshot(model), -1, 0
    model.train()
    for ep in range(epochs):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_of(ep)
        loss.backward()
        opt.step()
        lv = loss.item()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(lv)
        if patience is not None:
            if lv < best_loss:
                best_loss, best, best_epoch, bad = lv, snapshot(model), ep, 0
            else:
                bad += 1
                if bad >= patience:
                    break
        if log_every and ep % log_every == 0:
            print(f"{name} ep {ep}: loss={lv:.4f}")
    if patience is None:
        best, best_epoch = snapshot(model), len(losses) - 1
    if stats is not None:
        stats.update(loss=losses, epoch_ms=epoch_ms, epochs_run=len(losses),
                     best_epoch=best_epoch)
    return best
