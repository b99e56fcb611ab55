"""Multi-seed teacher training (``--N_exp > 1`` under TeacherGNN).

The port of ``gnn_tail_generalization_tpu/train/multiseed.py``. The JAX
package trains the seeds as one vmapped step over stacked parameters, to
amortise TPU dispatch across them. Here the seeds run one after another
through ``train_teacher``: a vmap would need a batching rule for the CUDA
kernels' autograd Function, and each seed's step already fills the card at
the sizes that cost time. So each seed's records are those of
``train_teacher`` from that seed, edgewise columns included where the
config has the edgewise loss.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..data.datasets import PreparedData
from .loops import TrainResult, train_teacher


def train_teacher_multiseed(
    cfg: Config,
    data: PreparedData,
    seeds: Sequence[int],
    epochs: Optional[int] = None,
    log_every: int = 0,
    *,
    device="cpu",
) -> List[TrainResult]:
    """One ``TrainResult`` per seed, in the order of ``seeds``; the JAX
    package's per-epoch ``[multiseed]`` lines are printed after the runs."""
    results = [train_teacher(cfg, data, seed, epochs, device=device)
               for seed in seeds]
    if log_every:
        acc_i = results[0].columns.index("acc_test")
        stacked = np.stack([r.records for r in results])  # [S, epochs, cols]
        for epoch in range(0, stacked.shape[1], log_every):
            print(f"[multiseed] ep {epoch}: acc_test="
                  f"{stacked[:, epoch, acc_i].round(2).tolist()}")
    return results
