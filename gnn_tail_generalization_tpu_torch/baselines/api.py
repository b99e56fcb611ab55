"""Baseline-embedding generation API.

The port of ``gnn_tail_generalization_tpu/baselines/api.py`` (the
reference's ``Link_prediction_baseline/run_airport.py:382-548``,
gen_baseline_embs): build the graph from edge_index, degree-bucket one-hot
features, train DGI/EGI/VGAE, return frozen embeddings for the link
prediction model's input layer (``trainer_link_prediction.py:391-393``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..graph.core import build_graph, standard_pipeline
from ..utils.device import resolve_device


def degree_bucketing(edge_index: np.ndarray, n_node: int,
                     max_degree: int = 32) -> np.ndarray:
    """One-hot of min(degree, max_degree-1) (run_airport.py degree_bucketing)."""
    deg = np.bincount(np.asarray(edge_index)[1], minlength=n_node)
    deg = np.minimum(deg, max_degree - 1)
    x = np.zeros((n_node, max_degree), np.float32)
    x[np.arange(n_node), deg] = 1.0
    return x


def gen_baseline_embs(edge_index: np.ndarray, n_node: int, alg: str,
                      x: Optional[np.ndarray] = None, hidden_dim: int = 64,
                      epochs: int = 50, seed: int = 0, log_every: int = 0, *,
                      device="cuda", stats: Optional[dict] = None) -> np.ndarray:
    """Train the chosen self-supervised model (DGI, EGI or VGAE) on
    ``device``; return its frozen [N, D] embeddings (D = ``hidden_dim``, or
    VGAE's latent 32) as numpy. The graph is the loader pipeline's, dense
    up to 4,096 nodes and with plans (``has_plans``) above. ``stats``, where
    given, receives the host seconds of the pipeline (``pipeline_s``) and of
    the graph build (``build_s``) and the trainer's (``dgi.train_dgi``)."""
    if alg not in ("DGI", "EGI", "VGAE"):
        raise ValueError(alg)
    device = resolve_device(device)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    e = standard_pipeline(edge_index, n_node)
    t1 = time.perf_counter()
    g = build_graph(e, n_node, with_dense=n_node <= 4096,
                    with_plans=n_node > 4096)
    stats.update(pipeline_s=t1 - t0, build_s=time.perf_counter() - t1)
    if x is None:
        # reference run_airport.py:46-48 overrides max_degree with n_hidden
        # so the degree one-hot has the model's hidden width
        x = degree_bucketing(e, n_node, max_degree=hidden_dim)
    x = np.asarray(x, np.float32)
    kw = dict(epochs=epochs, seed=seed, log_every=log_every, device=device,
              stats=stats)

    if alg == "DGI":
        from .dgi import train_dgi

        embs, _ = train_dgi(g, x, hidden_dim, **kw)
    elif alg == "EGI":
        from .egi import train_egi

        # the graph's forward CSR is the stable sort of ``e`` by
        # destination, so the sampler reads it instead of sorting ``e``
        embs, _ = train_egi(g, x, hidden_dim, **kw)
    else:
        from .vgae import train_vgae

        embs, _ = train_vgae(g, x, hidden_dim, **kw)
    return embs.cpu().numpy()
