"""GIN pretraining variants: degree masking and context prediction.

The port of ``gnn_tail_generalization_tpu/baselines/pretrain_gin.py``:
- ``MaskingGIN`` (the reference's ``models/pretrain_masking_gin.py:197-240``):
  GIN encoder + degree classifier, NLL against the node-degree bucket
  labels, optionally over a masked node subset;
- ``ContextPredGIN`` (``models/pretrain_contextpred_gin.py:173-233``): the
  substructure representation (GIN at the centre) scored against the mean
  of the context graph's OVERLAP nodes; negatives are cycle-shifted
  context rows; loss = BCE(pos) + neg_samples * BCE(neg).

Context graphs are materialized subgraphs, as in the JAX package: for
centre v, the subgraph induced on the nodes at BFS distance in [l1, l2];
the overlap is the part at distance <= K (the substruct encoder's depth).
The centre batch becomes one block-diagonal union ``Graph`` of M slots a
centre, so the context encoder is one batched GIN forward.
``build_context_graphs`` is the JAX host builder with port tensors out.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph.core import Graph, build_graph, edge_rows
from ..nn.mlp import dense_layer
from ..utils.device import resolve_device
from .encoders import GINEncoder
from .fit import fit


def build_context_graphs(edge_index: np.ndarray, n_node: int,
                         centers: np.ndarray, l1: int, l2: int, k_sub: int,
                         max_nodes: int = 64,
                         rng: Optional[np.random.Generator] = None):
    """Host-side context-graph batch builder.

    Returns (union_graph, flat_idx [B*M], node_mask [B*M], overlap_mask
    [B*M]): union_graph is the block-diagonal disjoint union of the B
    per-centre context subgraphs, each padded to M=max_nodes local slots;
    flat_idx maps local slots to global node ids (0 on padding)."""
    rng = rng or np.random.default_rng(0)
    e = np.asarray(edge_index, np.int64)
    order = np.argsort(e[0], kind="stable")
    src_sorted, dst_sorted = e[0][order], e[1][order]
    indptr = np.searchsorted(src_sorted, np.arange(n_node + 1))

    def neighbors(u):
        return dst_sorted[indptr[u]: indptr[u + 1]]

    b, m = len(centers), max_nodes
    flat_idx = np.zeros(b * m, np.int32)
    node_mask = np.zeros(b * m, np.float32)
    overlap_mask = np.zeros(b * m, np.float32)
    union_src, union_dst = [], []

    for bi, c in enumerate(np.asarray(centers)):
        dist = {int(c): 0}
        frontier = [int(c)]
        for d in range(1, l2 + 1):
            nxt = []
            for u in frontier:
                for v in neighbors(u):
                    v = int(v)
                    if v not in dist:
                        dist[v] = d
                        nxt.append(v)
            frontier = nxt
        ctx = [v for v, d in dist.items() if l1 <= d <= l2]
        if len(ctx) > m:
            ctx = list(rng.choice(ctx, size=m, replace=False))
        local = {v: i for i, v in enumerate(ctx)}
        for v in ctx:
            s = bi * m + local[v]
            flat_idx[s] = v
            node_mask[s] = 1.0
            if dist[v] <= k_sub:
                overlap_mask[s] = 1.0
        for v in ctx:
            for w in neighbors(v):
                w = int(w)
                if w in local:
                    union_src.append(bi * m + local[v])
                    union_dst.append(bi * m + local[w])

    if not union_src:  # degenerate graphs: keep shapes valid
        union_src, union_dst = [0], [0]
    ug = build_graph(
        np.stack([np.asarray(union_src, np.int64),
                  np.asarray(union_dst, np.int64)]),
        b * m, with_dense=False,
    )
    return (ug, torch.from_numpy(flat_idx), torch.from_numpy(node_mask),
            torch.from_numpy(overlap_mask))


class MaskingGIN(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 num_degree_classes: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_degree_classes = num_degree_classes
        self.encoder = GINEncoder(in_dim, hidden_dim, num_layers, generator)
        self.degree_classifier = dense_layer(hidden_dim, num_degree_classes, generator)

    def embed(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(g, x)

    def forward(self, g: Graph, x: torch.Tensor, degree_labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        logp = F.log_softmax(self.degree_classifier(self.encoder(g, x)), dim=1)
        picked = logp.gather(1, degree_labels.long()[:, None])[:, 0]
        if mask is not None:
            m = mask.float()
            return -torch.sum(picked * m) / torch.clamp(m.sum(), min=1.0)
        return -picked.mean()


class ContextPredGIN(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, k_sub: int = 2, l1: int = 1,
                 l2: int = 3, neg_samples: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (k_sub > l1 and l2 > l1):
            raise ValueError(f"needs k_sub > l1 and l2 > l1, got {k_sub}, {l1}, {l2}")
        self.k_sub, self.l1, self.l2, self.neg_samples = k_sub, l1, l2, neg_samples
        self.substruct = GINEncoder(in_dim, hidden_dim, k_sub, generator)
        # context encoder depth = l2 - l1 (pretrain_contextpred_gin.py:182)
        self.context = GINEncoder(in_dim, hidden_dim, l2 - l1, generator)

    def embed(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.substruct(g, x)

    def forward(self, g: Graph, x: torch.Tensor, ctx_graph: Graph,
                ctx_idx: torch.Tensor, node_mask: torch.Tensor,
                overlap_mask: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        b = centers.shape[0]
        sub = self.substruct(g, x)[centers.long()]  # [B, H]
        # batched context forward on the block-diagonal union graph
        h = self.context(ctx_graph, x[ctx_idx.long()] * node_mask[:, None])
        om = overlap_mask.reshape(b, -1)
        cnt = torch.clamp(om.sum(dim=1), min=1.0)[:, None]
        ctx_rep = (h * overlap_mask[:, None]).reshape(b, -1, h.shape[-1]).sum(dim=1) / cnt
        valid = (om.sum(dim=1) > 0).float()

        pos = torch.sum(sub * ctx_rep, dim=1)
        nv = torch.clamp(valid.sum(), min=1.0)
        loss = torch.sum(F.softplus(-pos) * valid) / nv  # BCE against 1
        neg_total = 0.0
        for i in range(self.neg_samples):
            ctx_neg = torch.roll(ctx_rep, i + 1, dims=0)  # cycle_index
            vneg = valid * torch.roll(valid, i + 1)
            neg = torch.sum(sub * ctx_neg, dim=1)
            neg_total = neg_total + torch.sum(F.softplus(neg) * vneg) / torch.clamp(
                vneg.sum(), min=1.0)
        # loss_pos + neg_samples * loss_neg (train_model:230)
        return loss + self.neg_samples * neg_total / max(self.neg_samples, 1)


def train_pretrain_gin(g: Graph, x, variant: str = "masking",
                       hidden_dim: int = 64, epochs: int = 50,
                       lr: float = 1e-3, seed: int = 0, log_every: int = 0,
                       degree_labels=None, mask=None,
                       edge_index: Optional[np.ndarray] = None,
                       n_centers: int = 128, max_ctx_nodes: int = 64, *,
                       device="cuda", stats: Optional[dict] = None):
    """Adam for ``epochs`` steps on one fixed batch; returns (embeddings,
    final state). ``masking``: degree labels default to the in-degree
    clipped to the classes. ``contextpred``: ``min(n_centers, N)`` centres
    (all nodes when N <= n_centers) and their context graphs from
    ``np.random.default_rng(seed)`` on ``edge_index`` (default: the graph's
    own edges, in the forward CSR's order, as the JAX package reads them).
    ``stats`` as in ``dgi.train_dgi``, plus ``context_s`` (host seconds of
    the context builder) under ``contextpred``."""
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    gen = torch.Generator().manual_seed(seed)
    if variant == "masking":
        model = MaskingGIN(x.shape[1], hidden_dim, generator=gen)
        if degree_labels is None:
            degree_labels = torch.clamp(g.deg_in.int(), max=model.num_degree_classes - 1)
        args = (torch.as_tensor(degree_labels),
                None if mask is None else torch.as_tensor(mask))
    elif variant == "contextpred":
        model = ContextPredGIN(x.shape[1], hidden_dim, generator=gen)
        if edge_index is None:
            edge_index = np.stack([g.indices.cpu().numpy(),
                                   edge_rows(g.indptr, g.n_edge).cpu().numpy()])
        nprng = np.random.default_rng(seed)
        centers = (np.arange(n) if n <= n_centers
                   else nprng.choice(n, size=n_centers, replace=False))
        t0 = time.perf_counter()
        cg, ctx_idx, nmask, omask = build_context_graphs(
            edge_index, n, centers, model.l1, model.l2, model.k_sub,
            max_nodes=max_ctx_nodes, rng=nprng)
        if stats is not None:
            stats["context_s"] = time.perf_counter() - t0
        args = (cg, ctx_idx, nmask, omask, torch.as_tensor(centers, dtype=torch.int32))
    else:
        raise ValueError(variant)
    model.to(device)
    g, x = g.to(device), x.to(device)
    args = tuple(a if a is None else a.to(device) for a in args)

    state = fit(model, lambda ep: model(g, x, *args), epochs, lr, variant,
                log_every=log_every, stats=stats)
    model.eval()
    with torch.no_grad():
        return model.embed(g, x), state
