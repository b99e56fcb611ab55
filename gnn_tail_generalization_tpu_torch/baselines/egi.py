"""EGI (Ego-Graph Infomax) pretraining with the SubGI discriminator.

The port of ``gnn_tail_generalization_tpu/baselines/egi.py`` (the
reference's ``Link_prediction_baseline/models/subgi.py``):
- ``EGI`` (SubGI.forward, 385-458): GIN encoder, negatives the row-permuted
  embeddings, JSD loss E_neg/pos_num - E_pos/pos_num over per-hop edge
  scores;
- ``SubGDiscriminator`` (295-383 with GNNDiscLayer, 267-293): walk the
  sampled ego flows from the seeds outward over reversed edges; at each hop
  score every frontier edge with U_s(relu(W [root_src, m_src, x_dst]))
  BEFORE the push, then update the receivers with
  m_dst = relu(fc_x(x_dst) + mean(msg)) and root_dst = mean(root_src),
  msg = fc_x(x_src) at hop 1 and fc_m(m_src) deeper. The push is a masked
  mean into [N, H] tables (``index_add``), so a row no edge reaches keeps
  its value; a batch's ego graphs share the tables, so messages from
  different seeds merge at shared nodes, as in the reference.

``fc_x`` and ``fc_m`` are separate layers (the JAX package's documented
deviation: the reference reuses one, which only type-checks when the
feature width equals the hidden width).

The ego flows are sampled on the host from the forward CSR of the graph:
its ``indices`` in the order of a stable sort of the edge list by
destination, which is the order the JAX sampler sorts into on every call.
Built once, it gives the JAX sampler's flows for the same numpy generator
state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import native
from ..graph.core import Graph
from ..nn.mlp import dense_layer
from ..utils.device import resolve_device
from .encoders import GINEncoder
from .fit import fit
from .mi import negative_expectation, positive_expectation


@dataclasses.dataclass(frozen=True)
class EgoFlows:
    """Padded per-hop reversed-edge lists of a batch of sampled ego graphs.
    Hop t edges run level-t node -> level-(t+1) node (seed side outward)."""

    src: torch.Tensor  # [hops, e_max] int32 global node ids
    dst: torch.Tensor  # [hops, e_max] int32 global node ids
    mask: torch.Tensor  # [hops, e_max] float32 (0 = padding)
    hops: int = 2
    e_max: int = 0

    def to(self, device) -> "EgoFlows":
        return dataclasses.replace(self, src=self.src.to(device),
                                   dst=self.dst.to(device), mask=self.mask.to(device))


def host_csr(edge_index: np.ndarray, n_node: int):
    """(indptr [N + 1] int64, sources [E]) of the edge list grouped by
    destination in a stable sort (``native.sort_edges_csr``), as
    ``sample_ego_flows`` reads them."""
    e = np.asarray(edge_index, np.int64)
    order, indptr = native.sort_edges_csr(e[1], n_node)
    return indptr, e[0][order]


def sample_ego_flows(indptr: np.ndarray, sources: np.ndarray, seeds: np.ndarray,
                     hops: int, fanout: int, rng: np.random.Generator) -> EgoFlows:
    """Host NeighborSampler equivalent: from each seed, sample ``fanout``
    in-neighbours per frontier node per hop, with replacement; a frontier
    node without in-neighbours emits masked (weight-0) edges. ``indptr``
    and ``sources`` are the graph's forward CSR (``host_csr``, or a
    ``Graph``'s ``indptr`` and ``indices``); the draws are the JAX
    sampler's (``egi.py:62-100``)."""
    indptr = np.asarray(indptr, np.int64)
    b = len(seeds)
    e_max = b * fanout ** hops
    src_h = np.zeros((hops, e_max), np.int32)
    dst_h = np.zeros((hops, e_max), np.int32)
    mask_h = np.zeros((hops, e_max), np.float32)

    frontier = np.asarray(seeds, np.int64)
    f_mask = np.ones(len(frontier), np.float32)
    for t in range(hops):
        lo = indptr[frontier]
        cnt = indptr[frontier + 1] - lo
        pick = (rng.random((len(frontier), fanout))
                * np.maximum(cnt, 1)[:, None]).astype(np.int64)
        neigh = sources[np.minimum(lo[:, None] + pick, len(sources) - 1)]
        emask = ((cnt > 0)[:, None] & (f_mask > 0)[:, None]).astype(
            np.float32) * np.ones((1, fanout), np.float32)
        ne = len(frontier) * fanout
        src_h[t, :ne] = np.repeat(frontier, fanout).astype(np.int32)
        dst_h[t, :ne] = neigh.reshape(-1).astype(np.int32)
        mask_h[t, :ne] = emask.reshape(-1)
        frontier = neigh.reshape(-1)
        f_mask = emask.reshape(-1)

    return EgoFlows(src=torch.from_numpy(src_h), dst=torch.from_numpy(dst_h),
                    mask=torch.from_numpy(mask_h), hops=hops, e_max=e_max)


class SubGDiscriminator(nn.Module):
    """GNNDiscLayer + the edge-scoring head (subgi.py:267-383), the hop
    loop over the flow levels. ``in_dim``: the feature width."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fc_x = dense_layer(in_dim, hidden_dim, generator)
        self.fc_m = dense_layer(hidden_dim, hidden_dim, generator)
        self.linear = dense_layer(2 * hidden_dim + in_dim, hidden_dim, generator)
        self.U_s = dense_layer(hidden_dim, 1, generator)

    def forward(self, flows: EgoFlows, root_init: torch.Tensor, x: torch.Tensor):
        """(logits [hops, e_max], masks [hops, e_max])."""
        n = x.shape[0]
        fx = self.fc_x(x)
        m = x.new_zeros(n, self.hidden_dim)
        root = root_init
        logits = []
        for t in range(flows.hops):
            src, dst = flows.src[t].long(), flows.dst[t].long()
            mask = flows.mask[t]
            # the edges are scored BEFORE the push: pre-update m and root
            h_e = torch.cat([root[src], m[src], x[dst]], dim=-1)
            logits.append(self.U_s(F.relu(self.linear(h_e)))[:, 0])
            if t == flows.hops - 1:
                break  # no score reads the last push (XLA drops it as dead code)
            msg = fx[src] if t == 0 else self.fc_m(m)[src]
            w = mask[:, None]
            cnt = mask.new_zeros(n).index_add(0, dst, mask)
            denom = torch.clamp(cnt, min=1.0)[:, None]
            agg_m = m.new_zeros(n, self.hidden_dim).index_add(0, dst, msg * w) / denom
            agg_r = root.new_zeros(root.shape).index_add(0, dst, root[src] * w) / denom
            touched = (cnt > 0)[:, None]
            m = torch.where(touched, F.relu(fx + agg_m), m)
            root = torch.where(touched, agg_r, root)
        return torch.stack(logits), flows.mask


class EGI(nn.Module):
    """SubGI model_id=2: GIN encoder + the ego-flow discriminator. The
    measure must be per-sample: DV's negative term is a batch-level
    logsumexp that the masked per-edge sum cannot take."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 measure: str = "JSD", generator: Optional[torch.Generator] = None):
        super().__init__()
        if measure == "DV":
            raise ValueError("EGI requires a per-sample measure, not DV")
        self.measure = measure
        self.encoder = GINEncoder(in_dim, hidden_dim, num_layers, generator)
        self.disc = SubGDiscriminator(in_dim, hidden_dim, generator)

    def embed(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(g, x)

    def forward(self, g: Graph, x: torch.Tensor, flows: EgoFlows,
                perm: torch.Tensor) -> torch.Tensor:
        z = self.encoder(g, x)
        pos_logits, masks = self.disc(flows, z, x)
        neg_logits, _ = self.disc(flows, z[perm], x)
        pos_num = torch.clamp(masks.sum(), min=1.0)
        e_pos = torch.sum(positive_expectation(pos_logits, self.measure, average=False)
                          * masks)
        e_neg = torch.sum(negative_expectation(neg_logits, self.measure, average=False)
                          * masks)
        return e_neg / pos_num - e_pos / pos_num


def train_egi(g: Graph, x, hidden_dim: int = 64, num_layers: int = 2,
              epochs: int = 100, lr: float = 1e-3, seed: int = 0,
              patience: int = 20, log_every: int = 0,
              edge_index: Optional[np.ndarray] = None,
              batch_seeds: int = 64, fanout: int = 5, *, device="cuda",
              stats: Optional[dict] = None):
    """Train EGI as ``dgi.train_dgi`` (early stopping, the best epoch's
    state); returns (embeddings, state). Each epoch samples a fresh
    ego-flow batch (the reference's train_sampler loop, subgi.py:462) of
    ``min(batch_seeds, N)`` seeds from ``np.random.default_rng(seed)``,
    in the JAX package's order of draws, on ``edge_index`` (default: the
    graph's own edges); the corruption permutations come from a generator
    on ``device`` seeded ``seed``. ``stats`` also receives ``sample_s``,
    the host seconds of each batch's sampling."""
    device = resolve_device(device)
    if edge_index is None:
        indptr, sources = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    else:
        indptr, sources = host_csr(edge_index, g.n_node)
    g = g.to(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    n = x.shape[0]
    nprng = np.random.default_rng(seed)
    b = min(batch_seeds, n)
    sample_s = []

    def sample() -> EgoFlows:
        t0 = time.perf_counter()
        seeds = nprng.choice(n, size=b, replace=False)
        flows = sample_ego_flows(indptr, sources, seeds, num_layers, fanout, nprng)
        sample_s.append(time.perf_counter() - t0)
        return flows.to(device)

    flows0 = sample()
    model = EGI(x.shape[1], hidden_dim, num_layers,
                generator=torch.Generator().manual_seed(seed)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_of(ep):
        flows = sample() if ep else flows0
        return model(g, x, flows, torch.randperm(n, generator=gen, device=device))

    best = fit(model, loss_of, epochs, lr, "egi", patience=patience,
               log_every=log_every, stats=stats)
    if stats is not None:
        stats["sample_s"] = sample_s
    model.load_state_dict(best)
    model.eval()
    with torch.no_grad():
        return model.embed(g, x), best
