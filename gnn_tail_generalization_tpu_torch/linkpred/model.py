"""Link-prediction model and trainer: input layer + encoder + predictor.

The port of ``gnn_tail_generalization_tpu/linkpred/model.py`` (the
reference's ``Link_prediction_model/model.py``):
- input layer (268-288): raw feats / trainable node embedding / both;
- encoder and predictor factories (290-319);
- train (121-169): full-graph encode per edge minibatch, pos/neg scores,
  configurable loss, global-norm gradient clipping, Adam/AdamW;
- batch_predict/test (171-266): chunked split scoring, hits/mrr/recall.

Every random draw takes an explicit ``torch.Generator``: the parameter init
one seeded per run, the train one (dropout, permutations, negatives) on the
run's device. The optimizer is optax's
``chain(clip_by_global_norm(grad_clip_norm), adam | adamw)``: the gradients
are scaled by ``max_norm / norm`` only where ``norm >= max_norm`` (torch's
``clip_grad_norm_`` divides by ``norm + 1e-6``), and AdamW's weight decay is
optax's default 1e-4 (torch's is 1e-2).

Each epoch runs with the JAX package's protocol (``make_epoch_fn``,
its ``device_epoch=True``): the epoch's permutation and all its negatives are drawn
on the device in one batch, the final partial batch is wrap-filled with the
wrapped entries masked by ``valid``, and the losses stay on the device
until one host read per epoch. The JAX package scans the steps in one
program; here they are eager steps.

Sharded (``train_linkpred(comm=...)``, JAX ``mesh=``): the message graph is
a ``DistGraph`` and the features and the encoded table are row-sharded over
the ranks; the predictor's endpoint rows come through ``dist_take_rows``
(``take_rows``), the same on every rank, in training and in the eval
chunks. The parameters are replicated. Every rank computes the whole loss,
and since the backward of ``dist_take_rows`` sums over the ranks, the loss
enters each rank's backward divided by S, and the replicated gradients are
summed over the ranks (``sum_replicated_grads``) before the clip, so that
the clip sees the global gradient. The permutation, the negatives and the
predictor's dropout come from streams seeded alike on every rank; the
encoder's dropout over the rank's rows from a stream of the rank's own.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..graph.core import (Graph, add_self_loops, build_graph, edge_rows,
                          gcn_norm_weights, remove_self_loops, symmetrize)
from ..parallel.comm import Comm
from ..parallel.distgraph import (DistGraph, ShardedGraph, build_dist_graph, comm_of,
                                  dist_take_rows, sum_replicated_grads)
from ..utils import debug
from ..utils.device import resolve_device
from . import losses as L
from . import metrics as M
from . import sampling
from .encoders import GNNEncoder, hoistable, hoisted_first_agg
from .predictors import create_predictor, takes_pairs


@dataclass(frozen=True)
class LinkPredConfig:
    """Mirrors the BaseModel ctor args (model.py:43-88) + trainer flags."""

    encoder: str = "SAGE"
    predictor: str = "DOT"
    loss_func: str = "ce_loss"
    optimizer: str = "Adam"
    neg_sampler: str = "global"
    lr: float = 0.001
    dropout: float = 0.2
    grad_clip_norm: float = 2.0
    gnn_num_layers: int = 2
    mlp_num_layers: int = 2
    emb_hidden_channels: int = 256
    gnn_hidden_channels: int = 256
    mlp_hidden_channels: int = 256
    num_neg: int = 3
    batch_size: int = 64 * 1024
    use_node_feats: bool = False
    train_node_emb: bool = True
    eval_metric: str = "recall_my@1.25"
    edge_lp_mode: str = ""  # '' | 'logit' | 'emb' | 'xmc' (model.py:208-239)
    #: 'pallas_bf16' aggregates with bf16 operands / f32 accumulation (the
    #: bf16 CSR kernel) and runs the conv Dense layers in bf16; the default
    #: matches the reference's f32
    spmm_method: str = "auto"
    elp_alpha: float = 0.995
    elp_num_propagations: int = 5


class LinkPredModel(nn.Module):
    """``node_emb`` (xavier-uniform [n_node, emb_hidden_channels]) exists
    when the embedding is trained or no features are used; the encoder's
    input is the features, the embedding, or both concatenated
    (embedding first)."""

    def __init__(self, cfg: LinkPredConfig, n_node: int, num_node_feats: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        if c.train_node_emb or not c.use_node_feats:
            self.node_emb = nn.Parameter(torch.empty(n_node, c.emb_hidden_channels))
            nn.init.xavier_uniform_(self.node_emb, generator=generator)
        else:
            self.register_parameter("node_emb", None)
        in_channels = ((num_node_feats if c.use_node_feats else 0)
                       + (0 if self.node_emb is None else c.emb_hidden_channels))
        self.encoder = GNNEncoder(
            c.encoder, in_channels, c.gnn_hidden_channels,
            c.gnn_hidden_channels, c.gnn_num_layers, c.dropout,
            c.spmm_method, generator)
        self.predictor = create_predictor(
            c.predictor, c.gnn_hidden_channels, c.mlp_hidden_channels,
            c.mlp_num_layers, c.dropout, generator)

    def input_feat(self, x: torch.Tensor) -> torch.Tensor:
        """create_input_feat (model.py:96-106)."""
        if self.cfg.use_node_feats:
            if self.node_emb is not None:
                return torch.cat([self.node_emb, x], dim=-1)
            return x
        return self.node_emb

    def encode(self, g: Graph, x: torch.Tensor, *,
               agg0: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(g, self.input_feat(x), agg0=agg0,
                            generator=generator)

    def predict_pairs(self, hs: torch.Tensor, hd: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Scores of the pairs whose endpoint rows are ``hs`` and ``hd``."""
        return self.predictor(hs, hd, generator=generator)


def compute_loss(cfg: LinkPredConfig, pos_out, neg_out, margin=None,
                 valid=None):
    """calculate_loss (model.py:108-119). ``valid`` masks wrap-filled
    entries of the final partial batch (losses.py docstring)."""
    name = cfg.loss_func
    if name == "ce_loss":
        return L.ce_loss(pos_out, neg_out, valid=valid, num_neg=cfg.num_neg)
    if name == "info_nce_loss":
        return L.info_nce_loss(pos_out, neg_out, cfg.num_neg, valid=valid)
    if name == "log_rank_loss":
        return L.log_rank_loss(pos_out, neg_out, cfg.num_neg, valid=valid)
    if name == "adaptive_auc_loss" and margin is not None:
        return L.adaptive_auc_loss(pos_out, neg_out, cfg.num_neg, margin,
                                   valid=valid)
    return L.auc_loss(pos_out, neg_out, cfg.num_neg, valid=valid)


# ---------------------------------------------------------------------------
# Edge splits
# ---------------------------------------------------------------------------


def simple_split_edges(edge_index: np.ndarray, n_node: int,
                       val_frac: float = 0.05, test_frac: float = 0.1,
                       num_neg_eval: int = 100, seed: int = 0):
    """Random train/valid/test positive-edge split with sampled eval
    negatives (the random-split path of init_split_edge_unified_impl,
    utils.py:62-145; the transfer-setting masks are handled by the graph
    surgery utilities before this)."""
    rng = np.random.default_rng(seed)
    e = np.asarray(edge_index)
    # undirected: keep each pair once
    und = e[:, e[0] < e[1]]
    m = und.shape[1]
    perm = rng.permutation(m)
    n_val = int(m * val_frac)
    n_test = int(m * test_frac)
    val = und[:, perm[:n_val]]
    test = und[:, perm[n_val:n_val + n_test]]
    train = und[:, perm[n_val + n_test:]]

    keys = sampling.edge_keys(e, n_node)

    def sample_negs(count):
        return sampling.rejection_sample_non_edges(rng, keys, n_node, count)

    split_edge = {
        "train": {"edge": train.T},
        "valid": {"edge": val.T,
                  "edge_neg": sample_negs(max(n_val, 1) * num_neg_eval)},
        "test": {"edge": test.T,
                 "edge_neg": sample_negs(max(n_test, 1) * num_neg_eval)},
    }
    # message-passing graph = train positives symmetrized
    msg_edges = symmetrize(np.concatenate([train, train[::-1]], axis=1),
                           n_node)
    return split_edge, msg_edges


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class Logger:
    """Per-run (valid, test) series; best-by-valid statistics
    (Link_prediction_model/logger.py:5-46)."""

    def __init__(self, runs: int):
        self.results = [[] for _ in range(runs)]

    def add_result(self, run: int, result):
        self.results[run].append(tuple(result))

    def best(self, run: int):
        arr = np.asarray(self.results[run])
        if len(arr) == 0:
            return (np.nan, np.nan)
        i = int(np.argmax(arr[:, 0]))
        return tuple(arr[i])

    def statistics(self):
        bests = np.asarray([self.best(r) for r in range(len(self.results))])
        return {
            "valid_mean": float(np.nanmean(bests[:, 0])),
            "valid_std": float(np.nanstd(bests[:, 0])),
            "test_mean": float(np.nanmean(bests[:, 1])),
            "test_std": float(np.nanstd(bests[:, 1])),
        }


def make_optimizer(cfg: LinkPredConfig, params: Iterable[nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """optax ``adam(lr)`` / ``adamw(lr)`` (weight decay 1e-4, decoupled)."""
    if cfg.optimizer == "AdamW":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm(params: Iterable[nn.Parameter], max_norm: float
                        ) -> None:
    """optax ``clip_by_global_norm``: every gradient times
    ``max_norm / norm`` where the global norm is at least ``max_norm``,
    untouched below it. Computed on the device, with no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def take_rows(g, h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the encoded table ``h``: ``h[idx]`` on one device;
    on a sharded graph (``h`` the rank's rows) ``dist_take_rows``."""
    if isinstance(g, ShardedGraph):
        return dist_take_rows(g, h, idx)
    return h[idx]


def make_loss_fn(cfg: LinkPredConfig, model: LinkPredModel):
    """The train loss of a batch. ``const["encoder_generator"]``, where
    given, draws the encoder's dropout (a rank's own stream); else
    ``generator`` draws it."""
    def loss_fn(const, pos_edge, neg_edge, generator, valid):
        g = const["g"]
        h = model.encode(g, const["x"], agg0=const.get("agg0"),
                         generator=const.get("encoder_generator") or generator)
        pos_out = model.predict_pairs(take_rows(g, h, pos_edge[:, 0]),
                                      take_rows(g, h, pos_edge[:, 1]),
                                      generator=generator)
        neg = neg_edge.reshape(-1, 2)
        neg_out = model.predict_pairs(take_rows(g, h, neg[:, 0]),
                                      take_rows(g, h, neg[:, 1]),
                                      generator=generator)
        return compute_loss(cfg, pos_out, neg_out, valid=valid)

    return loss_fn


def make_train_step(cfg: LinkPredConfig, model: LinkPredModel,
                    optimizer: torch.optim.Optimizer):
    """One train-mode step: loss, backward, clipping, the optimizer update.
    Returns the loss as a device scalar (no host sync). On a ``DistGraph``
    the gradient rule of the module docstring."""
    loss_fn = make_loss_fn(cfg, model)
    params = list(model.parameters())

    def step(const, pos_edge, neg_edge, generator, valid):
        with debug.span("gnn.link.step"):
            optimizer.zero_grad(set_to_none=True)
            with debug.span("gnn.link.step.forward"):
                loss = loss_fn(const, pos_edge, neg_edge, generator, valid)
            with debug.span("gnn.link.step.backward"):
                comm = comm_of(const["g"])
                if comm is None:
                    loss.backward()
                else:
                    (loss / comm.world_size).backward()
                    sum_replicated_grads(model, comm)
            with debug.span("gnn.link.step.optimizer"):
                if cfg.grad_clip_norm >= 0:
                    clip_by_global_norm(params, cfg.grad_clip_norm)
                optimizer.step()
        return loss.detach()

    return step


def make_epoch_fn(cfg: LinkPredConfig, model: LinkPredModel,
                  optimizer: torch.optim.Optimizer, n_node: int,
                  n_steps: int, bsz: int, n_draw: int):
    """One epoch with no host sync inside: a device permutation of the
    positive table, the whole epoch's negatives in one batched draw (one
    membership test for all of them), and ``n_steps`` train steps; returns
    the [n_steps] losses on the device. Every positive among the first
    ``n_draw`` of the permutation is visited once; the final partial batch
    is wrap-filled and its wrapped entries masked."""
    step = make_train_step(cfg, model, optimizer)

    def epoch(const, pos_all, keys, generator):
        dev = pos_all.device
        total = n_steps * bsz
        with debug.span("gnn.link.sample"):
            perm = torch.randperm(pos_all.shape[0], generator=generator, device=dev)
            if cfg.neg_sampler == "global":
                neg_all = sampling.global_neg_sample(generator, keys, n_node,
                                                     total, cfg.num_neg)
            elif cfg.neg_sampler == "local":
                pos_seq = pos_all[perm[torch.arange(total, device=dev) % n_draw]]
                neg_all = sampling.local_neg_sample(generator, pos_seq, n_node,
                                                    cfg.num_neg)
            else:  # global_perm: permuted copies within each step's batch
                neg_all = sampling.global_perm_neg_sample(
                    generator, keys, n_node, total, cfg.num_neg, perm_within=bsz)
            neg_all = neg_all.reshape(n_steps, bsz, cfg.num_neg, 2)
        losses = []
        for s in range(n_steps):
            idx = s * bsz + torch.arange(bsz, device=dev)
            pos = pos_all[perm[idx % n_draw]]
            valid = (idx < n_draw).float()
            losses.append(step(const, pos, neg_all[s], generator, valid))
        return torch.stack(losses)

    return epoch


def _message_edges(cfg: LinkPredConfig, msg_edges: np.ndarray, n_node: int):
    """(edges, weights or None) of the message graph: GCN with self loops
    and D^-1/2 A D^-1/2 weights."""
    if cfg.encoder.upper() != "GCN":
        return msg_edges, None
    e_msg = add_self_loops(remove_self_loops(msg_edges), n_node)
    return e_msg, gcn_norm_weights(e_msg, n_node)


def link_graph(cfg: LinkPredConfig, msg_edges: np.ndarray, n_node: int
               ) -> Graph:
    """The message-passing graph as the JAX package builds it: a dense
    adjacency up to 4096 nodes, Pallas plans (here: ``has_plans``, so
    ``pallas_bf16`` runs the bf16 kernel) above."""
    e_msg, w_msg = _message_edges(cfg, msg_edges, n_node)
    return build_graph(e_msg, n_node, edge_weight=w_msg,
                       with_dense=n_node <= 4096, with_plans=n_node > 4096)


def link_dist_graph(cfg: LinkPredConfig, msg_edges: np.ndarray, n_node: int,
                    comm: Comm, rb: int = 128) -> DistGraph:
    """Rank ``comm.shard``'s ``DistGraph`` of the message graph (on the
    CPU)."""
    e_msg, w_msg = _message_edges(cfg, msg_edges, n_node)
    return build_dist_graph(e_msg, n_node, comm, w_msg, rb=rb)


def check_shardable(cfg: LinkPredConfig) -> None:
    """Raises ``ValueError`` for a config the sharded trainer does not run
    (the JAX package asserts the same, ``model.py:416-424``)."""
    if not cfg.use_node_feats or cfg.train_node_emb:
        raise ValueError("sharded link prediction runs on raw features "
                         "(use_node_feats=True, train_node_emb=False): a trainable "
                         "node embedding would need its own row sharding")
    if cfg.encoder.upper() in ("TRANSFORMER", "MLP"):
        raise ValueError(f"sharded link prediction takes a conv encoder, not "
                         f"{cfg.encoder}")
    if cfg.edge_lp_mode:
        raise ValueError("sharded link prediction has no edge-LP mode: the "
                         "edge-LP modes walk the edge arrays")


def shard_rows(x, g: DistGraph, device) -> torch.Tensor:
    """The rank's ``[rows_per_shard, F]`` rows of ``x`` [n_node, F] padded
    with zero rows to ``n_node_pad``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    out = torch.zeros(g.rows_per_shard, x.shape[1], device=device)
    hi = min(g.row0 + g.rows_per_shard, g.n_node)
    if hi > g.row0:
        out[:hi - g.row0] = x[g.row0:hi].to(device)
    return out


def link_const(cfg: LinkPredConfig, g: Graph, x: torch.Tensor
               ) -> Dict[str, Any]:
    """The step's constants: the graph, the input features and, where the
    encoder input is constant under training (raw features, no trainable
    embedding), the hoisted layer-1 aggregation ``agg0`` (bf16 under
    ``pallas_bf16``, where it only feeds bf16 Dense layers)."""
    agg0 = None
    if (cfg.use_node_feats and not cfg.train_node_emb
            and hoistable(cfg.encoder)):
        with torch.no_grad():
            agg0 = hoisted_first_agg(cfg.encoder, g, x, cfg.spmm_method).to(
                torch.bfloat16 if cfg.spmm_method == "pallas_bf16"
                else torch.float32)
    return {"g": g, "x": x, "agg0": agg0}


def _heuristic_run(cfg, split_edge, msg_edges, n_node):
    """CN/AA/PPR (model.py:122-124,176-178): no training; every split
    scored by the heuristic on the message graph."""
    from . import heuristics as H

    def hscore(edges):
        return torch.from_numpy(H.heuristic_scores(
            cfg.encoder, msg_edges, n_node,
            np.asarray(edges).T).astype(np.float32))

    pos_train = hscore(split_edge["train"]["edge"])
    pos_val = hscore(split_edge["valid"]["edge"])
    neg_val = hscore(split_edge["valid"]["edge_neg"])
    pos_test = hscore(split_edge["test"]["edge"])
    neg_test = hscore(split_edge["test"]["edge_neg"])
    m = cfg.eval_metric
    if m == "hits":
        results = M.evaluate_hits(pos_val, neg_val, pos_test, neg_test)
    elif m == "mrr":
        results = M.evaluate_mrr(pos_val, neg_val, pos_test, neg_test)
    else:
        topk = float(m.split("@")[1]) if "@" in m else None
        results = M.evaluate_recall_my(pos_train, neg_val, pos_val,
                                       neg_val, pos_test, neg_test,
                                       topk=topk)
    logger = Logger(1)
    vals = list(results.values())[0]
    logger.add_result(0, vals[-2:])
    return {"logger": logger, "stats": logger.statistics(),
            "last_results": results, "params": None,
            "split_edge": split_edge, "epoch_s": [], "epoch_loss": []}


def train_linkpred(
    cfg: LinkPredConfig,
    x,
    edge_index: np.ndarray,
    n_node: int,
    epochs: int = 5,
    runs: int = 1,
    eval_steps: int = 1,
    seed: int = 0,
    log_every: int = 0,
    split_edge: Optional[Dict] = None,
    msg_edges: Optional[np.ndarray] = None,
    max_steps_per_epoch: Optional[int] = None,
    comm: Optional[Comm] = None,
    dist_rb: int = 128,
    *,
    device="cuda",
) -> Dict[str, Any]:
    """The run x epoch loop of trainer_link_prediction.py:215-431. With
    ``split_edge`` given (e.g. from linkpred/surgery.py transfer settings)
    the provided split is used; otherwise a random split is made.
    ``x``: [n_node, F] features (numpy or a tensor, e.g. drawn on the
    card) or None. ``max_steps_per_epoch`` caps minibatches per epoch,
    each run as in the module docstring. Run r initialises
    from a generator seeded ``seed + 1000 r`` and trains from one seeded
    ``seed + 1000 r + 1``, both on ``device``. The result also holds
    ``epoch_s``, each epoch's seconds up to its host read of the losses,
    ``epoch_loss``, each epoch's mean train loss, and ``graph_build_s``,
    the host seconds of the message graph's build.

    ``comm``: this rank's communicator; every rank calls this with the same
    arguments and ``device`` of the rank's type (it runs on the rank's
    device), and the message graph is cut into shards of ``dist_rb``-row
    multiples (module docstring; ``check_shardable`` names the configs
    it refuses). The stats are the same on every rank; ``params`` is the
    replicated state."""
    device = resolve_device(device)
    if comm is not None:
        if device.type != comm.device.type:
            raise ValueError(f"device {device} for a rank on {comm.device}")
        device = comm.device
    if split_edge is None:
        split_edge, msg_edges = simple_split_edges(edge_index, n_node,
                                                   seed=seed)
    elif msg_edges is None:
        msg_edges = symmetrize(np.asarray(split_edge["train"]["edge"]).T,
                               n_node)
    if cfg.encoder in ("CN", "AA", "PPR"):
        return _heuristic_run(cfg, split_edge, msg_edges, n_node)

    t0 = time.perf_counter()
    if comm is None:
        g = link_graph(cfg, msg_edges, n_node)
    else:
        check_shardable(cfg)
        if x is None:
            raise ValueError("sharded link prediction needs the features x")
        g = link_dist_graph(cfg, msg_edges, n_node, comm, rb=dist_rb)
    graph_build_s = time.perf_counter() - t0
    g = g.to(device)
    if comm is not None:
        xd = shard_rows(x, g, device)
    elif x is None:
        xd = torch.zeros(n_node, 1, device=device)
    else:
        xd = torch.as_tensor(x, dtype=torch.float32, device=device)
    const = link_const(cfg, g, xd)

    pos_train = np.asarray(split_edge["train"]["edge"])
    n_pos = pos_train.shape[0]
    bsz = min(cfg.batch_size, n_pos)
    pos_all = torch.from_numpy(pos_train.astype(np.int64)).to(device)
    keys_np = sampling.edge_keys(msg_edges, n_node)
    # large graphs: hash-bucket membership instead of a binary search
    keys = (sampling.build_membership(keys_np).to(device)
            if n_node > 100_000 else torch.from_numpy(keys_np).to(device))

    n_draw_fix = n_pos
    if max_steps_per_epoch:
        n_draw_fix = min(n_pos, max_steps_per_epoch * bsz)
    n_steps = (n_draw_fix + bsz - 1) // bsz

    logger = Logger(runs)
    results_last = None
    epoch_s, epoch_loss = [], []
    for run in range(runs):
        init_gen = torch.Generator(device=device).manual_seed(seed + 1000 * run)
        gen = torch.Generator(device=device).manual_seed(seed + 1000 * run + 1)
        if comm is not None:
            const["encoder_generator"] = torch.Generator(device=device).manual_seed(
                seed + 1000 * run + 2 + (comm.shard << 32))
        with torch.device(device):
            model = LinkPredModel(cfg, n_node, xd.shape[1], generator=init_gen)
        optimizer = make_optimizer(cfg, model.parameters())
        epoch_fn = make_epoch_fn(cfg, model, optimizer, n_node, n_steps, bsz, n_draw_fix)

        for epoch in range(epochs):
            model.train()
            t0 = time.perf_counter()
            losses = epoch_fn(const, pos_all, keys, gen)
            with debug.host_read("gnn.link.read"):  # the epoch's one host read
                total_loss = float(losses.sum())
            epoch_s.append(time.perf_counter() - t0)
            nb = losses.numel()
            epoch_loss.append(total_loss / max(nb, 1))

            if (epoch + 1) % eval_steps == 0:
                results = evaluate(cfg, model, const, split_edge)
                key = list(results.keys())[0]
                vals = results[key]
                logger.add_result(run, vals[-2:])
                results_last = results
                if log_every and (comm is None or comm.rank == 0):
                    print(f"run {run} ep {epoch}: "
                          f"loss={total_loss / max(nb, 1):.4f} {key}={vals}")

    return {"logger": logger, "stats": logger.statistics(),
            "last_results": results_last, "params": model.state_dict(),
            "split_edge": split_edge, "epoch_s": epoch_s,
            "epoch_loss": epoch_loss, "graph_build_s": graph_build_s}


def encode_all(model: LinkPredModel, const) -> torch.Tensor:
    """The eval-mode encode of every node (a rank's rows on a
    ``DistGraph``)."""
    return model.encode(const["g"], const["x"], agg0=const.get("agg0"))


def predict_chunked(model: LinkPredModel, h: torch.Tensor, edges,
                    chunk: int = 64 * 1024, g=None) -> torch.Tensor:
    """batch_predict (model.py:172-185): the scores of ``edges`` [m, 2] (a
    numpy array or a tensor). ``g``: the graph ``h`` was encoded on
    (``take_rows``). Where the predictor takes the pairs
    (``predictors.py:takes_pairs``: DOT over an f32 table) and ``h`` is the
    whole table, the split is scored in one forward (one kernel launch on
    the card) and ``chunk`` is not used; any other predictor, or a rank's
    rows of a sharded graph, in chunks of ``chunk`` pairs, so no [m, d]
    endpoint gather is materialised at once."""
    with debug.span("gnn.link.score"):
        edges = torch.as_tensor(edges, device=h.device).long()
        if takes_pairs(model.predictor, h) and not isinstance(g, ShardedGraph):
            return model.predictor(h, edges.contiguous())
        outs = [model.predict_pairs(take_rows(g, h, e[:, 0]), take_rows(g, h, e[:, 1]))
                for e in torch.split(edges, chunk)]
        return torch.cat(outs) if outs else h.new_zeros(0)


def evaluate(cfg: LinkPredConfig, model: LinkPredModel, const,
             split_edge: Dict) -> Dict:
    """model.test (model.py:187-266) incl. the optional edge-level LP
    post-processing (208-239). Encodes ONCE, scores each split in chunks."""
    model.eval()
    with torch.no_grad():
        with debug.span("gnn.link.encode"):
            h_eval = encode_all(model, const)

        def scores(edges):
            return predict_chunked(model, h_eval, edges, g=const["g"])

        pos_val = scores(split_edge["valid"]["edge"])
        neg_val = scores(split_edge["valid"]["edge_neg"])
        pos_test = scores(split_edge["test"]["edge"])
        neg_test = scores(split_edge["test"]["edge_neg"])
        # train positives are consumed only by recall_my and the edge-LP
        # guidance (at citation2 scale ~15M edges, half of every evaluation)
        need_train = (cfg.eval_metric.startswith("recall_my")
                      or cfg.edge_lp_mode in ("logit", "xmc", "emb"))
        pos_train = (scores(split_edge["train"]["edge"]) if need_train
                     else h_eval.new_zeros(0))
        neg_train = neg_val  # reference uses fresh global negs; reuse eval negs

        if cfg.edge_lp_mode in ("logit", "xmc", "emb"):
            (pos_train, pos_val, pos_test, neg_val, neg_test) = _edge_lp(
                cfg, const, split_edge, h_eval,
                [pos_train, pos_val, pos_test, neg_val, neg_test])
            neg_train = neg_val

    m = cfg.eval_metric
    with debug.span("gnn.link.metric"):
        if m == "hits":
            return M.evaluate_hits(pos_val, neg_val, pos_test, neg_test)
        if m == "mrr":
            return M.evaluate_mrr(pos_val, neg_val, pos_test, neg_test)
        if "recall_my" in m:
            topk = float(m.split("@")[1])
            return M.evaluate_recall_my(pos_train, neg_train, pos_val, neg_val,
                                        pos_test, neg_test, topk=topk)
    raise ValueError(m)


def _edge_lp(cfg, const, split_edge, h_eval, parts):
    """The edge-LP post-processing of the five score vectors ``parts``
    (train, valid, test positives; valid, test negatives)."""
    from . import edge_lp as elp

    # logits order [pos_train, pos_valid, pos_test, negs...]: the guidance
    # layout of run_logitLP (edge_LP.py:59-64)
    all_edges = np.concatenate(
        [np.asarray(split_edge["train"]["edge"]),
         np.asarray(split_edge["valid"]["edge"]),
         np.asarray(split_edge["test"]["edge"]),
         np.asarray(split_edge["valid"]["edge_neg"]),
         np.asarray(split_edge["test"]["edge_neg"])], axis=0)
    sizes = [len(p) for p in parts]
    n_pos_total = sizes[0] + sizes[1] + sizes[2]
    if cfg.edge_lp_mode == "emb":
        out = elp.run_emb_lp(all_edges, h_eval, cfg.elp_alpha,
                             cfg.elp_num_propagations)
    elif cfg.edge_lp_mode == "logit":
        out = elp.run_logit_lp(all_edges, torch.cat(parts), sizes[0],
                               n_pos_total, cfg.elp_alpha,
                               cfg.elp_num_propagations)
    else:
        g = const["g"]
        e_msg = np.stack([g.indices.cpu().numpy(),
                          edge_rows(g.indptr, g.n_edge).cpu().numpy()])
        out = elp.run_xmc_lp(e_msg, g.n_node, all_edges, torch.cat(parts),
                             sizes[0], n_pos_total, cfg.elp_alpha,
                             cfg.elp_num_propagations)
    return torch.split(out, sizes)
