"""Training loops: the TeacherGNN, the two SEMLP phases, and the students.

The port of ``gnn_tail_generalization_tpu/train/loops.py`` (the reference's
``trainer_node_classification.py``):

- ``train_teacher`` (train_teacherGNN 303-372, run_trainSet/run_testSet
  382-495): full-graph epochs, masked NLL + se_reg * sum ||E^l||_F, Adam,
  and an eval-mode full forward with the head/tail/iso breakdown after every
  step; the best-by-test weights are kept when training for SEMLP;
- ``collect_teacher_se`` + ``train_semlp_part1`` (train_seMLP_part1 66-124):
  the teacher's SE table as the target of an MSE regression on uniform
  with-replacement batches of train nodes;
- ``train_semlp_part2`` (train_seMLP_part2 126-207): cross-entropy on random
  batches (+ graphMLP_reg * NContrast for GraphMLP), head/tail/iso eval as
  forwards on the index subsets;
- ``run_pure_lp`` (main 33-63): label propagation from the train labels
  over the DAD adjacency;
- ``run_experiment``: the dispatch on ``train_which`` (10-30).

Each epoch is one eager step. The JAX package's epoch-block scans exist to
amortise TPU dispatch and are not carried over (``--epoch_block`` is
accepted and ignored); multi-seed training loops over the seeds
(``train/multiseed.py``). Random batches and dropout are drawn from one
``torch.Generator`` per phase, seeded from ``seed`` (the teacher's
graph-dropout masks and edgewise pairs from one more each).

Sharded (``data`` from ``data/datasets.py:prepare_sharded``, one rank's
rows and its ``DistGraph``): every phase runs, each rank calling it with the
same arguments. The 2-D graph x model mesh (``prepare_sharded(...,
model_axis=...)``) and the two-level layout (``prepare_hier``, a
``parallel/hier.py:HierGraph``) train the teacher only, as in the JAX
package. The teacher as ``train_teacher`` says. The students' and
part 1's parameters are replicated and so is every batch: ``make_take_rows``
gathers the batch's rows of ``x``, the SE table, the labels and the masks
from their owners (``dist_take_rows``), the same rows on every rank. So the
batches and the dropout masks come from streams seeded alike on every rank,
each rank computes the whole loss, and no gradient is summed (``x`` and the
SE table are constants): the parameters stay equal across the ranks. Part 2
finds the latent neighbours in the row-sharded SE table
(``ops/topk_attention.py:dist_latent_replace``); ``run_pure_lp`` propagates
on a sharded DAD adjacency.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..config import Config
from ..data.datasets import PreparedData
from ..graph.core import Graph, add_self_loops, loss_masked_view, remove_self_loops
from ..models.semlp import GraphMLP, SEMLPPart1, SEMLPPart2, neighbor_contrastive_loss
from ..models.teacher import TeacherGNN
from ..nn.norms import norm_applies
from ..ops.topk_attention import dist_latent_replace
from ..parallel.distgraph import (DistGraph, ShardedGraph, build_dist_graph,
                                  dist_take_rows, gather_model_cols, model_comm_of,
                                  shard_state_dict,
                                  slice_model_cols, sum_replicated_grads)
from ..propagation import correlation as corr
from ..utils import debug
from ..utils.device import resolve_device
from .evalutil import headtail_accuracies, masked_accuracy
from .optim import make_optimizer


@dataclass
class TrainResult:
    columns: List[str]
    records: np.ndarray  # [epochs, len(columns)]
    state_dict: Dict[str, torch.Tensor]  # final parameters and buffers
    # per epoch: forward, backward and Adam, the ``step`` span's time: on
    # CUDA its two events (device time, idle inside included), read after
    # the call's last records read; elsewhere the host clock
    step_ms: List[float]
    # the teacher's best-by-acc_test parameters when training for SEMLP,
    # else the final ones
    best_state_dict: Optional[Dict[str, torch.Tensor]] = None
    # part 2: the head/tail/iso forwards, the ``eval.subsets`` span's time,
    # taken as ``step_ms`` is
    eval_ms: List[float] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)  # SEMLP: earlier phases

    def last(self, col: str) -> float:
        return float(self.records[-1, self.columns.index(col)])

    def best(self, col: str) -> float:
        return float(self.records[:, self.columns.index(col)].max())


def _nll_masked(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                n_masked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The NLL summed over the masked rows, over ``n_masked`` (default: the
    mask's count here; on a rank's rows, the count over every rank)."""
    picked = torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
    # where (not *0) so masked-out rows can hold non-finite values
    picked = torch.where(mask, picked, torch.zeros_like(picked))
    if n_masked is None:
        n_masked = mask.float().sum()
    return -picked.sum() / n_masked.clamp(min=1.0)


def teacher_loss(cfg: Config, classi: torch.Tensor,
                 se_reg_all: Optional[torch.Tensor], y: torch.Tensor,
                 train_mask: torch.Tensor,
                 l_struct: Optional[torch.Tensor] = None, *,
                 n_train: Optional[torch.Tensor] = None,
                 n_shards: int = 1) -> torch.Tensor:
    """The teacher's train loss: the masked NLL (nodewise component), the SE
    regulariser, and the edgewise loss ``l_struct`` where the config has
    that component (exp_mode=I2_GTL).

    On one rank's rows of a sharded run, the rank's part, the parts summing
    to the loss over the ranks: the NLL of the rank's rows over the global
    train count ``n_train``, and each term that every rank computes whole
    (the SE regulariser, the edgewise loss) divided by ``n_shards``, since
    the replicated gradients are summed over the ranks."""
    loss = torch.zeros((), device=classi.device)
    if cfg.has_loss_component_nodewise:
        loss = _nll_masked(classi, y, train_mask, n_train) * cfg.TeacherGNN.lossa_semantic
    if se_reg_all is not None:
        loss = loss + cfg.se_reg * se_reg_all / n_shards
    if l_struct is not None:
        loss = loss + l_struct * cfg.TeacherGNN.lossa_structure / n_shards
    return loss


def final_agg_view(cfg: Config, data: PreparedData
                   ) -> Optional[Union[Graph, DistGraph]]:
    """The loss-masked final-layer graph (Config.optimize_final_layer_agg)
    or None. The single gate for the optimization: valid only when the
    train-mode last-conv output reaches the loss exclusively through the
    row-masked NLL — no edgewise loss, no cross-row norm trick, no graph
    dropout, and a real nodewise loss. On a ``DistGraph`` the view is a
    second ``DistGraph`` over the train-dst edges that keeps the full
    graph's degree vectors and model axis (JAX ``loops.py:118-129``). A
    ``HierGraph`` has none, as in JAX (``:103-108``): the view only saves
    time, and the loss and gradients are the same without it."""
    if not (cfg.optimize_final_layer_agg
            and cfg.has_loss_component_nodewise
            and not cfg.has_loss_component_edgewise
            and not cfg.apply_graph_dropout):
        return None
    if norm_applies(cfg.type_trick):
        return None
    g, e = data.graph, data.edge_index
    if isinstance(g, ShardedGraph) and not g.has_loss_view:
        return None
    m = np.zeros(g.n_node, bool)
    m[np.asarray(data.train_idx)] = True
    if isinstance(g, DistGraph):
        sub = build_dist_graph(e[:, m[e[1]]], g.n_node, g.comm, rb=g.rb,
                               model_comm=g.model_comm)
        return dataclasses.replace(sub, deg_in=g.deg_in, deg_out=g.deg_out)
    return loss_masked_view(g, e, m)


def _dist_graph_of(data: PreparedData) -> Optional[ShardedGraph]:
    """The sharded graph of data from ``prepare_sharded`` or
    ``prepare_hier``, else None."""
    return data.graph if isinstance(data.graph, ShardedGraph) else None


def _n_global(data: PreparedData) -> int:
    """The graph's node count (a rank's data holds only its rows)."""
    dg = _dist_graph_of(data)
    return data.n_node if dg is None else dg.n_node


def _rank_device(device, g: Optional[DistGraph]) -> torch.device:
    """``device`` resolved; on a rank (``g`` a ``DistGraph``) the rank's
    device, which must be of ``device``'s type."""
    device = resolve_device(device)
    if g is None:
        return device
    if device.type != g.comm.device.type:
        raise ValueError(f"device {device} for a rank on {g.comm.device}")
    return g.comm.device


def log_here(g: Optional[DistGraph], log_every: int, epoch: int) -> bool:
    """Whether to print epoch ``epoch``'s line: every ``log_every``
    epochs, on rank 0 of a sharded run."""
    return bool(log_every) and epoch % log_every == 0 and (
        g is None or g.comm.rank == 0)


def make_take_rows(g: Optional[DistGraph]):
    """``take(arr, idx)``, the students' batch gather (JAX ``loops.py:
    _make_take_rows``): ``arr[idx]`` on one device; on a rank of a sharded
    run (``g``) the rows ``idx`` (global ids) of the rank-sharded ``arr``
    through ``dist_take_rows``, one all-reduce of ``[len(idx), d]``, the
    same on every rank. A 1-D ``arr`` (labels, masks) goes as an ``[N, 1]``
    f32 column, and a bool one comes back as ``> 0.5``."""
    if g is None:
        return lambda arr, idx: arr[idx]

    def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if arr.dim() == 1:
            out = dist_take_rows(g, arr.float()[:, None], idx)[:, 0]
            return out > 0.5 if arr.dtype == torch.bool else out.to(arr.dtype)
        return dist_take_rows(g, arr, idx)

    return take


def _teacher_model(cfg: Config, seed: int, init_state: Optional[Mapping[str, Any]],
                   g: Optional[DistGraph]) -> TeacherGNN:
    """The teacher, from ``seed`` or ``init_state``. On a rank of a
    ``DistGraph`` its row-sharded parameters hold the rank's rows
    (``parallel/distgraph.py:ROW_SHARDED``): the whole model is drawn from
    ``seed`` on every rank, with the SE tables over all ``n_node_pad`` rows
    and their padding rows zeroed (JAX ``loops.py:216-229``), and the rank
    keeps its rows, so the start does not depend on the number of shards;
    ``init_state`` is then the rank's state (``utils/convert.py``). On a
    2-D mesh the rank also keeps its model shard's columns of the
    column-parallel kernels and SE tables, of ``init_state`` too where it
    holds whole ones."""
    gen = torch.Generator().manual_seed(seed)
    if g is None:
        model = TeacherGNN(cfg, generator=gen)
        if init_state is not None:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
        return model
    if init_state is None:
        full = TeacherGNN(dataclasses.replace(cfg, N_nodes=g.n_node_pad),
                          generator=gen).state_dict()
        for name, t in full.items():
            if name.rsplit(".", 1)[-1] == "se":
                t[g.n_node:] = 0.0
        init_state = shard_state_dict(full, g.comm.shard, g.n_shards)
    mc = model_comm_of(g)
    with torch.device("meta"):
        model = TeacherGNN(dataclasses.replace(cfg, N_nodes=g.rows_per_shard),
                           model_comm=mc)
    state = {k: torch.as_tensor(v).clone() for k, v in init_state.items()}
    if mc is not None:
        state = slice_model_cols(
            state, {k: v.shape for k, v in model.state_dict().items()}, mc.shard)
    model.load_state_dict(state, assign=True)
    return model


def teacher_step_grads(cfg: Config, model: TeacherGNN, g: Union[Graph, DistGraph],
                       x: torch.Tensor, y: torch.Tensor, train_mask: torch.Tensor, *,
                       n_train: Optional[torch.Tensor] = None,
                       g_last: Optional[Union[Graph, DistGraph]] = None,
                       generator: Optional[torch.Generator] = None,
                       graph_generator: Optional[torch.Generator] = None,
                       edgewise=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The loss and gradients of one train step, no optimizer update:
    forward (the model's mode as the caller set it), ``teacher_loss``,
    backward, and on a rank of a sharded run (``g`` a ``DistGraph``) the
    replicated gradients summed over the ranks. ``edgewise(common)`` gives the
    edgewise loss and its MRR where the config has that component.
    ``n_train``: the global train count of a sharded run, all-reduced here
    when not given. Returns the loss (the rank's part) and the MRR or
    None."""
    with debug.span("gnn.teacher.step.forward"):
        common, classi, se_reg_all, _ = model(g, x, generator=generator,
                                              graph_generator=graph_generator,
                                              g_last=g_last)
        l_struct = linkp = None
        if edgewise is not None:
            # the full (unmasked) embedding (trainer:418)
            l_struct, linkp = edgewise(common)
        comm = g.comm if isinstance(g, ShardedGraph) else None
        n_shards = 1
        if comm is not None:
            n_shards = comm.world_size
            if n_train is None:
                n_train = comm.all_reduce_sum_(train_mask.float().sum())
        loss = teacher_loss(cfg, classi, se_reg_all, y, train_mask, l_struct,
                            n_train=n_train, n_shards=n_shards)
    with debug.span("gnn.teacher.step.backward"):
        loss.backward()
        if comm is not None:
            sum_replicated_grads(model, comm)
    return loss, linkp


def train_teacher(
    cfg: Config,
    data: PreparedData,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    *,
    device="cuda",
    init_state: Optional[Mapping[str, Any]] = None,
    save_dir: Optional[str] = None,
) -> TrainResult:
    """Train the teacher for ``epochs`` steps on ``device``. ``seed`` seeds
    the parameter init, the dropout generator and, from ``seed + 4``, the
    graph-dropout generator, which only train-mode forwards draw from
    (main.py passes ``cfg.random_seed + run``). Batch norms run in train
    mode for the step (moving their running statistics) and in eval mode
    for the eval forward; their buffers travel in the state_dicts.
    ``init_state``: starting parameters and buffers (a state_dict, e.g.
    from utils/convert.params_from_jax) instead of the random init.
    ``step_ms`` of the result holds each epoch's train-step time
    (``TrainResult``); an epoch's one blocking read is its records' copy to
    the host. Under the edgewise loss (exp_mode=I2_GTL) the pairs are
    drawn from a generator seeded ``seed + 5``, and the records gain the
    MRR columns ``linkp_train`` (the train-mode forward's) and
    ``linkp_test`` (the eval forward's). ``save_dir``: the final state is
    written to ``<save_dir>/teacherGNN.pt``, and when training for SEMLP
    the best one to ``best-teacherGNN.pt`` (train/checkpoint.py).

    Sharded: ``data`` from ``data/datasets.py:prepare_sharded`` holds one
    rank's rows and its ``DistGraph``; every rank calls this with the same
    arguments (``device`` of the rank's type; it runs on the rank's device).
    The loss is the rank's part (``teacher_loss``), the replicated gradients
    are summed over the ranks before Adam (``sum_replicated_grads``), the
    records are global and the same on every rank, rank 0 logs, dropout
    draws from a stream of each rank's own, and graph-dropout masks and
    edgewise pairs from streams seeded alike on every rank. ``init_state``
    is then the rank's state; ``save_dir`` writes the sharded checkpoint
    directories beside the one-device paths (``train/checkpoint.py``; on a
    2-D mesh the graph axis's, the columns gathered first)."""
    epochs = cfg.epochs if epochs is None else epochs
    with debug.span("gnn.teacher.setup"):
        dist_g = _dist_graph_of(data)
        comm = None if dist_g is None else dist_g.comm
        device = _rank_device(device, dist_g)
        with debug.span("gnn.teacher.setup.model"):
            model = _teacher_model(cfg, seed, init_state, dist_g).to(device)
        # dropout masks differ between the ranks' rows, as one stream over
        # all rows would make them
        drop_gen = torch.Generator(device=device).manual_seed(
            seed + (comm.shard << 32 if comm is not None else 0))
        # graph-dropout masks get a stream of their own, drawn in train mode
        graph_gen = torch.Generator(device=device).manual_seed(seed + 4)
        opt = make_optimizer(cfg, model.parameters())
        with debug.span("gnn.teacher.setup.inputs"):
            g = data.graph.to(device)
            ew_fn = None
            if cfg.has_loss_component_edgewise:
                from .edgewise import build_edgewise_plan, make_edgewise_loss_fn

                ew_fn = make_edgewise_loss_fn(build_edgewise_plan(cfg, data), device,
                                              dist_graph=None if comm is None else g)
                pair_gen = torch.Generator(device=device).manual_seed(seed + 5)

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
        if ew_fn is not None:
            cols += ["linkp_train", "linkp_test"]
        records = np.zeros((epochs, len(cols)), np.float64)
        step_laps = debug.Laps(device)
        keep_best = "SEMLP" in cfg.train_which
        acc_i = cols.index("acc_test")
        best_acc, best_state = -1.0, None
        n_train = None if comm is None else comm.all_reduce_sum_(train_mask.float().sum())
        edgewise = None if ew_fn is None else (lambda h: ew_fn(h, pair_gen, "train"))

    for epoch in range(epochs):
        with debug.span("gnn.teacher.step", step_laps):
            model.train()
            opt.zero_grad(set_to_none=True)
            loss, linkp_train = teacher_step_grads(
                cfg, model, g, x, y, train_mask, n_train=n_train, g_last=g_last,
                generator=drop_gen, graph_generator=graph_gen, edgewise=edgewise)
            with debug.span("gnn.teacher.step.optimizer"):
                opt.step()

        # eval-mode full forward (run_testSet)
        model.eval()
        with torch.no_grad(), debug.span("gnn.teacher.eval"):
            common, classi, _, _ = model(g, x)
            loss_train = loss.detach().clone()
            if comm is not None:
                comm.all_reduce_sum_(loss_train)
            metrics = {
                "loss_train": loss_train,
                "acc_train": masked_accuracy(classi, y, train_mask, comm) * 100.0,
                "acc_test": masked_accuracy(classi, y, test_mask, comm) * 100.0,
            }
            if want_ht:
                metrics.update(headtail_accuracies(classi, y, train_mask,
                                                   large, small, zero, comm))
            if ew_fn is not None:
                metrics["linkp_train"] = linkp_train.detach()
                metrics["linkp_test"] = ew_fn(common, pair_gen, "test")[1]
            stacked = torch.stack([metrics[c].float() for c in cols])
        with debug.host_read("gnn.teacher.read"):  # the epoch's one read
            records[epoch] = stacked.cpu().numpy()
        if records[epoch, acc_i] > best_acc:
            best_acc = records[epoch, acc_i]
            if keep_best:  # state_dict() holds live tensors that Adam updates
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
        if log_here(dist_g, log_every, epoch):
            print(f"Ep{epoch:03d} " + " ".join(
                f"{c}={records[epoch, i]:.2f}" for i, c in enumerate(cols)), flush=True)

    final = {k: v.detach() for k, v in model.state_dict().items()}
    if save_dir:
        from .checkpoint import ShardLayout, save_train_state

        layout = (None if dist_g is None else
                  ShardLayout(comm, dist_g.n_node, dist_g.n_node_pad))
        states = {"teacherGNN": final}
        if keep_best and best_state is not None:
            states["best-teacherGNN"] = best_state
        mc = model_comm_of(dist_g)
        if mc is not None:  # the graph axis's layout: whole columns, model shard 0 writes
            with torch.device("meta"):
                whole = TeacherGNN(dataclasses.replace(
                    cfg, N_nodes=dist_g.rows_per_shard)).state_dict()
            states = {k: gather_model_cols(st, {n: t.shape for n, t in whole.items()}, mc)
                      for k, st in states.items()}
        if mc is None or mc.shard == 0:
            for name, st in states.items():
                save_train_state(f"{save_dir}/{name}.pt", params=st, epoch=epochs,
                                 layout=layout)
    return TrainResult(
        columns=cols,
        records=records,
        state_dict=final,
        step_ms=step_laps.ms(),
        best_state_dict=best_state if best_state is not None else final,
    )


def _on_device(module: torch.nn.Module, state: Mapping[str, torch.Tensor],
               device: torch.device) -> torch.nn.Module:
    """``module`` (built on the meta device) holding ``state``, on
    ``device``, with no gradient."""
    module.load_state_dict(state, assign=True)
    return module.to(device).requires_grad_(False)


def collect_teacher_se(cfg: Config, data: PreparedData,
                       teacher_state: Mapping[str, torch.Tensor], *,
                       device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The teacher's SE table [N, se_dim]: the concatenation of every
    layer's pre-relu output on the full graph (trainer:87, GCN.py:148-150).
    An eval-mode forward by default; in train mode, with dropout drawn from
    ``generator``, when ``cfg.bug_compat_part1_target_dropout`` is set (the
    reference's single dropout sample as the part-1 target). On a rank of a
    sharded run (``teacher_state`` the rank's state) the forward goes
    through the ring and the result is the rank's ``[rows_per_shard,
    se_dim]`` rows of the padded table; ``dist_latent_replace`` never picks
    the padded rows."""
    dg = _dist_graph_of(data)
    device = _rank_device(device, dg)
    if dg is not None:
        cfg = dataclasses.replace(cfg, N_nodes=dg.rows_per_shard)
    with torch.device("meta"):
        model = TeacherGNN(cfg)
    model = _on_device(model, teacher_state, device)
    model.train(bool(cfg.bug_compat_part1_target_dropout))
    with torch.no_grad():
        _, _, _, les = model(data.graph.to(device),
                             torch.as_tensor(data.x).to(device),
                             generator=generator, want_les=True)
    return les


def _sample(idx: torch.Tensor, bsz: int, generator: torch.Generator
            ) -> torch.Tensor:
    """``bsz`` entries of ``idx``, uniform with replacement
    (np.random.choice(idx, bsz) in the reference, main.py:93); none when
    ``idx`` is empty (a split without test nodes, e.g. the WebKB stand-ins)."""
    if idx.numel() == 0:
        return idx
    pick = torch.randint(0, idx.numel(), (bsz,), generator=generator,
                         device=idx.device)
    return idx[pick]


def train_semlp_part1(
    cfg: Config,
    data: PreparedData,
    teacher_se: torch.Tensor,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    *,
    device="cuda",
) -> TrainResult:
    """SEMLP part 1: regress the teacher's SE rows from the node features,
    MSE on ``min(batch_size, n_train)`` train nodes per step; ``loss_test``
    is the MSE on a batch drawn from the test nodes after the step. Sharded:
    ``teacher_se`` is the rank's rows (``collect_teacher_se``), the batches
    come through ``make_take_rows`` and rank 0 logs."""
    epochs = cfg.epochs if epochs is None else epochs
    with debug.span("gnn.part1.setup"):
        dg = _dist_graph_of(data)
        device = _rank_device(device, dg)
        take = make_take_rows(dg)
        se = teacher_se.to(device)
        x = torch.as_tensor(data.x).to(device)
        train_idx = torch.as_tensor(data.train_idx).to(device)
        test_idx = torch.as_tensor(data.test_idx).to(device)
        bsz = min(cfg.batch_size, len(data.train_idx))  # MLP_model:61-63

        model = SEMLPPart1(cfg, se_dim=se.shape[1],
                           generator=torch.Generator().manual_seed(seed + 1))
        model.to(device)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        opt = make_optimizer(cfg, model.parameters())

        cols = ["loss_train", "loss_test"]
        records = np.zeros((epochs, len(cols)), np.float64)
        step_laps = debug.Laps(device)
    for epoch in range(epochs):
        with debug.span("gnn.part1.step", step_laps):
            model.train()
            opt.zero_grad(set_to_none=True)
            with debug.span("gnn.part1.step.forward"):
                bidx = _sample(train_idx, bsz, gen)
                loss = F.mse_loss(model(take(x, bidx), generator=gen), take(se, bidx))
            with debug.span("gnn.part1.step.backward"):
                loss.backward()
            with debug.span("gnn.part1.step.optimizer"):
                opt.step()

        model.eval()
        with torch.no_grad(), debug.span("gnn.part1.eval"):
            tidx = _sample(test_idx, bsz, gen)
            err = (model(take(x, tidx)) - take(se, tidx)) ** 2
            loss_test = err.sum() / max(err.numel(), 1)  # 0 over no nodes
            stacked = torch.stack([loss.detach(), loss_test])
        with debug.host_read("gnn.part1.read"):
            records[epoch] = stacked.cpu().numpy()
        if log_here(dg, log_every, epoch):
            print(f"p1 Ep{epoch:03d} train/test mse "
                  f"{records[epoch, 0]:.4f}/{records[epoch, 1]:.4f}")
    return TrainResult(
        columns=cols, records=records,
        state_dict={k: v.detach() for k, v in model.state_dict().items()},
        step_ms=step_laps.ms())


# ---------------------------------------------------------------------------
# GraphMLP's adjacency power (host side, numpy/scipy)
# ---------------------------------------------------------------------------


def _sparse_adj_pow(data: PreparedData, r: int) -> sp.csr_matrix:
    """GraphMLP's A_tilde^r as a scipy CSR (graphUtils.normalize_adj +
    sparse_power, utils.py:1225-1248): self loops replaced, symmetric degree
    normalisation, r-th power; over the real nodes of a sharded run's graph
    too (a batch holds no padded row)."""
    n = _n_global(data)
    e = add_self_loops(remove_self_loops(data.edge_index), n)
    a = sp.csr_matrix((np.ones(e.shape[1]), (e[0], e[1])), shape=(n, n))
    d = np.asarray(a.sum(axis=1)).reshape(-1)
    dinv = sp.diags(d**-0.5)
    at = (dinv @ a @ dinv).tocsr()
    out = at
    for _ in range(r - 1):
        out = out @ at
    return out.tocsr().astype(np.float32)


def _dense_adj_pow(data: PreparedData, r: int) -> np.ndarray:
    """Dense [N, N] ``_sparse_adj_pow``, for small graphs."""
    return np.asarray(_sparse_adj_pow(data, r).todense(), np.float32)


def adj_pow_crop(adj_csr: sp.csr_matrix, bidx: np.ndarray) -> np.ndarray:
    """Dense [B, B] block A^r[bidx][:, bidx] of the sparse power."""
    return np.asarray(adj_csr[bidx][:, bidx].todense(), np.float32)


# ---------------------------------------------------------------------------
# SEMLP part 2 / StudentBaseMLP / GraphMLP
# ---------------------------------------------------------------------------


def train_semlp_part2(
    cfg: Config,
    data: PreparedData,
    teacher_se: Optional[torch.Tensor] = None,
    part1_result: Optional[TrainResult] = None,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    *,
    device="cuda",
) -> TrainResult:
    """SEMLP part 2, or a student MLP when downgraded (StudentBaseMLP,
    GraphMLP, ``SEMLP__downgrade_to_MLP``): cross-entropy on random train
    batches; ``acc_test`` on a batch of test nodes, and head/tail/iso as
    forwards on those index subsets, each scored over its non-train nodes.
    ``eval_ms`` of the result holds the head/tail/iso forwards' time per
    epoch. Sharded: every row comes through ``make_take_rows``, the latent
    neighbours through ``dist_latent_replace`` on the rank's rows of
    ``teacher_se``, GraphMLP's adjacency power is over the global graph,
    and rank 0 logs."""
    epochs = cfg.epochs if epochs is None else epochs
    with debug.span("gnn.student.setup"):
        dg = _dist_graph_of(data)
        device = _rank_device(device, dg)
        take = make_take_rows(dg)
        x = torch.as_tensor(data.x).to(device)
        y = torch.as_tensor(data.y).to(device)
        train_idx = torch.as_tensor(data.train_idx).to(device)
        test_idx = torch.as_tensor(data.test_idx).to(device)
        train_mask = torch.as_tensor(data.train_mask).to(device)
        bsz = min(cfg.batch_size, len(data.train_idx))

        is_graphmlp = cfg.train_which == "GraphMLP"
        downgraded = cfg.SEMLP__downgrade_to_MLP or cfg.train_which in (
            "StudentBaseMLP", "GraphMLP")
        se = part1 = None
        if not downgraded:
            if teacher_se is None or part1_result is None:
                raise ValueError("SEMLP part 2 needs the teacher's SE table and "
                                 "part 1's result")
            se = teacher_se.to(device)
            with torch.device("meta"):
                part1 = SEMLPPart1(cfg, se_dim=se.shape[1])
            part1 = _on_device(part1, part1_result.state_dict, device)

        adj_dense = adj_sparse = None
        if is_graphmlp:
            if _n_global(data) <= 8192:
                adj_dense = torch.from_numpy(
                    _dense_adj_pow(data, cfg.graphMLP_r)).to(device)
            else:
                # dense [N, N] is out of reach at scale (114 GB at arxiv): crop
                # [B, B] blocks of the sparse power on the host per step
                adj_sparse = _sparse_adj_pow(data, cfg.graphMLP_r)

        replace_fn = None
        if dg is not None and se is not None:
            def replace_fn(le_guess, se_local, top_k):
                return dist_latent_replace(dg, le_guess, se_local, top_k, dg.n_node,
                                           dg.rows_per_shard)
        init_gen = torch.Generator().manual_seed(seed + 2)
        model = (GraphMLP(cfg, generator=init_gen) if is_graphmlp else
                 SEMLPPart2(cfg, se_dim=0 if se is None else se.shape[1],
                            generator=init_gen, replace_fn=replace_fn))
        model.to(device)
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        opt = make_optimizer(cfg, model.parameters())

        def forward(idx: torch.Tensor, train: bool):
            """(logits of the rows ``idx``, the GraphMLP NContrast term or
            None). The NContrast term enters the train loss only
            (trainer:156-158)."""
            model.train(train)
            g = gen if train else None
            xb = take(x, idx)
            if is_graphmlp:
                logits, z = model(xb, generator=g)
                if not train:
                    return logits, None
                if adj_dense is not None:
                    crop = adj_dense[idx][:, idx]
                else:
                    with debug.host_read("gnn.student.step.forward.read"):
                        idx_host = idx.cpu().numpy()
                    crop = torch.from_numpy(adj_pow_crop(adj_sparse, idx_host)).to(device)
                return logits, neighbor_contrastive_loss(
                    z, crop, cfg.graphMLP_tau) * cfg.graphMLP_reg
            p1 = None
            if part1 is not None:
                # part 1 runs in train mode during part-2 training (module-level
                # .train(), trainer:148-152); part 2 detaches its output
                part1.train(train)
                with torch.no_grad():
                    p1 = part1(xb, generator=g)
            return model(xb, p1, se, generator=g), None

        def subset_test_acc(idx: torch.Tensor) -> torch.Tensor:
            """Forward on the subset, accuracy over its non-train nodes
            (trainer:173-187, eval_headtail__traintest_v2)."""
            logits, _ = forward(idx, train=False)
            m = ~take(train_mask, idx)
            correct = ((logits.argmax(dim=1) == take(y, idx)) & m).sum()
            return correct / m.sum().clamp(min=1) * 100.0

        s = data.splits
        want_ht = cfg.want_headtail and s is not None
        subsets = {}
        if want_ht:
            subsets = {"head": s.large_deg_idx, "tail": s.small_deg_idx}
            if s.zero_deg_idx is not None:
                subsets["iso"] = s.zero_deg_idx
            subsets = {k: torch.as_tensor(v).to(device) for k, v in subsets.items()}
        cols = ["loss_train", "acc_test"] + list(subsets)
        records = np.zeros((epochs, len(cols)), np.float64)
        step_laps, eval_laps = debug.Laps(device), debug.Laps(device)

    for epoch in range(epochs):
        with debug.span("gnn.student.step", step_laps):
            opt.zero_grad(set_to_none=True)
            with debug.span("gnn.student.step.forward"):
                bidx = _sample(train_idx, bsz, gen)
                logits, aux = forward(bidx, train=True)
                loss = F.cross_entropy(logits, take(y, bidx))
                if aux is not None:
                    loss = loss + aux
            with debug.span("gnn.student.step.backward"):
                loss.backward()
            with debug.span("gnn.student.step.optimizer"):
                opt.step()

        with torch.no_grad(), debug.span("gnn.student.eval"):
            with debug.span("gnn.student.eval.batch"):
                tidx = _sample(test_idx, bsz, gen)
                logits_t, _ = forward(tidx, train=False)
                metrics = {"loss_train": loss.detach(),
                           "acc_test": masked_accuracy(logits_t, take(y, tidx)) * 100.0}
            with debug.span("gnn.student.eval.subsets", eval_laps):
                for name, idx in subsets.items():
                    metrics[name] = subset_test_acc(idx)
            stacked = torch.stack([metrics[c].float() for c in cols])
        with debug.host_read("gnn.student.read"):
            records[epoch] = stacked.cpu().numpy()
        if log_here(dg, log_every, epoch):
            print(f"p2 Ep{epoch:03d} " + " ".join(
                f"{c}={records[epoch, i]:.2f}" for i, c in enumerate(cols)))
    return TrainResult(
        columns=cols, records=records,
        state_dict={k: v.detach() for k, v in model.state_dict().items()},
        step_ms=step_laps.ms(), eval_ms=eval_laps.ms())


def run_pure_lp(cfg: Config, data: PreparedData, alpha: float = 0.5,
                num_propagations: int = 50, *, device="cuda") -> Dict[str, float]:
    """trainer:33-63: DAD label propagation from the train labels on
    ``device``; accuracies (x100, rounded to 2 places) over the train nodes
    and over every other node (``~train_mask``, not ``data.test_mask``, as
    the JAX package's single-device branch). Sharded: the DAD adjacency is
    a ``DistGraph`` (``gen_normalized_dist_adj``), each rank propagates its
    rows through the ring, and the accuracies count over every rank; the
    test accuracy is then over ``data.test_mask``, as the JAX package's
    sharded branch scores it (``loops.py:866-869``)."""
    dg = _dist_graph_of(data)
    device = _rank_device(device, dg)
    if dg is None:
        dad = corr.gen_normalized_adjs(data.edge_index, data.n_node,
                                       which={"DAD"})[0]
    else:
        dad = corr.gen_normalized_dist_adj(data.edge_index, dg.n_node, dg.comm,
                                           "DAD", rb=dg.rb)
    y = torch.as_tensor(data.y, device=device)
    nc = cfg.num_classes or int(data.y.max()) + 1
    out = corr.label_propagation(
        y, torch.as_tensor(data.train_idx, device=device), dad.to(device),
        alpha, num_propagations, nc, spmm_method=cfg.spmm_method)
    train_mask = torch.as_tensor(data.train_mask, device=device)
    test_mask = (~train_mask if dg is None
                 else torch.as_tensor(data.test_mask, device=device))
    comm = None if dg is None else dg.comm
    acc_train = masked_accuracy(out, y, train_mask, comm).item() * 100
    acc_test = masked_accuracy(out, y, test_mask, comm).item() * 100
    return {"acc_train": round(acc_train, 2), "acc_test": round(acc_test, 2)}


def run_experiment(cfg: Config, data: PreparedData, seed: int = 0,
                   epochs: Optional[int] = None, log_every: int = 0, *,
                   device="cuda") -> Union[TrainResult, Dict[str, float]]:
    """The dispatch on ``cfg.train_which`` (trainer_node_classification.py:
    10-30). SEMLP: teacher (best-by-test weights kept) -> SE table -> part 1
    -> part 2; the result is part 2's, with the teacher's and part 1's
    results under ``extra``. LP returns ``run_pure_lp``'s dict. Every
    phase runs on a rank of a sharded run too (module docstring)."""
    dg = _dist_graph_of(data)
    device = _rank_device(device, dg)
    tw = cfg.train_which
    if dg is not None and tw != "TeacherGNN" and dg.teacher_only:
        raise ValueError(f"the 2-D graph x model mesh and the two-level layout "
                         f"train the TeacherGNN, not {tw!r} (as in the JAX package)")
    if tw == "TeacherGNN":
        return train_teacher(cfg, data, seed, epochs, log_every, device=device)
    if tw == "LP":
        return run_pure_lp(cfg, data, device=device)
    if tw in ("StudentBaseMLP", "GraphMLP"):
        cfg = dataclasses.replace(cfg, SEMLP__downgrade_to_MLP=True)
    elif tw != "SEMLP":
        raise ValueError(f"unknown train_which {tw!r}")
    if cfg.SEMLP__downgrade_to_MLP:
        return train_semlp_part2(cfg, data, seed=seed, epochs=epochs,
                                 log_every=log_every, device=device)
    teacher = train_teacher(cfg, data, seed, epochs, log_every, device=device)
    gen = None
    if cfg.bug_compat_part1_target_dropout:
        gen = torch.Generator(device=device).manual_seed(seed + 3)
    se = collect_teacher_se(cfg, data, teacher.best_state_dict, device=device,
                            generator=gen)
    p1 = train_semlp_part1(cfg, data, se, seed, epochs, log_every, device=device)
    p2 = train_semlp_part2(cfg, data, se, p1, seed, epochs, log_every,
                           device=device)
    p2.extra.update(teacher=teacher, part1=p1)
    return p2
