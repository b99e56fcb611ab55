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
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Union

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
from ..propagation import correlation as corr
from .evalutil import headtail_accuracies, masked_accuracy
from .optim import make_optimizer


@dataclass
class TrainResult:
    columns: List[str]
    records: np.ndarray  # [epochs, len(columns)]
    state_dict: Dict[str, torch.Tensor]  # final parameters and buffers
    step_ms: List[float]  # per epoch: forward, backward and Adam, synchronised
    # the teacher's best-by-acc_test parameters when training for SEMLP,
    # else the final ones
    best_state_dict: Optional[Dict[str, torch.Tensor]] = None
    eval_ms: List[float] = field(default_factory=list)  # part 2: head/tail/iso
    extra: Dict[str, Any] = field(default_factory=dict)  # SEMLP: earlier phases

    def last(self, col: str) -> float:
        return float(self.records[-1, self.columns.index(col)])

    def best(self, col: str) -> float:
        return float(self.records[:, self.columns.index(col)].max())


def _nll_masked(logits: torch.Tensor, y: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    picked = torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
    # where (not *0) so masked-out rows can hold non-finite values
    picked = torch.where(mask, picked, torch.zeros_like(picked))
    return -picked.sum() / mask.float().sum().clamp(min=1.0)


def teacher_loss(cfg: Config, classi: torch.Tensor,
                 se_reg_all: Optional[torch.Tensor], y: torch.Tensor,
                 train_mask: torch.Tensor,
                 l_struct: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The teacher's train loss: the masked NLL (nodewise component), the SE
    regulariser, and the edgewise loss ``l_struct`` where the config has
    that component (exp_mode=I2_GTL)."""
    loss = torch.zeros((), device=classi.device)
    if cfg.has_loss_component_nodewise:
        loss = _nll_masked(classi, y, train_mask) * cfg.TeacherGNN.lossa_semantic
    if se_reg_all is not None:
        loss = loss + cfg.se_reg * se_reg_all
    if l_struct is not None:
        loss = loss + l_struct * cfg.TeacherGNN.lossa_structure
    return loss


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
    ``step_ms`` of the result holds each epoch's train-step time on the
    host clock. Under the edgewise loss (exp_mode=I2_GTL) the pairs are
    drawn from a generator seeded ``seed + 5``, and the records gain the
    MRR columns ``linkp_train`` (the train-mode forward's) and
    ``linkp_test`` (the eval forward's). ``save_dir``: the final state is
    written to ``<save_dir>/teacherGNN.pt``, and when training for SEMLP
    the best one to ``best-teacherGNN.pt`` (train/checkpoint.py)."""
    epochs = cfg.epochs if epochs is None else epochs
    device = torch.device(device)

    model = TeacherGNN(cfg, generator=torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    model.to(device)
    drop_gen = torch.Generator(device=device).manual_seed(seed)
    # graph-dropout masks get a stream of their own, drawn in train mode only
    graph_gen = torch.Generator(device=device).manual_seed(seed + 4)
    opt = make_optimizer(cfg, model.parameters())
    ew_fn = None
    if cfg.has_loss_component_edgewise:
        from .edgewise import build_edgewise_plan, make_edgewise_loss_fn

        ew_fn = make_edgewise_loss_fn(build_edgewise_plan(cfg, data), device)
        pair_gen = torch.Generator(device=device).manual_seed(seed + 5)

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
    if ew_fn is not None:
        cols += ["linkp_train", "linkp_test"]
    records = np.zeros((epochs, len(cols)), np.float64)
    step_ms: List[float] = []
    keep_best = "SEMLP" in cfg.train_which
    acc_i = cols.index("acc_test")
    best_acc, best_state = -1.0, None

    for epoch in range(epochs):
        _sync(device)
        t0 = time.perf_counter()
        model.train()
        opt.zero_grad(set_to_none=True)
        common, classi, se_reg_all, _ = model(g, x, generator=drop_gen,
                                              graph_generator=graph_gen, g_last=g_last)
        l_struct = linkp_train = None
        if ew_fn is not None:
            # the full (unmasked) embedding (trainer:418)
            l_struct, linkp_train = ew_fn(common, pair_gen, "train")
        loss = teacher_loss(cfg, classi, se_reg_all, y, train_mask, l_struct)
        loss.backward()
        opt.step()
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)

        # eval-mode full forward (run_testSet)
        model.eval()
        with torch.no_grad():
            common, classi, _, _ = model(g, x)
            metrics = {
                "loss_train": loss.detach(),
                "acc_train": masked_accuracy(classi, y, train_mask) * 100.0,
                "acc_test": masked_accuracy(classi, y, test_mask) * 100.0,
            }
            if want_ht:
                metrics.update(headtail_accuracies(classi, y, train_mask,
                                                   large, small, zero))
            if ew_fn is not None:
                metrics["linkp_train"] = linkp_train.detach()
                metrics["linkp_test"] = ew_fn(common, pair_gen, "test")[1]
            # one device->host copy per epoch
            records[epoch] = torch.stack(
                [metrics[c].float() for c in cols]).cpu().numpy()
        if records[epoch, acc_i] > best_acc:
            best_acc = records[epoch, acc_i]
            if keep_best:  # state_dict() holds live tensors that Adam updates
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
        if log_every and epoch % log_every == 0:
            print(f"Ep{epoch:03d} " + " ".join(
                f"{c}={records[epoch, i]:.2f}" for i, c in enumerate(cols)))

    final = {k: v.detach() for k, v in model.state_dict().items()}
    if save_dir:
        from .checkpoint import save_train_state

        save_train_state(f"{save_dir}/teacherGNN.pt", params=final, epoch=epochs)
        if keep_best and best_state is not None:
            save_train_state(f"{save_dir}/best-teacherGNN.pt", params=best_state,
                             epoch=epochs)
    return TrainResult(
        columns=cols,
        records=records,
        state_dict=final,
        step_ms=step_ms,
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
                       device="cpu",
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The teacher's SE table [N, se_dim]: the concatenation of every
    layer's pre-relu output on the full graph (trainer:87, GCN.py:148-150).
    An eval-mode forward by default; in train mode, with dropout drawn from
    ``generator``, when ``cfg.bug_compat_part1_target_dropout`` is set (the
    reference's single dropout sample as the part-1 target)."""
    device = torch.device(device)
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
    device="cpu",
) -> TrainResult:
    """SEMLP part 1: regress the teacher's SE rows from the node features,
    MSE on ``min(batch_size, n_train)`` train nodes per step; ``loss_test``
    is the MSE on a batch drawn from the test nodes after the step."""
    epochs = cfg.epochs if epochs is None else epochs
    device = torch.device(device)
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
    step_ms: List[float] = []
    for epoch in range(epochs):
        _sync(device)
        t0 = time.perf_counter()
        model.train()
        opt.zero_grad(set_to_none=True)
        bidx = _sample(train_idx, bsz, gen)
        loss = F.mse_loss(model(x[bidx], generator=gen), se[bidx])
        loss.backward()
        opt.step()
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)

        model.eval()
        with torch.no_grad():
            tidx = _sample(test_idx, bsz, gen)
            err = (model(x[tidx]) - se[tidx]) ** 2
            loss_test = err.sum() / max(err.numel(), 1)  # 0 over no nodes
            records[epoch] = torch.stack([loss.detach(), loss_test]).cpu().numpy()
        if log_every and epoch % log_every == 0:
            print(f"p1 Ep{epoch:03d} train/test mse "
                  f"{records[epoch, 0]:.4f}/{records[epoch, 1]:.4f}")
    return TrainResult(
        columns=cols, records=records,
        state_dict={k: v.detach() for k, v in model.state_dict().items()},
        step_ms=step_ms)


# ---------------------------------------------------------------------------
# GraphMLP's adjacency power (host side, numpy/scipy)
# ---------------------------------------------------------------------------


def _sparse_adj_pow(data: PreparedData, r: int) -> sp.csr_matrix:
    """GraphMLP's A_tilde^r as a scipy CSR (graphUtils.normalize_adj +
    sparse_power, utils.py:1225-1248): self loops replaced, symmetric degree
    normalisation, r-th power."""
    e = add_self_loops(remove_self_loops(data.edge_index), data.n_node)
    n = data.n_node
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
    device="cpu",
) -> TrainResult:
    """SEMLP part 2, or a student MLP when downgraded (StudentBaseMLP,
    GraphMLP, ``SEMLP__downgrade_to_MLP``): cross-entropy on random train
    batches; ``acc_test`` on a batch of test nodes, and head/tail/iso as
    forwards on those index subsets, each scored over its non-train nodes.
    ``eval_ms`` of the result holds the head/tail/iso forwards' time per
    epoch."""
    epochs = cfg.epochs if epochs is None else epochs
    device = torch.device(device)
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
        if data.n_node <= 8192:
            adj_dense = torch.from_numpy(
                _dense_adj_pow(data, cfg.graphMLP_r)).to(device)
        else:
            # dense [N, N] is out of reach at scale (114 GB at arxiv): crop
            # [B, B] blocks of the sparse power on the host per step
            adj_sparse = _sparse_adj_pow(data, cfg.graphMLP_r)

    init_gen = torch.Generator().manual_seed(seed + 2)
    model = (GraphMLP(cfg, generator=init_gen) if is_graphmlp else
             SEMLPPart2(cfg, se_dim=0 if se is None else se.shape[1],
                        generator=init_gen))
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    opt = make_optimizer(cfg, model.parameters())

    def forward(idx: torch.Tensor, train: bool):
        """(logits of the rows ``idx``, the GraphMLP NContrast term or
        None). The NContrast term enters the train loss only
        (trainer:156-158)."""
        model.train(train)
        g = gen if train else None
        xb = x[idx]
        if is_graphmlp:
            logits, z = model(xb, generator=g)
            if not train:
                return logits, None
            if adj_dense is not None:
                crop = adj_dense[idx][:, idx]
            else:
                crop = torch.from_numpy(
                    adj_pow_crop(adj_sparse, idx.cpu().numpy())).to(device)
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
        m = ~train_mask[idx]
        correct = ((logits.argmax(dim=1) == y[idx]) & m).sum()
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
    step_ms: List[float] = []
    eval_ms: List[float] = []

    for epoch in range(epochs):
        _sync(device)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        bidx = _sample(train_idx, bsz, gen)
        logits, aux = forward(bidx, train=True)
        loss = F.cross_entropy(logits, y[bidx])
        if aux is not None:
            loss = loss + aux
        loss.backward()
        opt.step()
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)

        with torch.no_grad():
            tidx = _sample(test_idx, bsz, gen)
            logits_t, _ = forward(tidx, train=False)
            metrics = {"loss_train": loss.detach(),
                       "acc_test": masked_accuracy(logits_t, y[tidx]) * 100.0}
            _sync(device)
            t0 = time.perf_counter()
            for name, idx in subsets.items():
                metrics[name] = subset_test_acc(idx)
            _sync(device)
            eval_ms.append((time.perf_counter() - t0) * 1e3)
            records[epoch] = torch.stack(
                [metrics[c].float() for c in cols]).cpu().numpy()
        if log_every and epoch % log_every == 0:
            print(f"p2 Ep{epoch:03d} " + " ".join(
                f"{c}={records[epoch, i]:.2f}" for i, c in enumerate(cols)))
    return TrainResult(
        columns=cols, records=records,
        state_dict={k: v.detach() for k, v in model.state_dict().items()},
        step_ms=step_ms, eval_ms=eval_ms)


def run_pure_lp(cfg: Config, data: PreparedData, alpha: float = 0.5,
                num_propagations: int = 50, *, device="cpu") -> Dict[str, float]:
    """trainer:33-63: DAD label propagation from the train labels on
    ``device``; accuracies (x100, rounded to 2 places) over the train nodes
    and over every other node (``~train_mask``, not ``data.test_mask``, as
    the JAX package's single-device branch)."""
    device = torch.device(device)
    dad, _, _ = corr.gen_normalized_adjs(data.edge_index, data.n_node,
                                         which={"DAD"})
    y = torch.as_tensor(data.y, device=device)
    nc = cfg.num_classes or int(data.y.max()) + 1
    out = corr.label_propagation(
        y, torch.as_tensor(data.train_idx, device=device), dad.to(device),
        alpha, num_propagations, nc, spmm_method=cfg.spmm_method)
    train_mask = torch.as_tensor(data.train_mask, device=device)
    acc_train = masked_accuracy(out, y, train_mask).item() * 100
    acc_test = masked_accuracy(out, y, ~train_mask).item() * 100
    return {"acc_train": round(acc_train, 2), "acc_test": round(acc_test, 2)}


def run_experiment(cfg: Config, data: PreparedData, seed: int = 0,
                   epochs: Optional[int] = None, log_every: int = 0, *,
                   device="cpu") -> Union[TrainResult, Dict[str, float]]:
    """The dispatch on ``cfg.train_which`` (trainer_node_classification.py:
    10-30). SEMLP: teacher (best-by-test weights kept) -> SE table -> part 1
    -> part 2; the result is part 2's, with the teacher's and part 1's
    results under ``extra``. LP returns ``run_pure_lp``'s dict."""
    tw = cfg.train_which
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
