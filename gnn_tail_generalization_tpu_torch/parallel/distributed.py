"""1-D graph sharding, the all-gather and ring SpMMs, and the bespoke
two-layer sharded train step.

The port of ``gnn_tail_generalization_tpu/parallel/distributed.py``. The
teacher's real sharded path is ``parallel/distgraph.py`` (``DistGraph``,
``prepare_sharded``, ``main --n_devices``); this module keeps the JAX
package's first building blocks, each computing a function no other module
offers: an SpMM that all-gathers its operand, and the stand-alone two-layer
GCN + SE step with plain SGD (``__graft_entry__.py:dryrun_multichip``).

Mesh: JAX lays its devices on a ``('graph',)`` axis (``make_graph_mesh``).
Here every rank is a process, and the world ``Comm`` that
``parallel/launch.py:spawn`` or ``parallel/multihost.py`` gives it already is
that axis (a sub-axis: ``parallel/mesh.py:DeviceMesh(...).comm("graph")``), so
no helper makes one.

Layout (``shard_graph``, JAX ``:68-113``): nodes are padded to
``n_node_pad = ceil(n / S) * S`` and shard k owns destination rows
``[k R, (k + 1) R)``, ``R = n_node_pad / S``, with every edge landing there:
a CSR over its ``R`` local rows with global source ids, and its transpose, a
CSR over all ``n_node_pad`` source rows with local destinations, each with
its ``graph/core.py:RowSchedule``. The JAX padding edges (``pad_multiple``)
exist for XLA's static shapes and are not carried over. This
``ShardedGraph`` is JAX's class of that name; it is unrelated to
``parallel/distgraph.py:ShardedGraph``, the row interface of ``DistGraph``
and ``HierGraph``.

- ``dist_spmm(sg, x, comm)`` (``:124-147``): ``parallel/comm.py:gather_rows``
  all-gathers the row-sharded ``x`` into ``[n_node_pad, d]``, and the f32
  CUDA kernel (``ops/spmm_kernels.py:spmm_csr_f32``) sums it into the rank's
  rows. Its backward is the kernel on the transposed CSR, ``[n_node_pad, d]``,
  reduce-scattered over the ranks (``gather_rows``' backward).
- ``dist_spmm_ring`` (``:222-265``): the ring that passes source blocks from
  shard i to shard i - 1 and sums the matching (dst, src) bucket at each
  step. Its counterpart is the port's own ring, ``parallel/distgraph.py:
  dist_spmm`` on ``build_dist_graph(..., rb=1)``, whose padding
  ``round_up(n, S)`` is JAX's here; ``RingShardedGraph`` is that
  ``DistGraph``, and its buckets are CSRs, not JAX's ``[S, S, E_b]`` padded
  arrays (``ring_bucket_arrays``).
- The teacher (``:268-352``): ``init_dist_teacher`` makes the whole
  parameters as numpy, ``param_shardings`` says which are row-sharded (the
  SE tables), ``utils/convert.py:dist_teacher_params`` cuts a rank's tensors
  from them (or from the JAX package's own), ``dist_teacher_loss`` is the
  two-layer GCN + SE loss and ``make_dist_train_step`` the SGD step. Every
  rank computes the loss whole from all-reduced numerators, counts and
  squared norms, so each backpropagates it divided by S (the all-reduce's
  backward sums the S copies); the gradients of the parameters replicated
  over the graph axis are then summed over it, and the SE rows stay the
  rank's own.

Every function takes tensors on one device: the kernels run on the card and
their plain versions on the CPU. ``dist_spmm`` and ``dist_teacher_loss``
take ``method`` as ``parallel/distgraph.py:ring_kernel`` does, among the
f32 SpMMs JAX's ``segment_sum`` calls for: ``"auto"`` (or ``"pallas"``) the
f32 kernel, ``"gather"`` its plain version (to hold one to the other on the
card); these modules have no bf16 path. ``shard_graph``, ``shard_graph_ring`` and
``local_slices`` default to ``device="cuda"`` and raise where torch finds no
card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..graph.core import RowSchedule, _csr, build_schedule
from ..utils.device import resolve_device
from . import distgraph
from .comm import Comm, gather_rows

#: an array's sharding: per dimension the mesh axis it is cut over, or None
Spec = Tuple[Optional[str], ...]

pad_rows = distgraph.pad_rows_np  # zero rows up to n_node_pad, as JAX's pad_rows


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Shard ``shard``'s edges of a 1-D dst-row partition (module
    docstring): the forward CSR over its ``rows_per_shard`` local rows, with
    global sources, and the transposed CSR over the ``n_node_pad`` source
    rows, with local destinations."""

    indptr: torch.Tensor  # [rows_per_shard + 1] int32
    indices: torch.Tensor  # [E_k] int32, global source ids
    weight: torch.Tensor  # [E_k] float32
    schedule: RowSchedule
    indptr_t: torch.Tensor  # [n_node_pad + 1] int32
    indices_t: torch.Tensor  # [E_k] int32, local destination rows
    weight_t: torch.Tensor
    schedule_t: RowSchedule
    n_node: int
    n_node_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int

    @property
    def n_edge(self) -> int:
        return self.indices.shape[0]

    def to(self, device) -> "ShardedGraph":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, RowSchedule))})


def shard_graph(edge_index: np.ndarray, n_node: int, n_shards: int, shard: int,
                edge_weight: Optional[np.ndarray] = None,
                device="cuda") -> ShardedGraph:
    """Shard ``shard``'s part of the 1-D dst-row partition of the host edge
    list ``[2, E]`` (row 0 the sources), on ``device``."""
    dev = resolve_device(device)
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    e = np.asarray(edge_index, np.int64)
    w = (np.ones(e.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    n_node_pad = distgraph.round_up(n_node, n_shards)
    rows = n_node_pad // n_shards
    mine = np.flatnonzero(e[1] // rows == shard)
    src, dst, wk = e[0, mine], e[1, mine] - shard * rows, w[mine]
    indptr, indices, weight, _ = _csr(dst, src, wk, rows)
    indptr_t, indices_t, weight_t, _ = _csr(src, dst, wk, n_node_pad)
    return ShardedGraph(
        indptr, indices, weight, build_schedule(indptr.numpy()),
        indptr_t, indices_t, weight_t, build_schedule(indptr_t.numpy()),
        n_node=n_node, n_node_pad=n_node_pad, rows_per_shard=rows,
        n_shards=n_shards, shard=shard).to(dev)


def f32_method(method: str) -> str:
    """``method`` where it names an f32 SpMM (module docstring); raises
    otherwise."""
    if method not in ("auto", "pallas", "gather"):
        raise ValueError(f"the bespoke sharded paths compute in f32 ('auto', "
                         f"'pallas' or 'gather'), got {method!r}")
    return method


class _LocalSpMM(torch.autograd.Function):
    """``[rows_per_shard, d]`` from the gathered ``[n_node_pad, d]``; the
    backward on the transposed CSR."""

    @staticmethod
    def forward(ctx, x_all, sg, kernel):
        ctx.sg, ctx.kernel = sg, kernel
        return kernel(sg.indptr, sg.indices, sg.weight, x_all, schedule=sg.schedule)

    @staticmethod
    def backward(ctx, dy):
        sg = ctx.sg
        return ctx.kernel(sg.indptr_t, sg.indices_t, sg.weight_t, dy.contiguous(),
                          schedule=sg.schedule_t), None, None


def dist_spmm(sg: ShardedGraph, x: torch.Tensor, comm: Comm,
              method: str = "auto") -> torch.Tensor:
    """``y = A @ x`` with ``x`` and ``y`` this rank's ``[rows_per_shard, d]``
    f32 rows, ``comm`` the axis ``sg`` is sharded over; differentiable."""
    if (comm.world_size, comm.shard) != (sg.n_shards, sg.shard):
        raise ValueError(f"a graph of shard {sg.shard} of {sg.n_shards} with the "
                         f"communicator of shard {comm.shard} of {comm.world_size}")
    if x.dim() != 2 or x.shape[0] != sg.rows_per_shard:
        raise ValueError(f"x must be [{sg.rows_per_shard}, d], this rank's rows of the "
                         f"{sg.n_node_pad} padded nodes (pad_rows), got {tuple(x.shape)}")
    kernel = distgraph.ring_kernel(f32_method(method))
    return _LocalSpMM.apply(gather_rows(x.contiguous(), comm), sg, kernel)


RingShardedGraph = distgraph.DistGraph  # the ring's layout (module docstring)


def shard_graph_ring(edge_index: np.ndarray, n_node: int, comm: Comm,
                     edge_weight: Optional[np.ndarray] = None,
                     device="cuda") -> RingShardedGraph:
    """Rank ``comm.shard``'s buckets of the (dst shard, src shard) ring over
    ``round_up(n_node, S)`` rows, on ``device``."""
    dev = resolve_device(device)
    return distgraph.build_dist_graph(edge_index, n_node, comm, edge_weight,
                                      rb=1).to(dev)


def dist_spmm_ring(rg: RingShardedGraph, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` by the ring, in f32 (JAX's ``segment_sum``): the f32
    kernel a non-empty bucket; the backward the same ring on the transposed
    buckets."""
    return distgraph.dist_spmm(rg, x, "auto")


# ---------------------------------------------------------------------------
# the two-layer GCN + SE teacher and its SGD step
# ---------------------------------------------------------------------------


def xavier_uniform(rng: np.random.Generator, fan_in: int, fan_out: int) -> np.ndarray:
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def init_dist_teacher(seed: int, n_node_pad: int, n_feat: int, n_hidden: int,
                      n_class: int, has_se: Tuple[int, int] = (1, 0)
                      ) -> Dict[str, np.ndarray]:
    """The whole parameters, numpy f32, from ``seed``: xavier-uniform
    ``w0``/``w1``, zero biases, standard-normal SE tables over all
    ``n_node_pad`` rows (JAX's distributions, not its draws)."""
    rng = np.random.default_rng(seed)
    params = {"w0": xavier_uniform(rng, n_feat, n_hidden),
              "b0": np.zeros(n_hidden, np.float32),
              "w1": xavier_uniform(rng, n_hidden, n_class),
              "b1": np.zeros(n_class, np.float32)}
    for i, width in enumerate((n_hidden, n_class)):
        if has_se[i]:
            params[f"se{i}"] = rng.standard_normal((n_node_pad, width), np.float32)
    return params


def param_shardings(params: Mapping) -> Dict[str, Spec]:
    """SE tables row-sharded over ``graph``, the dense weights replicated."""
    return {k: ("graph", None) if k.startswith("se") else () for k in params}


def batch_shardings(batch: Mapping) -> Dict[str, Spec]:
    """Every node array row-sharded over ``graph``."""
    return {k: ("graph",) + (None,) * (np.ndim(v) - 1) for k, v in batch.items()}


def local_slices(arrays: Mapping[str, np.ndarray], specs: Mapping[str, Spec],
                 coords: Mapping[str, int], sizes: Mapping[str, int],
                 device="cuda") -> Dict[str, torch.Tensor]:
    """A rank's block of each whole array, on ``device``: along each
    dimension its spec names, the rank's ``coords[axis]``-th of
    ``sizes[axis]`` equal parts (``jax.device_put`` with a
    ``NamedSharding``, seen from one device)."""
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        for dim, axis in enumerate(specs[name]):
            if axis is None:
                continue
            if a.shape[dim] % sizes[axis]:
                raise ValueError(f"{name}: {a.shape[dim]} entries of dim {dim} do not "
                                 f"split over the {sizes[axis]} shards of {axis!r}")
            n = a.shape[dim] // sizes[axis]
            a = np.take(a, np.arange(coords[axis] * n, (coords[axis] + 1) * n), axis=dim)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def degree_scales(deg_out: torch.Tensor, deg_in: torch.Tensor) -> tuple:
    """``[rows, 1]`` ``clip(deg, 1) ** -0.5`` of the out- and in-degrees."""
    return (deg_out.clamp(min=1) ** -0.5)[:, None], (deg_in.clamp(min=1) ** -0.5)[:, None]


def masked_nll(logits: torch.Tensor, y: torch.Tensor, train_mask: torch.Tensor,
               comm: Comm) -> torch.Tensor:
    """The mean NLL over the global train nodes, whole on every rank: the
    numerator summed over ``comm`` differentiably, the count outside
    autograd."""
    picked = torch.log_softmax(logits, dim=1).gather(1, y.long()[:, None])[:, 0]
    m = train_mask.to(logits.dtype)
    den = comm.all_reduce_sum_(m.sum().detach())
    return -comm.all_reduce_sum((picked * m).sum()) / den.clamp(min=1.0)


def dist_teacher_loss(comm: Comm, sg: ShardedGraph, params: Mapping[str, torch.Tensor],
                      x, y, train_mask, deg_in, deg_out,
                      se_reg: float = 10.0, method: str = "auto") -> torch.Tensor:
    """The two-layer GCN + SE forward and masked NLL over this rank's rows of
    the row-sharded graph (``:299-328``), plus ``se_reg`` times the Frobenius
    norm of each SE table over all ``n_node_pad`` rows; the same value on
    every rank. ``x``, ``y``, ``train_mask`` and the degrees are the rank's
    rows."""
    out_s, in_s = degree_scales(deg_out, deg_in)
    h = (x * out_s) @ params["w0"]
    if "se0" in params:
        h = h + params["se0"]
    h = torch.relu(dist_spmm(sg, h, comm, method) * in_s + params["b0"])
    h = (h * out_s) @ params["w1"]
    if "se1" in params:
        h = h + params["se1"]
    logits = dist_spmm(sg, h, comm, method) * in_s + params["b1"]
    loss = masked_nll(logits, y, train_mask, comm)
    for name in ("se0", "se1"):
        if name in params:
            loss = loss + se_reg * torch.sqrt(comm.all_reduce_sum((params[name] ** 2).sum()))
    return loss


def sharded_grads(params: Mapping[str, torch.Tensor], loss_fn,
                  specs: Mapping[str, Spec], graph_comm: Comm) -> tuple:
    """(loss, gradients) of ``loss_fn(params)``, the loss every rank
    computes whole: each rank backpropagates it divided by the graph axis's
    size, and the gradients of the parameters replicated over ``graph`` are
    summed over it in one all-reduce."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss / graph_comm.world_size,
                                                 list(leaves.values()))))
    shared = [k for k in leaves if "graph" not in specs[k]]
    if shared:
        flat = graph_comm.all_reduce_sum_(torch.cat([grads[k].reshape(-1) for k in shared]))
        for k, part in zip(shared, flat.split([grads[k].numel() for k in shared])):
            grads[k] = part.view_as(grads[k])
    return loss.detach(), grads


def sgd(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
        lr: float) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: p.detach() - lr * grads[k] for k, p in params.items()}


def make_dist_train_step(comm: Comm, lr: float = 1e-2, se_reg: float = 10.0):
    """The SGD step over the graph axis ``comm``: ``step(params, batch, sg)``
    gives (new params, loss). ``params``: this rank's tensors
    (``param_shardings``); ``batch``: its rows of ``x``, ``y``,
    ``train_mask``, ``deg_in`` and ``deg_out``."""

    def step(params, batch, sg):
        def loss_fn(p):
            return dist_teacher_loss(comm, sg, p, batch["x"], batch["y"],
                                     batch["train_mask"], batch["deg_in"],
                                     batch["deg_out"], se_reg)

        loss, grads = sharded_grads(params, loss_fn, param_shardings(params), comm)
        return sgd(params, grads, lr), loss

    return step
