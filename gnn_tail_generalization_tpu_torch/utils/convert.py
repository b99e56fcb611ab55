"""Parameters of the JAX package's models as the port's state_dicts.

``flat`` maps the '/'-joined paths of a flax ``params`` tree, and of its
``batch_stats`` where the model has batch norms (as
``flax.traverse_util.flatten_dict(tree, sep="/")`` gives them, with or
without the collection's name in front), to numpy arrays, e.g.
``backbone/conv_0/kernel``, ``MLP_0/Dense_1/bias`` or
``backbone/norm_0/BatchNorm_0/mean``. Each path is walked down the port's
module alongside: every flax submodule name maps to one submodule of the
port (``_child``). At the leaf, a flax ``Dense`` kernel ``[in, out]`` becomes
a ``Linear.weight`` ``[out, in]``, a ``LayerNorm`` or ``BatchNorm``
``scale`` becomes its ``weight``, a ``BatchNorm``'s ``mean`` and ``var``
become its ``running_mean`` and ``running_var`` buffers, the conv kernel
keeps its ``[in, out]`` layout, and a parameter of the module itself
(``alphas``, ``input_embs``, GIN's ``eps``, the NTN's ``w``/``v``/``b``, the
layer mixtures' ``link_psi`` ...) keeps its name and layout.

The bespoke sharded teachers of ``parallel/distributed.py`` and
``parallel/tensor_parallel.py`` keep plain dicts of tensors by the JAX
names; ``dist_teacher_params`` and ``teacher_2d_params`` cut a rank's blocks
from the whole dicts (the JAX package's ``init_dist_teacher`` /
``init_2d_teacher`` as numpy, or the port's, which have the same layout).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..baselines import dgi as bl_dgi
from ..baselines import egi as bl_egi
from ..baselines import encoders as bl_enc
from ..baselines import mi as bl_mi
from ..baselines import pretrain_gin as bl_gin
from ..baselines import structure_pretrain as bl_sp
from ..baselines import vgae as bl_vgae
from ..config import Config
from ..linkpred import encoders as lp_enc
from ..linkpred import predictors as lp_pred
from ..linkpred.model import LinkPredConfig, LinkPredModel
from ..models.semlp import GraphMLP, SEMLPPart1, SEMLPPart2, StudentBaseMLP
from ..models.teacher import TeacherGNN
from ..nn.backbone import TricksCombBackbone
from ..nn.gcn import GCNConv
from ..nn.mlp import MLP, BlockResMLP
from ..nn.norms import BatchNorm, GroupNorm, NormLayer
from ..nn.residual import DenseConnection
from ..parallel.comm import Comm
from ..parallel.distgraph import shard_state_dict, slice_model_cols
from ..parallel.distributed import local_slices, param_shardings
from ..parallel.tensor_parallel import param_shardings_2d
from ..propagation.cs import CSLinear, CSMLp

# leaf name -> (port parameter name, transpose?)
_LEAVES = (
    (GCNConv, {"kernel": ("weight", False), "se": ("se", False),
               "bias": ("bias", False)}),
    (nn.Linear, {"kernel": ("weight", True), "bias": ("bias", False)}),
    (nn.LayerNorm, {"scale": ("weight", False), "bias": ("bias", False)}),
    (BatchNorm, {"scale": ("weight", False), "bias": ("bias", False),
                 "mean": ("running_mean", False), "var": ("running_var", False)}),
)


def _child(module: nn.Module, name: str) -> Optional[str]:
    """The port attribute under ``module`` that holds the flax submodule
    ``name``, or None."""
    m = re.fullmatch(r"(\w+?)_(\d+)", name)
    kind, i = (m.group(1), int(m.group(2))) if m else (name, None)
    if isinstance(module, TeacherGNN) and name in ("backbone", "proj2class"):
        return name
    if isinstance(module, TricksCombBackbone):
        return {"conv": f"convs.{i}", "Dense": "input_dense" if i == 0 else None,
                "out_mlp": "out_mlp", "norm": f"norms.{i}",
                "dense_agg": f"dense_aggs.{i}",
                "jumping_agg": "jumping_agg"}.get(kind)
    if isinstance(module, NormLayer):
        return {"BatchNorm_0": "bn", "GroupNorm_0": "group"}.get(name)
    if isinstance(module, GroupNorm):
        return {"Dense_0": "score", "BatchNorm_0": "bn"}.get(name)
    if isinstance(module, (DenseConnection, CSLinear)):
        return "lin" if name == "Dense_0" else None
    if isinstance(module, CSMLp):
        return {"Dense": f"lins.{i}", "BatchNorm": f"bns.{i}"}.get(kind)
    if isinstance(module, MLP):
        return {"Dense": f"dense.{i}", "LayerNorm": f"norms.{i}"}.get(kind)
    if isinstance(module, BlockResMLP):
        if kind == "MLP":
            return f"blocks.{i}"
        if kind == "Dense":  # flax numbers the projections that exist
            projs = [p for p in ("in_proj", "out_proj")
                     if getattr(module, p) is not None]
            return projs[i] if i < len(projs) else None
        return None
    if isinstance(module, (SEMLPPart1, SEMLPPart2, StudentBaseMLP)):
        return "net" if name in ("MLP_0", "BlockResMLP_0") else None
    if isinstance(module, GraphMLP):
        return {"MLP_0": "mlp", "Dense_0": "out"}.get(name)
    if isinstance(module, LinkPredModel):
        return name if name in ("encoder", "predictor") else None
    if isinstance(module, lp_enc.GNNEncoder):
        return f"layers.{i}"  # SAGEConv_i, GCNConvRaw_i, ..., or Dense_i
    if isinstance(module, lp_enc.SAGEConv):  # and WSAGEConv
        return {"Dense_0": "root", "Dense_1": "neigh"}.get(name)
    if isinstance(module, lp_enc.GCNConvRaw):
        return "lin" if name == "Dense_0" else None
    if isinstance(module, lp_enc.TransformerConv):
        return {"Dense_0": "query", "Dense_1": "key", "Dense_2": "value",
                "Dense_3": "skip"}.get(name)
    if isinstance(module, (lp_pred.BilinearPredictor, lp_pred._Tower)):
        return f"dense.{i}" if kind == "Dense" else None
    if isinstance(module, _BASELINE_SETUP):
        # submodules named in flax's setup keep their names; a list built
        # there is numbered (layers_0, cent_decoders_1)
        return name if i is None else f"{kind}.{i}"
    if isinstance(module, bl_enc.GINEncoder):
        return f"layers.{i}" if kind == "GINLayer" else None
    if isinstance(module, bl_enc.GINLayer):
        return {"Dense_0": "dense.0", "Dense_1": "dense.1", "BatchNorm_0": "bn"}.get(name)
    if isinstance(module, (bl_enc.MeanSAGELayer, bl_enc.GCNSAGELayer)):
        return "lin" if name == "Dense_0" else None
    if isinstance(module, bl_sp.NTNDecoder):
        return {"NeuralTensorLayer_0": "ntn", "Dense_0": "out"}.get(name)
    if isinstance(module, bl_mi.Mine):
        return f"dense.{i}" if kind == "Dense" else None
    return None


#: the baselines' modules whose flax submodules are named in ``setup`` or
#: by ``name=`` (SubGDiscriminator's fc_x, fc_m, linear, U_s)
_BASELINE_SETUP = (bl_dgi.DGI, bl_egi.EGI, bl_egi.SubGDiscriminator, bl_vgae.VGAE,
                   bl_gin.MaskingGIN, bl_gin.ContextPredGIN,
                   bl_sp.StructFeatPretrain)


def _port_name(module: nn.Module, parts) -> Tuple[str, bool]:
    head, rest = parts[0], parts[1:]
    if not rest:
        for cls, leaves in _LEAVES:
            if isinstance(module, cls) and head in leaves:
                return leaves[head]
        if head in dict(module.named_parameters(recurse=False)):
            return head, False
        if head in dict(module.named_buffers(recurse=False)):
            return head, False
        raise KeyError(head)
    attr = _child(module, head)
    sub = module.get_submodule(attr) if attr else None
    if not isinstance(sub, nn.Module):
        raise KeyError(head)
    name, transpose = _port_name(sub, rest)
    return f"{attr}.{name}", transpose


def state_dict_from_flax(flat: Mapping[str, np.ndarray], module: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's ``module`` holding the flax parameters
    and batch statistics ``flat``. Raises if a parameter or buffer is
    missing, extra or of the wrong shape."""
    out = {}
    for path, arr in flat.items():
        path = path.removeprefix("params/").removeprefix("batch_stats/")
        try:
            name, transpose = _port_name(module, path.split("/"))
        except (KeyError, AttributeError):
            raise KeyError(f"no port parameter for flax path {path!r}") from None
        a = np.asarray(arr, np.float32)
        out[name] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != expected:
        raise ValueError(f"flax variables do not fit the port's module: "
                         f"missing {sorted(expected.keys() - got.keys())}, "
                         f"extra {sorted(got.keys() - expected.keys())}, "
                         f"shapes {[(k, got[k], expected[k]) for k in got.keys() & expected.keys() if got[k] != expected[k]]}")
    return out


def params_from_jax(flat: Mapping[str, np.ndarray], cfg: Config,
                    batch_stats: Optional[Mapping[str, np.ndarray]] = None, *,
                    shard: int = 0, n_shards: int = 1, model_shard: int = 0,
                    n_model: int = 1) -> Dict[str, torch.Tensor]:
    """The state_dict of ``TeacherGNN(cfg)`` holding the flax parameters and,
    where the model has batch norms, the flax ``batch_stats`` (flat, as
    ``flat``) in their running-statistics buffers.

    ``n_shards`` > 1: the parameters of the JAX package's sharded run
    (``cfg.N_nodes`` its ``n_node_pad``) as rank ``shard``'s state: rows
    ``shard * R`` to ``(shard + 1) * R`` of the SE tables (and learnable
    inputs), everything else whole (``parallel/distgraph.py:
    shard_state_dict``); a rank of the two-level layout takes its rows as a
    1-D rank of ``S = H * C`` shards (shard ``h * C + c``).

    ``n_model`` > 1: a rank of the 2-D graph x model mesh (``shard`` its
    graph coordinate), which also takes model shard ``model_shard``'s
    columns of the column-parallel kernels and SE tables
    (``parallel/distgraph.py:slice_model_cols``)."""
    flat = {**flat, **(batch_stats or {})}
    with torch.device("meta"):  # names and shapes only, no memory
        model = TeacherGNN(cfg)
    state = state_dict_from_flax(flat, model)
    if n_shards > 1:
        state = shard_state_dict(state, shard, n_shards)
    if n_model > 1:
        with torch.device("meta"):
            rank = TeacherGNN(dataclasses.replace(cfg, N_nodes=cfg.N_nodes // n_shards),
                              model_comm=Comm(model_shard, n_model, "cpu", "gloo"))
        state = slice_model_cols(state, {k: v.shape for k, v in rank.state_dict().items()},
                                 model_shard)
    return state


def linkpred_params_from_jax(flat: Mapping[str, np.ndarray],
                             cfg: LinkPredConfig, n_node: int,
                             num_node_feats: int) -> Dict[str, torch.Tensor]:
    """The state_dict of ``LinkPredModel(cfg, n_node, num_node_feats)``
    holding the flax ``LinkPredModel`` parameters ``flat`` (every encoder
    kind and predictor, with or without ``node_emb``)."""
    with torch.device("meta"):
        model = LinkPredModel(cfg, n_node, num_node_feats)
    return state_dict_from_flax(flat, model)


def baseline_params_from_jax(flat: Mapping[str, np.ndarray], module: nn.Module
                             ) -> Dict[str, torch.Tensor]:
    """The state_dict of a baseline ``module`` of the port (``DGI``, ``EGI``,
    ``VGAE``, ``MaskingGIN``, ``ContextPredGIN``, ``StructFeatPretrain``,
    ``Mine``, or one of their parts) holding the flax parameters and batch
    statistics ``flat`` of its JAX counterpart."""
    return state_dict_from_flax(flat, module)


def _f32(params: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def dist_teacher_params(params: Mapping[str, np.ndarray], shard: int, n_shards: int,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Rank ``shard``'s tensors of the 1-D teacher's whole parameters: its
    rows of the SE tables, the dense weights whole (``param_shardings``)."""
    return local_slices(_f32(params), param_shardings(params), {"graph": shard},
                        {"graph": n_shards}, device)


def teacher_2d_params(params: Mapping[str, np.ndarray], coords: Mapping[str, int],
                      sizes: Mapping[str, int], device="cuda") -> Dict[str, torch.Tensor]:
    """The tensors of the 2-D teacher's rank at ``coords`` of a mesh of
    ``sizes`` (``DeviceMesh.coords`` and ``.shape``): its column slices of
    ``w0``, ``b0``, its rows and columns of ``se0``, its row slice of ``w1``
    and ``b1`` whole (``param_shardings_2d``)."""
    return local_slices(_f32(params), param_shardings_2d(params), coords, sizes, device)
