"""TeacherGNN — the Cold Brew teacher wrapper.

The port of ``gnn_tail_generalization_tpu/models/teacher.py`` (the
reference's ``GNN_model/GNN_normalizations.py:9-65``):
- num_classes is rebound to dim_commonEmb (== num_classes unless
  has_proj2class);
- optional featureless mode: x * 0 (change_to_featureless) or learnable input
  embeddings of dim_learnable_input;
- the optional proj2class head: ``MLP(TeacherGNN.neurons_proj2class)`` from
  commonEmb to the classes (``has_proj2class``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import Config
from ..graph.core import Graph
from ..nn.backbone import TricksCombBackbone
from ..nn.mlp import MLP


def backbone_from_config(cfg: Config, generator: Optional[torch.Generator],
                         model_comm=None) -> TricksCombBackbone:
    return TricksCombBackbone(
        num_feats=cfg.dim_learnable_input or cfg.num_feats,
        num_classes=cfg.dim_commonEmb,
        dim_hidden=cfg.dim_hidden,
        num_layers=cfg.num_layers,
        n_node=cfg.N_nodes,
        type_trick=cfg.type_trick,
        res_alpha=cfg.res_alpha,
        layer_agg=cfg.layer_agg,
        dropout=cfg.dropout,
        whetherHasSE=tuple(cfg.TeacherGNN.whetherHasSE),
        node_norm_type=cfg.node_norm_type,
        skip_weight=cfg.skip_weight,
        num_groups=cfg.num_groups,
        dataset=cfg.dataset,
        type_model=cfg.type_model,
        spmm_method=cfg.spmm_method,
        apply_graph_dropout=cfg.apply_graph_dropout,
        graph_dropout=cfg.graph_dropout,
        layerwise_dropout=cfg.layerwise_dropout,
        generator=generator,
        model_comm=model_comm,
    )


class TeacherGNN(nn.Module):
    """``model_comm``: the model axis of a 2-D graph x model mesh, whose
    ranks split the backbone's kernel columns (``nn/backbone.py``)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 model_comm=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone_from_config(cfg, generator, model_comm)
        if cfg.dim_learnable_input > 0:
            self.input_embs = nn.Parameter(torch.empty(
                cfg.N_nodes, cfg.dim_learnable_input))
            nn.init.normal_(self.input_embs, std=0.001, generator=generator)
        else:
            self.register_parameter("input_embs", None)
        self.proj2class = (MLP(cfg.TeacherGNN.neurons_proj2class,
                               generator=generator)
                           if cfg.has_proj2class else None)

    def forward(self, g: Graph, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                graph_generator: Optional[torch.Generator] = None,
                want_les: bool = False, g_last: Optional[Graph] = None):
        """Returns (commonEmb, emb4classi_full, se_reg_all, les). With no
        proj2class head the classifier view is commonEmb itself. Train mode
        draws dropout from ``generator`` and graph-dropout masks from
        ``graph_generator``."""
        if self.cfg.TeacherGNN.change_to_featureless:
            x = x * 0
        if self.input_embs is not None:
            x = self.input_embs
        common, se_reg_all, les = self.backbone(
            g, x, generator=generator, graph_generator=graph_generator,
            want_les=want_les, g_last=g_last)
        classi = (common if self.proj2class is None
                  else self.proj2class(common, generator=generator))
        return common, classi, se_reg_all, les
