"""Typed configuration tree with the reference's preset/override semantics.

A copy of ``gnn_tail_generalization_tpu/config.py``: the module is pure Python,
but importing it from the JAX package runs that package's ``__init__``, which
imports JAX. The tests hold ``build_config`` here equal to the original.

One dataclass replaces the reference's argparse-namespace mutation pipeline
(``base_options.py``: flags 8-171, dataset presets 186-304, LP namespaces
352-402, best-config override tables 404-438) and its derived architecture
configs (``utils.py:588-645``) — with no ``eval()`` of config strings and no
hidden post-parse mutation: each stage is an explicit function you call in
order, exactly like the reference pipeline:

    cfg = Config(dataset="Cora", train_which="TeacherGNN")
    cfg = apply_dataset_presets(cfg)
    cfg = apply_labprop_configs(cfg)
    cfg = apply_best_config(cfg)        # iff cfg.force_set_to_best_config
    cfg = apply_arch_configs(cfg)       # derived TeacherGNN/StudentMLP cfgs

or simply ``cfg = build_config(dataset="Cora", ...)`` for the whole chain.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Derived sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TeacherGNNConfig:
    """Derived teacher arch config (utils.py:595-624)."""

    lossa_semantic: float = 1.0
    lossa_structure: float = 1.0
    change_to_featureless: bool = False
    num_layers: int = 2
    whetherHasSE: Tuple[int, int, int] = (0, 0, 0)
    neurons_proj2class: Tuple[int, ...] = ()
    neurons_proj2linkp: Tuple[int, ...] = ()


@dataclass(frozen=True)
class StudentBaseMLPConfig:
    """Derived student-MLP arch config (utils.py:627-638)."""

    skip_conn_period: int = 2
    num_blocks: int = 3
    dims_in_out: Tuple[int, int] = (0, 0)
    dim_model: int = -1


@dataclass(frozen=True)
class PreStepConfig:
    """(base_options.py:360-363)"""

    num_propagations: int = 10
    p: int = 1
    alpha: float = 0.5
    pre_methods: str = "diffusion+spectral"


@dataclass(frozen=True)
class MidStepConfig:
    """(base_options.py:365-367)"""

    model: str = "mlp"
    hidden_channels: int = 256
    num_layers: int = 3


@dataclass(frozen=True)
class LPStepConfig:
    """(base_options.py:369-402)"""

    A: str = "DAD"
    num_propagations: int = 50
    alpha: float = 0.5
    fn: str = "double_correlation_autoscale"
    A1: str = "DA"
    A2: str = "AD"
    alpha1: float = 0.9791632871592579
    alpha2: float = 0.7564990804200602
    num_propagations1: int = 50
    num_propagations2: int = 50
    no_prep: bool = True


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    """Mirrors BaseOptions flags (base_options.py:17-139). Field names are
    kept identical to the reference flags so configs translate 1:1."""

    # common
    exp_mode: str = "coldbrew"
    lr: float = 0.005
    dropout: float = 0.2
    batch_size: int = 64 * 1024
    epochs: int = 1500

    # node classification / Cold Brew
    samp_size_p: int = 200
    samp_size_n_train: int = 200
    samp_size_n_test_times_p: int = 20
    dim_learnable_input: int = 0
    force_set_to_best_config: bool = True
    want_headtail: bool = True
    num_layers: int = 2
    studentMLP__skip_conn_T_and_res_blks: str = ""
    StudentMLP__dim_model: int = -1
    studentMLP__opt_lr: str = ""
    LP__which_corr_and_DAD: str = ""
    LP__num_propagations: int = -1
    LP__alpha: float = -1.0
    SEMLP_topK_2_replace: int = 2
    SEMLP__include_part1out: bool = True
    dropout_MLP: float = 0.2
    SEMLP_part1_arch: str = "2layer"  # residual | 2layer | 3layer | 4layer
    has_proj2class: bool = False
    whetherHasSE: str = "000"  # 100 | 001 | 111 | 000
    se_reg: float = 10.0
    graphMLP_reg: float = 0.0
    graphMLP_tau: float = 2.0
    graphMLP_r: int = 3
    change_to_featureless: bool = False
    do_deg_analyze: bool = True
    train_which: str = "TeacherGNN"  # TeacherGNN|SEMLP|LP|StudentBaseMLP|GraphMLP
    task: str = "nodeC"
    dataset: str = "Cora"
    use_special_split: bool = True
    optfun: str = "adam"  # adam | sgd
    random_seed: int = 100
    N_exp: int = 1
    type_model: str = "GCN"
    type_trick: str = "Initial+BatchNorm"
    layer_agg: str = "concat"  # concat | maxpool | attention | mean
    res_alpha: float = 0.1
    patience: int = 100
    weight_decay: float = 5e-4
    dim_hidden: int = 64
    transductive: bool = True
    type_norm: str = "None"
    edge_dropout: float = 0.2
    node_norm_type: str = "n"  # n | v | m | srv | pr
    skip_weight: Optional[float] = None
    num_groups: Optional[int] = None
    graph_dropout: float = 0.2
    layerwise_dropout: bool = False
    records_desc: str = ""  # training-records run name (base_options.py:63)
    records_path: str = "."
    prog: str = ""  # batch-running grid cell, e.g. "1-0-2" (base_options.py:95)
    rexName: str = "res.npy"  # batch-record file (base_options.py:96)

    # dataset-derived (reset_dataset_dependent_parameters)
    num_feats: int = 0
    num_classes: int = 0
    N_nodes: int = 0
    activation: str = "relu"

    # framework extensions (not in reference flags)
    apply_graph_dropout: bool = False
    """The reference computes DropEdge/DropNode/FastGCN/LADIES subgraphs but
    never feeds them to the conv (GNN_model/GCN.py:92-115 builds the DGL graph
    once and ignores new_adjs — SURVEY.md section 2.3). False reproduces that
    bug-compatible behavior; True actually rewires aggregation via edge-weight
    masks."""
    spmm_method: str = "auto"  # auto | dense | gather | pallas | pallas_bf16
    optimize_final_layer_agg: bool = True
    """Train-step optimization: restrict the FINAL conv's aggregation to
    rows inside the loss mask (graph/core.loss_masked_view) — the other
    output rows never reach the NLL, so dropping them leaves loss and
    gradients mathematically identical while removing up to (1 -
    train_frac) of the last layer's fwd+bwd SpMM rows. Auto-disabled by
    train/loops.py whenever anything row-coupling consumes the full
    last-layer output (edgewise loss, cross-row norms, graph dropout)."""
    final_agg_plan_rb: int = 128
    """Row-block size of the JAX package's Pallas plans; the port's CSR
    kernels have no plans and do not read it."""
    bug_compat_trainmode_headtail_eval: bool = False
    """The reference evaluates head/tail/iso inside run_trainSet with dropout
    active (trainer_node_classification.py:397-415). Default: eval mode."""
    bug_compat_part1_target_dropout: bool = False
    """collect_SE is called with the teacher still in train mode, so the SEMLP
    part-1 regression target is a single dropout sample
    (trainer_node_classification.py:87). Default: deterministic target."""

    # derived (filled by apply_* stages)
    has_loss_component_nodewise: bool = True
    has_loss_component_edgewise: bool = False
    dim_commonEmb: int = 0
    num_feats_bkup: int = 0
    num_classes_bkup: int = 0
    embDim_linkp: int = 10
    SEMLP__downgrade_to_MLP: bool = False
    best_config_performance: Optional[float] = None
    TeacherGNN: TeacherGNNConfig = field(default_factory=TeacherGNNConfig)
    StudentBaseMLP: StudentBaseMLPConfig = field(
        default_factory=StudentBaseMLPConfig
    )
    preStep: PreStepConfig = field(default_factory=PreStepConfig)
    midStep: MidStepConfig = field(default_factory=MidStepConfig)
    lpStep: LPStepConfig = field(default_factory=LPStepConfig)


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------

#: (num_feats, num_classes, N_nodes, dropout, weight_decay, patience,
#:  dim_hidden, res_alpha) — base_options.py:186-304
_DATASET_PRESETS = {
    "Cora": dict(num_feats=1433, num_classes=7, N_nodes=2708, dropout=0.6,
                 weight_decay=5e-4, patience=100, dim_hidden=64),
    "Pubmed": dict(num_feats=500, num_classes=3, N_nodes=19717, dropout=0.5,
                   weight_decay=5e-4, patience=100, dim_hidden=256),
    "Citeseer": dict(num_feats=3703, num_classes=6, N_nodes=3327, dropout=0.6,
                     weight_decay=5e-4, patience=100, dim_hidden=256,
                     res_alpha=0.2),
    "ogbn-arxiv": dict(num_feats=128, num_classes=40, N_nodes=169343,
                       dropout=0.1, weight_decay=0.0, patience=200,
                       dim_hidden=256),
    "chameleon": dict(num_feats=128, num_classes=6, N_nodes=2277, dropout=0.5,
                      weight_decay=5e-4, dim_hidden=256),
    "squirrel": dict(num_feats=128, num_classes=5, N_nodes=5201, dropout=0.5,
                     weight_decay=5e-4, dim_hidden=256),
    "TEXAS": dict(num_feats=1703, num_classes=5, N_nodes=183, dropout=0.6,
                  weight_decay=5e-4, patience=100, dim_hidden=256,
                  res_alpha=0.9),
    "WISCONSIN": dict(num_feats=1703, num_classes=5, N_nodes=251, dropout=0.6,
                      weight_decay=5e-4, patience=100, dim_hidden=256,
                      res_alpha=0.9),
    "CORNELL": dict(num_feats=1703, num_classes=5, N_nodes=183, dropout=0.0,
                    weight_decay=5e-4, patience=100, dim_hidden=256,
                    res_alpha=0.9),
    "ACTOR": dict(num_feats=932, num_classes=5, N_nodes=7600, dropout=0.0,
                  weight_decay=5e-4, patience=100, dim_hidden=256,
                  res_alpha=0.9),
}


def apply_dataset_presets(cfg: Config) -> Config:
    """base_options.py:186-304."""
    preset = _DATASET_PRESETS.get(cfg.dataset)
    if preset is None:
        return cfg
    return dataclasses.replace(cfg, **preset)


def apply_labprop_configs(cfg: Config) -> Config:
    """base_options.py:352-402 (set_labprop_configs)."""
    kw = {}
    if cfg.LP__which_corr_and_DAD:
        kw["A"] = cfg.LP__which_corr_and_DAD
    if cfg.LP__num_propagations != -1:
        kw["num_propagations"] = cfg.LP__num_propagations
    if cfg.LP__alpha != -1.0:
        kw["alpha"] = cfg.LP__alpha
    lp = LPStepConfig(**kw)
    return dataclasses.replace(
        cfg, preStep=PreStepConfig(), midStep=MidStepConfig(), lpStep=lp
    )


#: per-dataset best teacher trick combo — base_options.py:404-421
_D2I = {"Cora": 0, "Citeseer": 1, "Pubmed": 2, "ogbn-arxiv": 3, "chameleon": 4,
        "ACTOR": 5, "squirrel": 6, "WISCONSIN": 7, "CORNELL": 8, "TEXAS": 9}
_BEST_PERF = [86.9639468690702, 72.44, 75.96000000000001, 71.5367364154476,
              68.50877192982458, 31.947368421052637, 59.78866474543709,
              65.09803921568627, 61.08108108108108, 81.62162162162163]
_RES_NAMES = ("NoRes", "Initial", "Dense", "Residual")
_NORM_NAMES = ("NoNorm", "GroupNorm", "BatchNorm", "PairNorm", "NodeNorm")
_BEST_TEACHER = [(0, 0, 4), (0, 0, 1), (4, 1, 2), (2, 1, 2), (1, 1, 3),
                 (0, 0, 2), (0, 1, 4), (1, 3, 0), (2, 3, 3), (2, 3, 1)]
_MLP_ARR1 = ("2&1", "2&4", "2&16", "2&32", "4&2", "4&8")
_MLP_ARR2 = (128, 256)
_BEST_MLP = [(0, 1, 0), (0, 0, 0), (1, 0, 3), (1, 1, 0), (2, 0, 0),
             (0, 1, 2), (2, 1, 2), (0, 1, 0), (0, 1, 3), (0, 0, 2)]


def apply_best_config(cfg: Config) -> Config:
    """base_options.py:404-438 (force_set_to_best_config). Note the reference
    only overrides type_trick (its x1 num-layers lookup is computed but never
    assigned) and pins studentMLP opt to Adam&0.005 regardless of table."""
    if cfg.dataset not in _D2I:
        return cfg
    i = _D2I[cfg.dataset]
    updates = {}
    if cfg.train_which in ("SEMLP", "StudentBaseMLP", "TeacherGNN"):
        res_i, norm_i = _BEST_TEACHER[i][1], _BEST_TEACHER[i][2]
        updates["type_trick"] = _RES_NAMES[res_i] + _NORM_NAMES[norm_i]
        updates["best_config_performance"] = _BEST_PERF[i]
    if cfg.train_which in ("SEMLP", "StudentBaseMLP"):
        mi = _BEST_MLP[i]
        updates["studentMLP__skip_conn_T_and_res_blks"] = _MLP_ARR1[mi[0]]
        updates["StudentMLP__dim_model"] = _MLP_ARR2[mi[1]]
        updates["studentMLP__opt_lr"] = "adam&0.005"
    return dataclasses.replace(cfg, **updates)


_SE_PATTERNS = {"111": (1, 1, 1), "000": (0, 0, 0), "001": (0, 0, 1),
                "100": (1, 0, 0)}


def apply_arch_configs(cfg: Config) -> Config:
    """utils.py:588-645 (set_arch_configs)."""
    updates = {}
    updates["SEMLP__downgrade_to_MLP"] = cfg.SEMLP_topK_2_replace == -99
    updates["activation"] = "gelu"  # utils.py:592 picks gelu

    se = _SE_PATTERNS.get(cfg.whetherHasSE)
    if se is None:
        raise NotImplementedError(f"whetherHasSE={cfg.whetherHasSE}")

    dim_commonEmb = 128 if cfg.has_proj2class else cfg.num_classes
    updates["dim_commonEmb"] = dim_commonEmb
    updates["num_feats_bkup"] = cfg.num_feats
    updates["num_classes_bkup"] = cfg.num_classes

    teacher = TeacherGNNConfig(
        lossa_semantic=1.0,
        lossa_structure=1.0,
        change_to_featureless=bool(cfg.change_to_featureless),
        num_layers=cfg.num_layers,
        whetherHasSE=se,
        neurons_proj2class=(dim_commonEmb, 20, cfg.num_classes),
        neurons_proj2linkp=(dim_commonEmb, 32),
    )
    updates["TeacherGNN"] = teacher

    if cfg.studentMLP__skip_conn_T_and_res_blks:
        skip, blocks = cfg.studentMLP__skip_conn_T_and_res_blks.split("&")
        skip, blocks = int(skip), int(blocks)
    else:
        skip, blocks = 2, 3
    updates["StudentBaseMLP"] = StudentBaseMLPConfig(
        skip_conn_period=skip,
        num_blocks=blocks,
        dims_in_out=(cfg.num_feats, cfg.num_classes),
        dim_model=cfg.StudentMLP__dim_model,
    )

    if cfg.studentMLP__opt_lr:
        opt, lr = cfg.studentMLP__opt_lr.split("&")
        updates["optfun"] = opt.replace("torch.optim.", "").lower()
        updates["lr"] = float(lr)

    if cfg.exp_mode == "coldbrew":
        updates["has_loss_component_nodewise"] = True
        updates["has_loss_component_edgewise"] = False
    elif cfg.exp_mode == "I2_GTL":
        updates["has_loss_component_nodewise"] = False
        updates["has_loss_component_edgewise"] = True

    return dataclasses.replace(cfg, **updates)


def build_config(**kwargs) -> Config:
    """Full pipeline: Config(...) -> presets -> labprop -> best -> arch."""
    cfg = Config(**kwargs)
    cfg = apply_dataset_presets(cfg)
    cfg = apply_labprop_configs(cfg)
    if cfg.force_set_to_best_config:
        cfg = apply_best_config(cfg)
    cfg = apply_arch_configs(cfg)
    return cfg
