"""Drive the PyTorch port's teacher, trick zoo, Cold Brew student, label
propagation, link-prediction, self-supervised baseline, row-sharded (the
teacher, the students, LP and C&S, link prediction), two-axis (host x
card, graph x model), edge label propagation and bespoke sharded-teacher
(all-gather SpMM, 1-D and 2-D SGD) paths, its host library, its two
bench scripts and its profiler, on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   and the build of the CUDA kernels (``gnn_tail_generalization_tpu_torch/
   csrc/*.cu``, built into ``gnn_tail_generalization_tpu_torch/_build/``)
   and of the host library (``native/graph_prep.cpp``, by g++, into the
   same directory);
2. each kernel against its plain PyTorch version on the card, on each CSR's
   row schedule: the bench-shape power-law graph (169,343 nodes, 2,501,571
   edges after the loader pipeline), forward and transposed CSR, d=256 and
   d=40, the slice's own graphs at d=256, a hub-row case at d=16, a
   degree-boundary graph (rows of in-degree 0, T - 1, T, T + 1 and 2T + 1,
   T the hub threshold) at d=256, 40, 16 and 33 (vector width 1), and a star
   graph (one row of 1,000,000 in-edges) at d=256 and 40, forward and
   transposed; max |kernel - plain| / max |plain| must be <= 1e-5
   (identical operands, only the summation order differs). Each case prints
   the kernel, plain and ``library_ms`` times (median of CUDA-event timed
   runs; ``library_ms`` is ``torch.sparse.mm`` of a CSR tensor, cuSPARSE,
   which the port never calls), ``bound_ms``
   (``ops/spmm_kernels.py:spmm_bound``) and the kernel's share of it. Two
   launches must be bit-identical in every case, and a call without a
   schedule (built from ``indptr``) must equal one with. Every check of a
   kernel against its plain version (here, phase 4 (ii)'s and phase 7
   (i)'s) shares ``kernel_vs_plain``'s steps, and every launch count is
   ``ops/_build.py:LAUNCHES``, reset before each run it counts;
3. the slice: the port's ``main`` on ogbn-arxiv's shape (synthetic stand-in,
   169,343 nodes, 128 features, hidden 256, 40 classes), 3 epochs, once with
   ``--spmm_method=auto`` (f32 kernel) and once with ``pallas_bf16`` (bf16
   kernel). Each run's records must be finite, its kernel's launch count must
   grow and the plain version's must not. One step at dropout 0 from fixed
   weights through the f32 kernel must match the same step through the plain
   version within 1e-5 relative, in loss and every gradient;
4. the student: (i) the port's ``main`` with ``--train_which=SEMLP`` at the
   same shape (teacher with SE on every layer, its [169343, 512] SE table,
   part 1, part 2), 3 epochs a phase: finite records with the columns
   ``loss_train, acc_test, head, tail, iso``, and the f32 kernel launched
   for exactly the teacher's steps plus the SE-table forward, the bf16
   kernel and the plain version never, and the top-K kernel once a row
   chunk of each replacement; (ii) ``latent_neighbor_replace`` on
   the card against a float64 CPU evaluation of 512 rows of that run's own
   queries and SE table (the same selected neighbours, output within 1e-5
   relative), and its time at B = 65,536 rows, the real arxiv batch; the
   top-K kernel (``csrc/topk_select.cu``) against its plain version, values
   and indices bit for bit, on one [8192, 169343] score chunk of that run
   (the kernel's, the plain version's and ``torch.topk``'s ms, the bound and
   the share) and on ``topk_cases`` (K in 1, 2, 3, 8, 32, odd widths and
   unaligned rows, exact ties across the K-th place, -inf columns, the
   sharded merge's narrow shape, +-0.0 and NaN);
   (iii) StudentBaseMLP at the arxiv shape and GraphMLP on the Cora
   stand-in (dense A^r), 3 epochs each, finite, with no SpMM launch;
   (iv) the step and eval times of each phase;
5. the trick zoo: the port's ``main`` at the arxiv shape with
   ``--force_set_to_best_config=0``, 3 epochs, for BatchNorm, GroupNorm (the
   arxiv preset: 10 groups, a [169343, 2560] block per layer), PairNorm,
   DenseNoNorm with attention, Jumping, and graph dropout (DropEdge, LADIES,
   FastGCN under ``pallas_bf16``). Finite records, and launch counts as the
   rule predicts: per epoch 2 SpMMs a layer for the train step (on masked,
   plan-less graphs under graph dropout: the f32 kernel) and 1 a layer for
   the eval forward (the full graph: the kernel of the method). One step at
   dropout 0 through the f32 kernel against the plain version (1e-5
   relative, loss and every gradient) for GroupNorm and LADIES, both drawing
   the same masks;
6. propagation: ``--train_which=LP`` through ``main`` (a finite JSON line,
   the f32 kernel launched once per propagation), its [169343, 40]
   propagation against the plain version (1e-5 relative); then
   ``run_cs_pipeline`` with diffusion features and 5 mid-step epochs (the
   f32 kernel launched num_propagations1 + num_propagations2 times), and
   ``lp_step`` against the plain version (1e-5 relative); the ms of both
   and of one propagation;
7. link prediction at the ogbl-citation2 shape (``bench_linkpred.py``'s
   graph: 2,927,963 nodes, a power-law graph of 15.2M edges, 8,192 valid
   and 8,192 test positives with 50 sampled negatives each, message edges
   the symmetrized rest, ~30.4M; 128 features drawn on the card), with the
   host build's seconds and the maximum in-degree: (i) both kernels against
   the plain version on that graph at d=256, and the attention rows' kernel
   (``edge_attn_rows``, softmax and grad mode, on N(0, 1) operands) against
   its plain version there, within ``REL_TOL`` of the largest entry, two
   launches bit-identical, with its ms, the plain version's, the bound and
   the share; the pair-scoring kernel (``pair_dot``, ``csrc/pair_score.cu``)
   on the evaluation cell's valid split (86,596 positives, each source on
   1,000 uniform negative destinations, over an N(0, 1) [2,927,963, 256]
   table) against its plain version, within 1e-6 of the largest |score|,
   two launches bit-identical, with its ms, the plain version's, the bound
   (bytes: a destination row, 16 bytes of indices and a 4-byte score a
   pair, a source row a run of pairs that share it) and the share;
   (ii) the JAX package's bench
   config (SAGE + DOT, ``ce_loss``, features, no embedding, batch 65,536,
   3 negatives, ``pallas_bf16``) through ``train_linkpred``, 2 epochs of 8
   steps, the bf16 kernel launched exactly 1 + 2 per step + 1 per eval and
   the pair-scoring kernel 4 per eval (its ``mrr`` scores the valid and test
   positives and negatives), nothing else, a finite MRR; (iii) its 16-step
   epoch and the warm 1000-negative OGB eval (the pair-scoring kernel 2 an
   eval), timed; (iv) the default ``LinkPredConfig()`` (a
   trainable [n, 256] embedding, the f32 kernel 4 per step + 2 per eval,
   and the pair-scoring kernel once a scored split: 5 an eval under its
   ``recall_my@1.25``, which also scores the train positives);
   (v) one step of each at dropout 0 through the kernels against the plain
   versions, loss and every gradient within the larger of 1e-5 and 4x the
   plain step's own sum-order floor, the largest over three reorderings
   (the kernels sum in another order than the plain version, so no step is
   expected to be bit-identical); (vi) GCN (the f32 kernel) and the
   Transformer (B1 8 a step and 2 an eval encode, the attention rows'
   kernels 4 a step and 2 an eval encode; each the pair-scoring kernel 5 an
   eval) at the bench shape; (vii) ``--exp_mode=I2_GTL --task=linkp``
   through ``main`` (the 2,000-node stand-in, dense, no SpMM launch; the
   pair-scoring kernel 5 an eval, 10 evals);
8. the rest of the single-device CLI: (i) a full-size fake ogbn-arxiv raw
   set (169,343 nodes, 1,166,243 edges, 128 features, 40 classes) written to
   a directory under ``_chip/``, read through ``load_dataset`` (the reader
   must fire, not the stand-in), prepared, and trained 3 epochs through
   ``main --data_root`` under ``auto``, with the write, read and prepare
   seconds and exactly 6 f32 launches an epoch; (ii) ``--exp_mode=I2_GTL
   --task=nodeC`` on the arxiv slice under ``auto`` and ``pallas_bf16``, 3
   epochs: exactly 2 + 1 launches a layer an epoch of the method's kernel
   (no loss-masked view under the edgewise loss), MRR columns in (0, 1],
   step ms beside phase 3's, and one step through the f32 kernel against
   the plain version with fixed pairs at dropout 0 (loss and every
   gradient, ``check_step_parity``'s rule with the sum-order floor);
   (iii) ``spmm_edge_grad`` on the bench-shape graph at d=256: y, dx and dw
   against the plain version (1e-5 relative) and forward + backward ms;
   (iv) ``--N_exp=3`` through ``main`` (``train/multiseed.py``): each seed's
   records bit-identical to ``train_teacher`` from that seed; (v) a
   ``save_dir`` checkpoint read back onto the card gives a bit-identical
   eval forward, and a ``--prog`` run repeated skips its done cell.

9. the self-supervised baselines (``baselines/``): (i) ``gen_baseline_embs``
   for DGI, EGI and VGAE on phase 7's message edges at the API's defaults
   (hidden 64, degree one-hot features, 50 epochs, patience 20): finite
   [N, 64] ([N, 32] for VGAE) embeddings, the f32 kernel launched exactly
   as derived from the epochs run (``expected_baseline_launches``), the
   bf16 kernel and the plain version never; per algorithm the median epoch
   ms, the host seconds of the pipeline, build and flow sampling, and the
   peak GiB; (ii) the f32 kernel against the plain version on that graph
   at d=64 and 32, and one step each of DGI (fixed perm), EGI (fixed perm
   and flows) and VGAE (fixed batch and noise) from fixed weights through
   the kernel against the plain version (``baseline_parity``, the rule of
   ``lp_parity``); (iii) at the bench shape, ``train_pretrain_gin`` for
   ``masking`` and ``contextpred`` (128 centres), 50 epochs each, and one
   ``StructFeatPretrain`` loss and backward on a 30%-edge-masked graph:
   finite, with their launch counts; (iv) ``egi_bound`` between the bench
   and the citation2 graphs (64 pairs), with its host seconds.
10. the row-sharded teacher (``parallel/``): (i) phase 2's bench graph in 4
   row shards built in this process: every bucket's kernel against the
   plain version, forward and transposed, at d=256 f32 and bf16 (1e-5
   relative), and each shard's ring-order sum of its buckets against the
   one-device kernel's rows; (ii) ranks started by ``parallel/launch.py``
   on phase 3's slice, padded to 169,472 rows for every S (``rb = 512 /
   S``), dropout 0, 3 epochs of each of ``DIST_RUNS`` (``auto``, and
   ``pallas_bf16`` from two seeds): S = 1 (one rank, no collectives), then
   S = 2 over NCCL when there are two cards, else two ranks on the one card
   over the host-staged gloo transport (the line names it). Each rank's
   launch counts must equal ``expected_dist_launches`` (one launch a
   non-empty bucket a SpMM), the replicated parameters and the records
   must be bit-equal across the ranks, and the records across S within
   1e-4 relative / 1e-3 absolute under ``auto``; under ``pallas_bf16`` the
   loss within 1e-4 and each accuracy column within ``DIST_BF16_FLIPS``
   nodes (the bf16 rounding of each layer's operands turns a sum-order
   change into an argmax change on near ties). At S = 2 also one step
   through the kernels against the plain versions (1e-5), and 2 epochs of
   DropEdge and of the I2-GTL teacher (finite, MRRs in (0, 1]). Printed:
   the step ms for each S, the ring ms of one d=256 SpMM and the all-reduce
   ms of the replicated gradient at S = 2 with the transport named, and
   ``comm_volume_stats``' bytes per SpMM; (iii) ``main --n_devices=2`` on
   the card.
11. the sharded students, LP and C&S, and link prediction: first
   ``train_linkpred(comm=...)`` at S = 1 (one rank in this process, no
   collective) on phase 7's citation2 split with phase 7 (ii)'s bench
   config, 2 epochs of 8 steps: the host bucket build's seconds, exactly
   phase 7's 34 bf16 launches, and the step ms beside phase 7's one-device
   step. Then, at S = 1 (in this process) and at S = 2 (ranks started by
   ``parallel/launch.py``; over NCCL with two cards, else two ranks on the
   one card over host-staged gloo), on phase 3's slice padded to 169,472
   rows: (ii) ``run_experiment`` for each of ``STUDENT_DIST_RUNS`` (SEMLP
   under ``auto`` and ``pallas_bf16``: the teacher at dropout 0, the SE
   table, part 1, part 2; StudentBaseMLP; GraphMLP, which crops A^2 on the
   host; LP under both methods), 2 epochs a phase, each rank's launches
   equal to ``student_dist_launches`` (one a non-empty bucket a ring), the
   records and replicated parameters bit-equal across the ranks, and the
   records across S: losses within 1e-4 relative / 1e-3 absolute,
   accuracies equal under ``auto`` and within ``DIST_BF16_FLIPS`` nodes
   under ``pallas_bf16``; (i) ``dist_latent_replace`` at B = 65,536 against
   the run's [169343, 512] SE table, gathered, held to the one-device op
   (1e-5 relative a row, or a tie at the K-th place), its ms a call, and
   one call recorded: a top-K launch a row chunk plus the merge's, and no
   read back to the host;
   (iii) a sharded LP run (50 propagations) and the C&S stage pair on
   sharded DA / AD adjacencies, kernels against ``plain_kernels()`` (1e-5);
   (iv) the bench-shape graph with citation2's widths (128 features, hidden
   256) in f32 at dropout 0 through ``train_linkpred(comm=...)``, 2 epochs
   of ``LINK_STEPS`` steps and a 1,024-positive eval split: exact launch
   counts, the stats across S within 1e-4, the epoch seconds, and one
   sharded step through the kernels against the plain versions within the
   larger of 1e-5 and 4x the plain step's own sum-order floor (the plain
   step on the one-device graph). Phase 11's seconds are printed.
12. the two-axis layouts: (i) in this process, both kernels against the
   plain version (1e-5 relative) on an intra bucket of the two-level (host
   2 x card 2) layout, a cross bucket fed the halo host 1 ships to host 0,
   and a bucket of the 2-D (graph 2 x model 2) mesh at width 128 and 20 (a
   model shard's columns of d = 256 and of 40 classes), with the ms of
   each, and each slice's launch bit-equal to those columns of the launch
   at the whole width (a column's sum follows the schedule alone); then
   four ranks started by ``parallel/launch.py`` (over NCCL with
   four cards, else four ranks on the one card over host-staged gloo; the
   line names it) on phase 3's slice padded to phase 10's 169,472 rows (rb
   128 on the host x card mesh, 256 on the graph axis), dropout 0: (ii) the
   teacher on each layout in each of ``DIST_RUNS``, 2 epochs,
   each rank's launches equal to the rule (``hier_launches``: one a
   non-empty intra or cross bucket a SpMM; ``expected_dist_launches`` on the
   graph axis), the records bit-equal across ranks and held to phase 10's
   S = 1 records by phase 10's rules (under ``pallas_bf16`` the accuracy
   columns within ``DIST_BF16_FLIPS`` nodes; the nodes moved against phase
   10's S = 2 records, the 2-D mesh's graph cut, are printed beside them),
   whole parameters bit-equal on every rank and each column slice on the
   ranks of its model shard; (iii) one
   hier step through the kernels against the plain versions within the
   larger of 1e-5 and 4x the plain step's sum-order floor (a graph built
   from permuted edges); (iv) ``hier_comm_stats`` at d = 256 (halo rows
   against the flat ring's) and the ms of a d = 256 SpMM on each layout, of
   the hier intra ring and of one halo exchange; (v) ``main --hier_mesh=2x2
   --epochs=2`` prints the one-device columns. Phase 12's seconds are
   printed.
13. the host library (``native/graph_prep.cpp``, built by g++ into
   ``_build/``) and edge label propagation: (i) the plain code of the two
   slow host builds by its parts (``build_dist_graph`` at the citation2
   shape, S = 2: the lexsort, the gathers and degrees, each rank's shard
   masks, each bucket's ``_csr`` and the row schedules; and
   ``gen_baseline_embs``'s ``standard_pipeline`` steps and ``build_graph``),
   then the native builds against their plain versions, timed and bit for
   bit: both ranks' buckets at citation2, every rank's buckets and edge view
   of the slice at S = 4, ``_csr`` forward and transposed on phase 7's
   message edges, and ``build_edge_graph`` of the bench graph's 1,166,243
   edges at ``max_degree`` 256 and uncapped; (ii) ``run_logit_lp`` and
   ``run_emb_lp`` (d = 256) over that edge graph at the default cap and 5
   propagations, and ``run_xmc_lp`` (4,096 scored edges over the bench
   graph): each launches the f32 kernel exactly once a propagation (xmc: a
   column block of 128 a propagation) and is held to the same call on the
   plain version within 1e-5 relative; the kernel against the plain version
   on the edge graph at d = 1 and 512 with its ms, and the ms of a
   propagation; ``train_linkpred`` with each ``edge_lp_mode`` (1 step, the
   evaluation) on a 20,000-node split whose largest node is over the cap: a
   finite MRR and exact launch counts (the pair-scoring kernel's 5 an eval
   among them). Phase 13's seconds are printed.
14. the bespoke sharded teachers (``parallel/distributed.py``,
   ``parallel/tensor_parallel.py``) on phase 3's slice at its widths
   (128 -> 256 -> 40, SE on layer 0), padded as the JAX package pads
   (``ceil(n / S) * S``), the SE rows of padding zero so that every S
   computes one function: (i) one rank, no collective: the f32 kernel on
   the all-gather SpMM's forward and transposed CSRs at d = 256 and 40
   against the plain version (``compare``), and ``dist_spmm``'s y and dx
   against ``ops/spmm.py:spmm`` on the one-device graph (1e-5), with ms;
   (ii) ``make_dist_train_step``, 5 SGD steps: finite losses that fall,
   exactly 4 f32 launches a step and none of the others, step ms, and one
   step through the kernel against the plain version within the larger of
   1e-5 and 4x the plain step's sum-order floor (a graph built from
   permuted edges); the 2-D step on a 1 x 1 mesh, 3 steps (its one-rank
   run); (iii) two ranks (over NCCL with two cards, else over host-staged
   gloo on the one card; the line names it): the all-gather SpMM and
   ``dist_spmm_ring`` at d = 256 and 40, y and dx, against S = 1's
   ``dist_spmm`` on the same x (1e-5), then the 1-D step, 3 steps, 4 f32
   launches a step a rank, its losses, dense parameters and SE norm held
   to the S = 1 run's first 3 steps (1e-4), and the ms of a d = 256
   all-gather, reduce-scatter and SpMM of each kind with the bytes a rank
   moves; (iv) four ranks on the (graph 2, model 2) mesh (NCCL with four
   cards, else gloo): the 2-D step, 3 steps, held to its one-rank run
   likewise. Phase 14's seconds are printed.
15. the bench twins as a benchmark runs them: ``python3 bench_torch.py``
   and ``python3 bench_linkpred_torch.py`` as subprocesses, each with a hard
   timeout. Each must exit 0 and print a last line that parses as JSON,
   which is printed on a line of its own: the teacher bench's ``value``
   finite and positive, ``dist_numerics_ok`` true, and its launch counts,
   over the timed windows and over its ``--dist`` run's, exactly
   ``2 x layers`` bf16 launches a timed step (forward and transposed
   backward a layer) and none of the others; the link bench's ``mrr_test``
   finite, its OGB-protocol MRR in (0, 1], and exactly 2 bf16 launches a
   timed step (layer 2's forward and transposed backward; layer 1 is
   hoisted). Phase 15's seconds are printed.
16. the profiler: ``python3 profile_step.py --cell GroupNorm --cell LP``
   (the cheapest cell that runs B1 and a norm, and the cheapest host-bound
   cell) as a subprocess, its traces in a directory under ``_chip/`` that
   is removed. It must exit 0 and print a last line that parses as JSON;
   each cell's JSON is printed on a line of its own. Each cell's op classes
   must sum to its device ms within 1e-6 relative, its idle share lie in
   [0, 1), and its launch counts over the profiled window equal the
   expected (GroupNorm: ``expected_launches``; LP: 50 f32; plain 0). The
   LP cell must carry a non-empty ``host_top`` (its host attribution under
   cProfile) whose shares lie in [0, 1]. Phase 16's seconds are printed.

Prints the kernels' JSON line (launches summed over the runs each phase
holds to an expected count, not the kernel-against-plain checks'; phase 7's
numbers under ``linkpred``, phase 8's under ``cli``, phase 9's under
``baselines``, phase 10's under ``sharded``, phase 11's under
``sharded_students``, phase 12's under ``hier`` and ``mesh_2d``, phase
13's under ``native``, phase 14's under ``bespoke``, phase 15's under
``bench_twins``, phase 16's under ``profile``), the card's name and power
limit, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gnn_tail_generalization_tpu_torch.ops import _build

REL_TOL = 1e-5
SPMM_SOURCE = "gnn_tail_generalization_tpu_torch/csrc/spmm_csr.cu"
KERNELS = {  # wrapper -> (what it replaces in the JAX package, its source)
    "spmm_csr_f32": ("gnn_tail_generalization_tpu/ops/spmm_pallas.py:305", SPMM_SOURCE),
    "spmm_csr_bf16": ("gnn_tail_generalization_tpu/ops/spmm_pallas.py:389", SPMM_SOURCE),
    "edge_attn_rows_f32": ("plain XLA: gnn_tail_generalization_tpu/linkpred/encoders.py",
                           "gnn_tail_generalization_tpu_torch/csrc/edge_attention.cu"),
    "pair_dot_f32": ("plain XLA: gnn_tail_generalization_tpu/linkpred/model.py:508-522",
                     "gnn_tail_generalization_tpu_torch/csrc/pair_score.cu"),
}
ATTN_D = 256  # the link Transformer's width
PAIR_D, C2_VALID = 256, 86_596  # the evaluation cell's table width and valid positives
SCORED_RECALL = 5  # splits an eval scores where the train positives are scored too
SLICE_ARGS = ["--dataset=ogbn-arxiv", "--train_which=TeacherGNN", "--epochs=3",
              "--device=cuda", "--log_every=1"]
# '111': under the Initial trick every conv takes SE flag [1]
SEMLP_ARGS = ["--dataset=ogbn-arxiv", "--train_which=SEMLP", "--whetherHasSE=111",
              "--se_reg=32", "--epochs=3", "--device=cuda", "--spmm_method=auto",
              "--log_every=1"]
STUDENT_RUNS = (
    ["--dataset=ogbn-arxiv", "--train_which=StudentBaseMLP", "--epochs=3",
     "--device=cuda", "--log_every=1"],
    ["--dataset=Cora", "--train_which=GraphMLP", "--graphMLP_reg=0.5",
     "--epochs=3", "--device=cuda", "--log_every=1"],
)
STUDENT_COLS = ["loss_train", "acc_test", "head", "tail", "iso"]
REPLACE_ROWS = 512  # rows held to the float64 evaluation
REPLACE_BATCH = 64 * 1024  # the arxiv config's batch_size
TRICK_BASE = ["--dataset=ogbn-arxiv", "--train_which=TeacherGNN",
              "--force_set_to_best_config=0", "--epochs=3", "--device=cuda",
              "--log_every=1"]
TRICK_RUNS = {
    "BatchNorm": ["--type_trick=BatchNorm"],
    "GroupNorm": ["--type_trick=GroupNorm"],
    "PairNorm": ["--type_trick=PairNorm"],
    "DenseNoNorm-attention": ["--type_trick=DenseNoNorm", "--layer_agg=attention"],
    "Jumping": ["--type_trick=Jumping"],
    "DropEdge": ["--type_trick=DropEdge", "--apply_graph_dropout=1"],
    "LADIES": ["--type_trick=LADIES", "--apply_graph_dropout=1",
               "--layerwise_dropout=1"],
    "FastGCN-bf16": ["--type_trick=FastGCN", "--apply_graph_dropout=1",
                     "--spmm_method=pallas_bf16"],
}
# run -> whether the parity bound takes the sum-order floor (check_step_parity)
TRICK_PARITY = {"GroupNorm": True, "LADIES": False}
LP_ARGS = ["--dataset=ogbn-arxiv", "--train_which=LP", "--device=cuda"]
CS_EPOCHS = 5
# phase 7: link prediction at ogbl-citation2's shape (bench_linkpred.py:49-105)
C2_NODES, C2_EDGES, C2_FEATS = 2_927_963, 30_387_995 // 2, 128
BENCH_NODES, BENCH_EDGES = 169_343, 1_166_243  # phase 2's bench shape
EVAL_POS, EVAL_NEG, OGB_NEG = 8192, 50, 1000
TIMED_STEPS = 16
I2GTL_ARGS = ["--exp_mode=I2_GTL", "--task=linkp", "--device=cuda"]
STAR_NODES, STAR_EDGES = 100_000, 1_000_000  # phase 2's star graph
# phase 8: the reader-fed teacher, the I2-GTL teacher, multi-seed, --prog
READER_ARGS = SLICE_ARGS + ["--spmm_method=auto"]
I2GTL_NODEC_ARGS = SLICE_ARGS + ["--exp_mode=I2_GTL", "--task=nodeC"]
N_EXP = 3
# phase 9: gen_baseline_embs's defaults
BASELINE_HIDDEN, BASELINE_EPOCHS = 64, 50
# phase 10: the row-sharded teacher. rb = DIST_PAD // S pads the slice to
# 169,472 rows (512 x 331) for S = 1, 2 and 4 alike, so that the padded rows
# that enter the batch norms' statistics are the same in every run
DIST_PAD, DIST_EPOCHS, DIST_EXTRA_EPOCHS, DIST_BUCKET_SHARDS = 512, 3, 2, 4
DIST_BF16_FLIPS = 10  # nodes an accuracy column may move by across S, bf16
# run -> (spmm method, seed offset); the second bf16 seed is a second
# reading of how far bf16 rounding moves the accuracies across S
DIST_RUNS = {"auto": ("auto", 0), "pallas_bf16": ("pallas_bf16", 0),
             "pallas_bf16 seed+1": ("pallas_bf16", 1)}
DIST_DROPEDGE = ["--force_set_to_best_config=0", "--type_trick=DropEdge",
                 "--apply_graph_dropout=1"]
DIST_I2GTL = ["--exp_mode=I2_GTL", "--task=nodeC"]
DIST_CLI_ARGS = ["--dataset=ogbn-arxiv", "--n_devices=2", "--epochs=2",
                 "--device=cuda", "--log_every=1"]
# phase 11: the sharded students, LP and C&S, and link prediction. Every run
# takes phase 10's padding (rb = DIST_PAD // S) and dropout 0 in the teacher;
# GraphMLP crops A^2 (the default A^3 takes ~17 s of host a rank here)
STUDENT_DIST_EPOCHS = 2
GRAPHMLP_ARXIV_ARGS = ["--dataset=ogbn-arxiv", "--train_which=GraphMLP",
                       "--graphMLP_reg=0.5", "--graphMLP_r=2", "--device=cuda"]
# run -> (argv, spmm method)
STUDENT_DIST_RUNS = {"SEMLP auto": (SEMLP_ARGS, "auto"),
                     "SEMLP pallas_bf16": (SEMLP_ARGS, "pallas_bf16"),
                     "StudentBaseMLP": (STUDENT_RUNS[0], "auto"),
                     "GraphMLP": (GRAPHMLP_ARXIV_ARGS, "auto"),
                     "LP auto": (LP_ARGS, "auto"),
                     "LP pallas_bf16": (LP_ARGS, "pallas_bf16")}
# phase 12: the two-axis layouts on four ranks: the two-level (host 2 x card
# 2) layout at rb = 128 and the 2-D (graph 2 x model 2) mesh at rb = 256 on
# the graph axis, both padding the slice to phase 10's 169,472 rows
TWO_AXIS_RB = {"hier": DIST_PAD // 4, "mesh_2d": DIST_PAD // 2}
TWO_AXIS_EPOCHS, TWO_AXIS_METHODS, TWO_AXIS_REPS = 2, ("auto", "pallas_bf16"), 5
HIER_CLI_ARGS = ["--dataset=ogbn-arxiv", "--hier_mesh=2x2", "--epochs=2",
                 "--device=cuda", "--log_every=1"]
N_PROP = 50  # run_pure_lp's propagations
LINK_EVAL_POS, LINK_STEPS = 1024, 2  # the sharded link runs' eval split, steps an epoch
# phase 13: the host library and edge LP. build_dist_graph at citation2 at
# S = 2, both ranks (rb: link_dist_graph's); edge LP at the default cap and
# propagations, run_emb_lp at LinkPredConfig's encoder width, run_xmc_lp on
# 4,096 scored edges (a [169343, ~4,096] f32 block, ~2.8 GB); evaluate on a
# split whose largest node is over the cap
NATIVE_DIST_S, NATIVE_DIST_RB = 2, 128
ELP_CAP, ELP_PROPS, ELP_EMB_D, XMC_SCORED = 256, 5, 256, 4096
ELP_SPLIT_NODES, ELP_SPLIT_EDGES, ELP_SPLIT_POS, ELP_SPLIT_NEG = 20_000, 100_000, 1000, 20
# phase 14: the bespoke sharded teachers (parallel/distributed.py,
# parallel/tensor_parallel.py) on the slice at its widths, 128 -> 256 -> 40,
# SE on layer 0, padded as JAX pads (ceil(n / S) * S: 169,343 rows at S = 1,
# 169,344 at S = 2 and on the 2 x 2 mesh). The SE rows of padding start at
# zero and stay there (a padded node has no edge), so every S computes one
# function. lr is the JAX tests'; se_reg 1e-4 weighs the norm of the
# [169343, 256] table (~6,600) near the NLL, as 0.01 does at their n = 80
BESPOKE_HIDDEN, BESPOKE_LR, BESPOKE_SE_REG, BESPOKE_SEED = 256, 0.05, 1e-4, 0
BESPOKE_STEPS, BESPOKE_SHARDED_STEPS, BESPOKE_REPS = 5, 3, 5
BESPOKE_REL = 1e-4  # sharded records against the one-rank run (f32 sum order)
# phase 15: the bench twins, each run as a benchmark runs it, with its timeout
TWIN_TIMEOUT_S = 450
# phase 16: profile_step.py's cheapest cell that runs B1 and a norm, and
# its cheapest host-bound cell, which runs the host attribution
PROFILE_CELLS = ("GroupNorm", "LP")


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def library_fn(g, x, bf16: bool):
    """One PyTorch call that computes the same product: torch.sparse.mm of a
    CSR tensor (cuSPARSE), x and w already in the working type (its bf16
    form returns bf16). Timed as a yardstick; the port never calls it."""
    dt = torch.bfloat16 if bf16 else torch.float32
    a = torch.sparse_csr_tensor(g.indptr, g.indices, g.weight.to(dt),
                                size=(g.n_node, g.n_node), check_invariants=False)
    xx = x.to(dt)
    return lambda: torch.sparse.mm(a, xx)


def same_bits(a, b) -> bool:
    """Whether two outputs, each a tensor of 4- or 8-byte elements or a tuple
    of them, are equal bit for bit."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def bound(nbytes: float, flops: float = 0.0) -> tuple:
    """(ms, what bounds it): the least time an H100 could take to move
    ``nbytes`` over HBM or do ``flops`` f32 operations, the larger of the
    two."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    return max((nbytes / K.HBM_BYTES_PER_S * 1e3, "bytes"), (flops / K.F32_FLOPS * 1e3, "ops"))


def kernel_vs_plain(kernel, plain, bound_ms: tuple, reps: int = 10,
                    plain_reps: int = 3) -> dict:
    """The steps every check of a kernel against its plain version shares:
    ``kernel()`` twice and ``plain()`` once, of one shape; ``max_abs_err``,
    max |kernel - plain| over the (first) output tensor, ``scale``, max
    |plain|, and ``rel_err``, their ratio; ``same_plain``, the kernel's
    output bit for bit the plain version's, and ``same``, the two launches';
    the median ``ms`` of ``reps`` kernel calls (2 warm-ups) and ``plain_ms``
    of ``plain_reps`` plain ones (1); ``bound_ms`` (ms, what bounds it) and
    the kernel's share of it."""
    got, again, want = kernel(), kernel(), plain()
    g0, w0 = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    assert g0.shape == w0.shape, (g0.shape, w0.shape)
    abs_err, scale = (g0 - w0).abs().max().item(), w0.abs().max().item()
    r = {"max_abs_err": abs_err, "scale": scale, "rel_err": abs_err / max(scale, 1e-30),
         "dtype": str(g0.dtype), "same_plain": same_bits(got, want),
         "same": same_bits(got, again)}
    del got, again, want, g0, w0
    r["ms"] = median_ms(kernel, reps=reps, warmup=2)
    r["plain_ms"] = median_ms(plain, reps=plain_reps, warmup=1)
    r["bound_ms"], r["bound_by"] = bound_ms
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return r


def kernel_line(r: dict) -> str:
    """The log fields of ``kernel_vs_plain``'s result."""
    return (f"max_abs_err={r['max_abs_err']:.3e} rel_err={r['rel_err']:.3e} two launches "
            f"bit-identical: {r['same']} kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"share={r['share_of_bound']:.3f}")


def compare(name, fn, g, x, plain_bf16, card_name, tag, reps: int = 20) -> dict:
    """Kernel ``fn`` on ``g``'s CSR and row schedule against the plain
    version (``kernel_vs_plain``), with the library's ms and the SpMM bound.
    Fails when rel err > REL_TOL or two launches differ."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    args = (g.indptr, g.indices, g.weight, x)
    r = kernel_vs_plain(lambda: fn(*args, schedule=g.schedule),
                        lambda: K.spmm_csr_plain(*args, bf16=plain_bf16),
                        K.spmm_bound(g, x.shape[1], plain_bf16), reps, reps)
    r["library_ms"] = median_ms(library_fn(g, x, plain_bf16), reps=reps)
    log(f"  {name:14s} {tag:28s} d={x.shape[1]:3d} {kernel_line(r)} "
        f"library_ms={r['library_ms']:.4f} [{card_name}]")
    assert r["dtype"] == "torch.float32", r["dtype"]
    assert r["rel_err"] <= REL_TOL, f"{name} {tag}: rel err {r['rel_err']} > {REL_TOL}"
    assert r["same"], f"{name} {tag}: two launches differ"
    return r


def hub_graph():
    """The hub-row stress case of tests/test_spmm_pallas.py: node 7 takes
    500 in-edges, plus 100 random edges, over 40 nodes."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(0)
    n = 40
    src = rng.integers(0, n, 500)
    e = np.stack([np.concatenate([src, rng.integers(0, n, 100)]),
                  np.concatenate([np.full(500, 7), rng.integers(0, n, 100)])])
    return build_graph(e, n, with_dense=False)


def star_graph():
    """Node 0 takes STAR_EDGES in-edges from random sources, plus random
    light rows, over STAR_NODES nodes; unit weights."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(1)
    n, light = STAR_NODES, STAR_NODES * 5
    e = np.stack([rng.integers(0, n, STAR_EDGES + light),
                  np.concatenate([np.zeros(STAR_EDGES, np.int64),
                                  rng.integers(1, n, light)])])
    return build_graph(e, n, with_dense=False)


def boundary_graph():
    """Rows 0-4 of in-degree 0, T - 1, T, T + 1 and 2T + 1 (T the schedule's
    hub threshold), then 2,000 rows of random in-degree 0-8; weights
    normal."""
    from gnn_tail_generalization_tpu_torch.graph.core import HUB_THRESHOLD as T
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(2)
    degs = np.concatenate([[0, T - 1, T, T + 1, 2 * T + 1], rng.integers(0, 9, 2000)])
    n = degs.shape[0]
    dst = np.repeat(np.arange(n), degs)
    e = np.stack([rng.integers(0, n, dst.shape[0]), dst])
    return build_graph(e, n, rng.normal(size=dst.shape[0]).astype(np.float32),
                       with_dense=False)


def slice_data():
    """The slice's config and prepared data, as main builds them."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config

    return port_main.load_prepared(
        build_config(**port_main.parse_args(SLICE_ARGS)[0]), "data")


def step_grads(model, cfg, g, g_last, x, y, mask, pairs=None):
    """Loss and gradients of one train-mode step (no optimizer update), the
    loss as ``train_teacher``'s; graph-dropout masks, where the config draws
    them, from a generator seeded 0; the edgewise loss, where the config has
    it, on the fixed ``pairs``."""
    from gnn_tail_generalization_tpu_torch.train.edgewise import score_pairs
    from gnn_tail_generalization_tpu_torch.train.loops import teacher_loss

    model.train()
    model.zero_grad(set_to_none=True)
    graph_gen = torch.Generator(device=x.device).manual_seed(0)
    common, classi, se_reg, _ = model(g, x, g_last=g_last, graph_generator=graph_gen)
    l_struct = None if pairs is None else score_pairs(common, pairs)[0]
    loss = teacher_loss(cfg, classi, se_reg, y, mask, l_struct)
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def reordered_graph(pd):
    """``pd.graph`` with the edges of every row summed in another order: the
    same adjacency, built from a permuted edge list."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    perm = np.random.default_rng(1).permutation(pd.edge_index.shape[1])
    return build_graph(pd.edge_index[:, perm], pd.n_node, with_dense=False,
                       with_plans=pd.graph.has_plans)


def check_step_parity(cfg, pd, order_floor: bool = False, pairs=None):
    """One step at dropout 0 from fixed weights: f32 kernel vs the plain
    version (spmm method 'gather' calls it directly), within REL_TOL in loss
    and every gradient. Under graph dropout both steps draw their masks from
    a generator seeded 0, and the masks must be equal.

    ``order_floor``: also run the plain step on ``reordered_graph`` and hold
    each quantity to the larger of REL_TOL and 4x the difference that the
    reordering alone makes — for steps whose f32 result depends on the sum
    order by more than REL_TOL (GroupNorm's score gradient, PERF.md).
    ``pairs``: the fixed pairs of the edgewise loss (exp_mode=I2_GTL)."""
    from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
    from gnn_tail_generalization_tpu_torch.nn import graph_dropout as gd
    from gnn_tail_generalization_tpu_torch.train.loops import final_agg_view

    dev = torch.device("cuda")
    g = pd.graph.to(dev)
    g_last = final_agg_view(cfg, pd)
    g_last = g_last.to(dev) if g_last is not None else None
    x = torch.as_tensor(pd.x, device=dev)
    y = torch.as_tensor(pd.y, device=dev)
    mask = torch.as_tensor(pd.train_mask, device=dev)
    cfg_k = dataclasses.replace(cfg, dropout=0.0, spmm_method="pallas")
    kernel_model = TeacherGNN(cfg_k, generator=torch.Generator().manual_seed(0))
    plain_model = copy.deepcopy(kernel_model)
    for m in plain_model.modules():  # same weights, SpMM via the plain version
        if hasattr(m, "spmm_method"):
            m.spmm_method = "gather"
    floor_model = copy.deepcopy(plain_model)
    drawn, draw = [], gd.per_layer_edge_masks

    def record(*args, **kw):
        drawn.append(draw(*args, **kw))
        return drawn[-1]

    gd.per_layer_edge_masks = record
    try:
        loss_k, grads_k = step_grads(kernel_model.to(dev), cfg_k, g, g_last,
                                     x, y, mask, pairs)
        loss_p, grads_p = step_grads(plain_model.to(dev), cfg_k, g, g_last,
                                     x, y, mask, pairs)
    finally:
        gd.per_layer_edge_masks = draw
    if cfg.apply_graph_dropout:
        assert len(drawn) == 2 and drawn[0] is not None, drawn
        assert all(torch.equal(a, b) for a, b in zip(*drawn)), "masks differ"
        kept = [round(m.mean().item(), 4) for m in drawn[0]]
        log(f"  same masks in both steps; kept edge share per layer {kept}")
    floors = {}
    if order_floor:
        assert g_last is None and not cfg.apply_graph_dropout
        loss_f, grads_f = step_grads(floor_model.to(dev), cfg_k,
                                     reordered_graph(pd).to(dev), None, x, y, mask,
                                     pairs)
        floors = {k: rel_err(grads_f[k], grads_p[k]) for k in grads_p}
        floors["loss"] = abs(loss_f - loss_p) / abs(loss_p)
    worst = abs(loss_k - loss_p) / abs(loss_p)
    bound = max(REL_TOL, 4 * floors.get("loss", 0.0))
    log(f"  loss kernel={loss_k:.8f} plain={loss_p:.8f} rel={worst:.3e} "
        f"(bound {bound:.1e})")
    assert worst <= bound, f"step loss rel diff {worst} > {bound}"
    for k in grads_p:
        rel = rel_err(grads_k[k], grads_p[k])
        bound = max(REL_TOL, 4 * floors.get(k, 0.0))
        floor = f" order floor={floors[k]:.3e}" if k in floors else ""
        log(f"  grad {k:32s} {tuple(grads_p[k].shape)} rel={rel:.3e}{floor} "
            f"(bound {bound:.1e})")
        assert torch.isfinite(grads_k[k]).all() and rel <= bound, (k, rel, bound)


def replace_f64(q: np.ndarray, se: np.ndarray, k: int):
    """The replacement op in float64 on the host, written out plainly:
    (output, selected indices ordered by score, then index)."""
    scores = q @ se.T
    idx = np.empty((len(q), k), np.int64)
    for i, s in enumerate(scores):
        kth = np.partition(s, -k)[-k]
        above = np.flatnonzero(s > kth)
        sel = np.concatenate([above, np.flatnonzero(s == kth)[:k - len(above)]])
        idx[i] = sel[np.lexsort((sel, -s[sel]))]
    top = np.take_along_axis(scores, idx, axis=1)
    w = np.exp(top - top.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return np.einsum("bk,bkd->bd", w, se[idx]), idx


def check_replace(cfg, pd, res, card_name) -> dict:
    """(ii): latent_neighbor_replace on the card against the float64 host
    evaluation, on the SEMLP run's own SE table and part-1 queries; and its
    time at the arxiv batch."""
    from gnn_tail_generalization_tpu_torch.models.semlp import SEMLPPart1
    from gnn_tail_generalization_tpu_torch.ops.topk_attention import (
        latent_neighbor_replace, top_k_lowest_index)
    from gnn_tail_generalization_tpu_torch.train.loops import collect_teacher_se

    dev = torch.device("cuda")
    k = cfg.SEMLP_topK_2_replace
    se = collect_teacher_se(cfg, pd, res.extra["teacher"].best_state_dict,
                            device=dev)
    assert se.shape == (pd.n_node, 512), se.shape
    with torch.device("meta"):
        part1 = SEMLPPart1(cfg, se.shape[1])
    part1.load_state_dict(res.extra["part1"].state_dict, assign=True)
    part1.to(dev).eval()
    with torch.no_grad():  # part 2's input: alphas[0] * part 1's output
        q = part1(torch.as_tensor(pd.x[:REPLACE_BATCH], device=dev))
        q = q * res.state_dict["alphas"][0]
    rows = torch.randperm(REPLACE_BATCH, generator=torch.Generator().manual_seed(0))
    qr = q[rows[:REPLACE_ROWS].to(dev)]
    out = latent_neighbor_replace(qr, se, k)
    with torch.no_grad():
        _, idx = top_k_lowest_index(qr @ se.T, k)
    ref, ref_idx = replace_f64(qr.double().cpu().numpy(),
                               se.double().cpu().numpy(), k)
    same = np.array_equal(np.sort(idx.cpu().numpy(), axis=1), np.sort(ref_idx, axis=1))
    abs_err = float(np.abs(out.double().cpu().numpy() - ref).max())
    rel_err = abs_err / max(float(np.abs(ref).max()), 1e-300)
    ms = median_ms(lambda: latent_neighbor_replace(q, se, k), reps=3, warmup=1)
    tflop = 2 * REPLACE_BATCH * se.shape[1] * se.shape[0] / 1e12
    log(f"  latent_neighbor_replace: {REPLACE_ROWS} rows vs float64, same "
        f"neighbours={same}, max_abs_err={abs_err:.3e} rel_err={rel_err:.3e}; "
        f"B={REPLACE_BATCH} K={k} table {tuple(se.shape)}: {ms:.3f} ms "
        f"({tflop:.2f} TFLOP of scores, {tflop / ms * 1e3:.1f} TFLOP/s) "
        f"[{card_name}]")
    assert same, "the card selected other neighbours than the float64 evaluation"
    assert rel_err <= REL_TOL, f"replace rel err {rel_err} > {REL_TOL}"
    # one row chunk of the op, split into its score matmul and its selection
    chunk = q[:8192]
    with torch.no_grad():
        mm_ms = median_ms(lambda: chunk @ se.T, reps=5, warmup=1)
        scores = chunk @ se.T
        sel_ms = median_ms(lambda: top_k_lowest_index(scores, k), reps=5, warmup=1)
        log(f"  one {tuple(chunk.shape)} chunk: score matmul {mm_ms:.3f} ms "
            f"({tflop * chunk.shape[0] / REPLACE_BATCH / mm_ms * 1e3:.1f} "
            f"TFLOP/s), top-K selection "
            f"{sel_ms:.3f} ms [{card_name}]")
        kernel = check_topk_kernel(scores, k, card_name)
    del scores
    torch.cuda.empty_cache()
    return {"rows": REPLACE_ROWS, "rel_err": rel_err, "batch": REPLACE_BATCH,
            "ms": ms, "chunk_matmul_ms": mm_ms, "chunk_select_ms": sel_ms,
            "topk_kernel": kernel}


def topk_cases(chunk: torch.Tensor, gen: torch.Generator):
    """(name, scores, Ks) of the top-K kernel's card test beyond the arxiv
    chunk: its rows at every K; odd widths and unaligned row starts; exact
    ties across the K-th place (duplicated columns, as duplicated SE rows
    give; a top score repeated across lanes, warps and the row's ends; an
    all-zero table); -inf columns; the S * K merge's narrow shape; +-0.0
    and NaN."""
    dev = chunk.device
    every_k = (1, 2, 3, 8, 32)
    yield "arxiv rows", chunk[:2048], every_k
    for n, m in ((257, 1001), (33, 5), (100, 4097), (7, 4095), (3, 200003), (64, 4096)):
        x = torch.randn(n * m + 1, generator=gen, device=dev)
        for off in (0, 1):  # offset 1: no row starts 16-byte aligned where m % 4 == 0
            yield f"random {n}x{m} +{off}", x[off:off + n * m].view(n, m), tuple(
                k for k in every_k if k <= m)
    cols = torch.randint(0, 64, (chunk.shape[1],), generator=gen, device=dev)
    yield "duplicated columns", chunk[:512, cols].contiguous(), every_k
    wide = chunk[:256].clone()
    n = wide.shape[1]
    spots = torch.tensor([1, 2, 5, 9, 130, 262, 1030, 2050, 4100, n - 3, n - 2, n - 1],
                         device=dev)
    wide[:, spots] = wide.max(dim=1, keepdim=True).values + 1.0
    yield "top score at 12 spots", wide, every_k
    yield "all zero", torch.zeros(64, 50, device=dev), every_k
    neg = chunk[:512].clone()
    neg[torch.rand(neg.shape, generator=gen, device=dev) < 0.5] = float("-inf")
    neg[0] = float("-inf")
    neg[1, 2:] = float("-inf")  # 2 finite scores
    neg[2, :n // 2] = float("-inf")
    yield "-inf columns", neg, every_k
    ints = torch.randint(-2, 3, (65536, 8), generator=gen, device=dev).float()
    yield "S*K merge 65536x4", ints[:, :4].contiguous(), (1, 2, 3, 4)
    yield "S*K merge 65536x8", ints, (1, 2, 8)
    signed = torch.randint(-1, 2, (512, 300), generator=gen, device=dev).float() * 0.0
    yield "+-0.0", signed, every_k
    nan = chunk[:512].clone()
    nan[torch.rand(nan.shape, generator=gen, device=dev) < 1e-4] = float("nan")
    nan[0, ::1000] = float("nan")
    yield "NaN", nan, every_k


def check_topk_kernel(chunk: torch.Tensor, k: int, card_name: str) -> dict:
    """(ii): the top-K kernel against its plain version on the same score
    tensors, values and indices bit for bit: the arxiv chunk ``chunk``
    [8192, 169,343] at the run's K, then ``topk_cases``. The kernel's, the
    plain version's and ``torch.topk``'s ms on the chunk, beside the bound
    (one read of the chunk over HBM's rate)."""
    from gnn_tail_generalization_tpu_torch.ops.topk_kernels import (
        top_k_plain, topk_rows_f32)

    dev = chunk.device
    n_rows, n_cols = chunk.shape
    r = kernel_vs_plain(lambda: topk_rows_f32(chunk, k), lambda: top_k_plain(chunk, k),
                        bound(n_rows * n_cols * 4 + n_rows * k * 12))
    assert r["same_plain"], "the kernel differs from the plain version on the arxiv chunk"
    assert r["same"], "two launches differ on the arxiv chunk"
    ms, bound_ms = r["ms"], r["bound_ms"]
    library_ms = median_ms(lambda: torch.topk(chunk, k, dim=1), reps=5, warmup=1)
    log(f"  top-K kernel on the {tuple(chunk.shape)} chunk, K={k}: bit-equal to the plain "
        f"version; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), share "
        f"{bound_ms / ms:.3f}, plain {r['plain_ms']:.3f} ms, library_ms (torch.topk) "
        f"{library_ms:.3f} ms [{card_name}]")
    cases = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, scores, ks in topk_cases(chunk, gen):
        for kk in ks:
            gv, gi = topk_rows_f32(scores, kk)
            wv, wi = top_k_plain(scores, kk)
            ok = same_bits(gv, wv) and torch.equal(gi, wi)
            cases[f"{name} K={kk}"] = ok
            if not ok:
                bad = ((gi != wi).any(1) | ~(gv.view(torch.int32) == wv.view(torch.int32)).all(1))
                r = int(bad.nonzero()[0, 0])
                log(f"  MISMATCH {name} K={kk} {tuple(scores.shape)}: {int(bad.sum())} rows; "
                    f"row {r}: kernel {gv[r].tolist()} {gi[r].tolist()}, plain "
                    f"{wv[r].tolist()} {wi[r].tolist()}")
        log(f"  {name:24s} {tuple(scores.shape)} K={list(ks)}: bit-equal "
            f"{all(cases[f'{name} K={kk}'] for kk in ks)}")
        del scores
    bad = [c for c, ok in cases.items() if not ok]
    assert not bad, f"the kernel differs from the plain version: {bad}"
    return {"shape": [n_rows, n_cols], "k": k, "ms": ms, "bound_ms": bound_ms,
            "bound_by": r["bound_by"], "share_of_bound": bound_ms / ms,
            "plain_ms": r["plain_ms"], "library_ms": library_ms, "cases": len(cases)}


def check_attn_rows(g, gen: torch.Generator, card_name: str) -> dict:
    """Phase 7 (i): the attention rows' kernel (``edge_attn_rows`` on the
    card, ``csrc/edge_attention.cu``) against its plain version on the same
    operands of width ``ATTN_D`` (N(0, 1): logits of unit spread), on
    ``g``'s forward CSR and row schedule, in softmax and grad mode: max
    |kernel - plain| / max |plain| <= REL_TOL, two launches bit-identical.
    Each mode's kernel and plain ms beside the bound (bytes: the row
    operand's rows, each source row of the source operand once, indices,
    row pointers, the [E] scalars read and written; or 2 nnz d operations)."""
    from gnn_tail_generalization_tpu_torch.ops import edge_attention as EA

    dev, d, scale = g.indptr.device, ATTN_D, ATTN_D ** -0.5
    q, k, v, d_out = (torch.randn(g.n_node, d, generator=gen, device=dev) for _ in range(4))
    n_dst = int((g.indptr[1:] > g.indptr[:-1]).sum())
    n_src = int(torch.unique(g.indices).numel())
    alpha = EA.edge_attn_rows("softmax", g.indptr, g.indices, q, k, scale, schedule=g.schedule)
    res = {}
    for mode, a, b, al in (("softmax", q, k, None), ("grad", d_out, v, alpha)):
        def kernel():
            return EA.edge_attn_rows(mode, g.indptr, g.indices, a, b, scale, alpha=al,
                                     schedule=g.schedule)

        def plain():
            return EA.edge_attn_rows_plain(mode, g.indptr, g.indices, a, b, scale, al)
        nbytes = ((n_dst + n_src) * d * 4 + g.n_edge * 4 + (g.n_node + 1) * 4
                  + g.n_edge * 4 * (2 if mode == "grad" else 1))
        r = kernel_vs_plain(kernel, plain, bound(nbytes, 2 * g.n_edge * d))
        log(f"  edge_attn_rows {mode:7s} citation2 d={d} {kernel_line(r)} [{card_name}]")
        assert r["rel_err"] <= REL_TOL, f"edge_attn_rows {mode}: rel err {r['rel_err']} > {REL_TOL}"
        assert r["same"], f"edge_attn_rows {mode}: two launches differ"
        res[mode] = r
    return {"max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "max_rel_err": max(r["rel_err"] for r in res.values()), **res}


def check_pair_dot(card_name: str, dev) -> dict:
    """Phase 7 (i): the pair-scoring kernel (``pair_dot`` on the card,
    ``csrc/pair_score.cu``) against its plain version on the evaluation
    cell's valid split, positives and negatives: within 1e-6 of the largest
    |score|, two launches bit-identical. Each part's kernel and plain ms
    beside the bound (bytes: a destination row, 16 bytes of indices and a
    4-byte score a pair, a source row a run of pairs that share it; or
    2 d operations a pair)."""
    from gnn_tail_generalization_tpu_torch.ops import pair_score as PS

    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn(C2_NODES, PAIR_D, generator=gen, device=dev)
    pos = torch.randint(0, C2_NODES, (C2_VALID, 2), generator=gen, device=dev)
    dst = torch.randint(0, C2_NODES, (C2_VALID * OGB_NEG,), generator=gen, device=dev)
    neg = torch.stack([pos[:, 0].repeat_interleave(OGB_NEG), dst], dim=1)
    del dst
    res = {}
    for tag, pairs in (("positives", pos), ("negatives", neg)):
        m = pairs.shape[0]
        runs = 1 + int((pairs[1:, 0] != pairs[:-1, 0]).sum())
        r = kernel_vs_plain(lambda: PS.pair_dot(h, pairs), lambda: PS.pair_dot_plain(h, pairs),
                            bound(m * (PAIR_D * 4 + 16 + 4) + runs * PAIR_D * 4,
                                  2 * m * PAIR_D))
        abs_err, scale = r["max_abs_err"], r["scale"]
        log(f"  pair_dot_f32 valid {tag:9s} {m} pairs, {runs} source runs, d={PAIR_D} "
            f"{kernel_line(r)} (largest |score| {scale:.3e}) [{card_name}]")
        assert abs_err <= 1e-6 * scale, f"pair_dot_f32 {tag}: {abs_err} > 1e-6 x {scale}"
        assert r["same"], f"pair_dot_f32 {tag}: two launches differ"
        res[tag] = {"pairs": m, "source_runs": runs, **r}
    both = {k: sum(r[k] for r in res.values()) for k in ("ms", "plain_ms", "bound_ms")}
    log(f"  pair_dot_f32 valid split: kernel_ms={both['ms']:.4f} plain_ms="
        f"{both['plain_ms']:.4f} bound_ms={both['bound_ms']:.4f} share="
        f"{both['bound_ms'] / both['ms']:.3f} [{card_name}]")
    return {"max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "max_rel_err": max(r["rel_err"] for r in res.values()), **both,
            "bound_by": res["negatives"]["bound_by"],
            "share_of_bound": both["bound_ms"] / both["ms"], **res}


def replace_launches(cfg, pd, epochs: int) -> int:
    """The top-K kernel's launches in ``epochs`` part-2 epochs: one a row
    chunk (8,192 rows, ``latent_neighbor_replace``'s) of each replacement:
    the train batch, the test batch, each head / tail / iso subset."""
    bsz = min(cfg.batch_size, len(pd.train_idx))
    rows = [bsz, bsz if len(pd.test_idx) else 0]
    s = pd.splits
    if cfg.want_headtail and s is not None:
        rows += [len(s.large_deg_idx), len(s.small_deg_idx)]
        if s.zero_deg_idx is not None:
            rows.append(len(s.zero_deg_idx))
    return epochs * sum(-(-r // 8192) for r in rows)


def student_phase(pd, teacher_launches: int, card_name: str,
                  totals: dict) -> dict:
    """Phase 4: the Cold Brew student on the card."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config

    log("  (i) SEMLP through the port's main")
    _build.reset_launch_counts()
    res = port_main.main(SEMLP_ARGS)[0]
    counts = _build.launch_counts("spmm_csr")
    log(f"  launch counts over the SEMLP run: {counts}, {_build.launch_counts('topk')}")
    cfg = port_main.fitted_to(
        build_config(**port_main.parse_args(SEMLP_ARGS)[0]), pd)
    # the teacher's steps as in phase 3, plus the SE-table forward
    expect = {"spmm_csr_f32": teacher_launches + cfg.num_layers,
              "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    assert counts == expect, f"SEMLP launched {counts}, expected {expect}"
    topk_expect = replace_launches(cfg, pd, 3)
    assert _build.LAUNCHES["topk_rows_f32"] == topk_expect, (_build.LAUNCHES, topk_expect)
    for k, v in counts.items():
        totals[k] += v
    phases = {"teacher": res.extra["teacher"], "part1": res.extra["part1"],
              "part2": res}
    assert res.columns == STUDENT_COLS, res.columns
    for name, r in phases.items():
        assert r.records.shape[0] == 3 and np.isfinite(r.records).all(), (name, r.records)

    log("  (ii) latent_neighbor_replace on the card")
    replace = check_replace(cfg, pd, res, card_name)

    log("  (iii) StudentBaseMLP (arxiv shape) and GraphMLP (Cora stand-in)")
    for argv in STUDENT_RUNS:
        _build.reset_launch_counts()
        r = port_main.main(argv)[0]
        counts = _build.launch_counts("spmm_csr")
        log(f"  {argv[1]}: launch counts {counts}, step_ms {r.step_ms}, "
            f"eval_ms {r.eval_ms} [{card_name}]")
        assert not any(counts.values()), f"{argv[1]} launched {counts}"
        assert r.columns == STUDENT_COLS and r.records.shape == (3, 5), r.columns
        assert np.isfinite(r.records).all(), r.records

    log("  (iv) SEMLP times per epoch")
    times = {name: r.step_ms for name, r in phases.items()}
    times["part2_eval"] = res.eval_ms
    for name, t in times.items():
        log(f"  {name:10s} ms {[round(v, 3) for v in t]} [{card_name}]")
    return {"step_ms": times, "replace": replace}


def expected_launches(cfg, epochs: int) -> dict:
    """The SpMM launches of ``epochs`` teacher epochs: per layer two in the
    train step (forward and the transposed backward) and one in the eval
    forward. Masked graphs have no plans, so their SpMMs run the f32 kernel
    under every method; the eval forward runs on the full graph."""
    counts = {"spmm_csr_f32": 0, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    bf16 = cfg.spmm_method == "pallas_bf16"
    train = "spmm_csr_f32" if cfg.apply_graph_dropout or not bf16 else "spmm_csr_bf16"
    counts[train] += 2 * cfg.num_layers * epochs
    counts["spmm_csr_bf16" if bf16 else "spmm_csr_f32"] += cfg.num_layers * epochs
    return counts


def trick_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 5: the trick zoo through the port's main."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config

    step_ms = {}
    for name, extra in TRICK_RUNS.items():
        argv = TRICK_BASE + extra
        cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
        _build.reset_launch_counts()
        res = port_main.main(argv)[0]
        counts = _build.launch_counts("spmm_csr")
        expect = expected_launches(cfg, 3)
        assert counts == expect, f"{name} launched {counts}, expected {expect}"
        assert res.records.shape[0] == 3 and np.isfinite(res.records).all(), (
            name, res.records)
        for k, v in counts.items():
            totals[k] += v
        step_ms[name] = res.step_ms
        log(f"  {name:22s} launches {counts} step_ms "
            f"{[round(v, 3) for v in res.step_ms]} [{card_name}]")
    for name, order_floor in TRICK_PARITY.items():
        argv = TRICK_BASE + TRICK_RUNS[name]
        cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
        log(f"  one-step parity, {name}, f32 kernel vs plain version (dropout 0):")
        check_step_parity(cfg, pd, order_floor)
    return step_ms


def propagation_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 6: --train_which=LP through main, and C&S."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
    from gnn_tail_generalization_tpu_torch.propagation import correlation as corr
    from gnn_tail_generalization_tpu_torch.propagation import cs

    dev = torch.device("cuda")
    log("  (i) --train_which=LP through the port's main")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = port_main.main(LP_ARGS)[0]
    lp_s = time.perf_counter() - t0
    counts = _build.launch_counts("spmm_csr")
    log(f"  LP result {res}, launch counts {counts}, run {lp_s:.3f} s [{card_name}]")
    assert set(res) == {"acc_train", "acc_test"} and all(
        np.isfinite(v) for v in res.values()), res
    n_prop = 50  # run_pure_lp's
    assert counts == {"spmm_csr_f32": n_prop, "spmm_csr_bf16": 0,
                      "spmm_csr_plain": 0}, counts
    for k, v in counts.items():
        totals[k] += v

    dad = corr.gen_normalized_adjs(pd.edge_index, pd.n_node, which={"DAD"})[0].to(dev)
    y = torch.as_tensor(pd.y, device=dev)
    idx = torch.as_tensor(pd.train_idx, device=dev)
    nc = int(pd.y.max()) + 1

    def propagate(method):
        return corr.label_propagation(y, idx, dad, 0.5, n_prop, nc, method)

    out_k, out_p = propagate("auto"), propagate("gather")
    rel = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
    assert out_k.shape == (pd.n_node, nc) and torch.isfinite(out_k).all()
    assert rel <= REL_TOL, f"LP propagation rel err {rel} > {REL_TOL}"
    lp_ms = median_ms(lambda: propagate("auto"), reps=3, warmup=1)
    x40 = torch.rand(pd.n_node, nc, device=dev)
    spmm_ms = median_ms(lambda: spmm(dad, x40))
    log(f"  LP [{pd.n_node}, {nc}] kernel vs plain rel={rel:.3e}; {n_prop} "
        f"propagations {lp_ms:.3f} ms, {lp_ms / n_prop:.4f} ms each; one DAD "
        f"SpMM at d={nc} ({dad.n_edge} edges) {spmm_ms:.4f} ms [{card_name}]")

    log(f"  (ii) run_cs_pipeline, diffusion features, {CS_EPOCHS} mid-step epochs")
    cfg = port_main.fitted_to(build_config(
        dataset="ogbn-arxiv", train_which="LP", force_set_to_best_config=False), pd)
    cfg = dataclasses.replace(cfg, preStep=dataclasses.replace(
        cfg.preStep, pre_methods="diffusion"))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cs_res = cs.run_cs_pipeline(cfg, pd, epochs=CS_EPOCHS, device=dev)
    torch.cuda.synchronize()
    cs_s = time.perf_counter() - t0
    counts = _build.launch_counts("spmm_csr")
    lp = cfg.lpStep
    n_cs = lp.num_propagations1 + lp.num_propagations2
    log(f"  C&S acc_train={cs_res['acc_train']:.2f} acc_test={cs_res['acc_test']:.2f}"
        f" launches {counts}, pipeline {cs_s:.3f} s [{card_name}]")
    assert counts == {"spmm_csr_f32": n_cs, "spmm_csr_bf16": 0,
                      "spmm_csr_plain": 0}, counts
    assert torch.isfinite(cs_res["out"]).all() and np.isfinite(cs_res["acc_test"])
    for k, v in counts.items():
        totals[k] += v

    gen = torch.Generator(device=dev).manual_seed(0)
    model_out = torch.softmax(torch.randn(pd.n_node, nc, generator=gen, device=dev), 1)

    def step(method):
        return cs.lp_step(cfg, pd, model_out, idx, idx, spmm_method=method)

    t0 = time.perf_counter()
    cs_k = step("auto")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    cs_p = step("gather")
    rel_cs = ((cs_k - cs_p).abs().max() / cs_p.abs().max()).item()
    assert rel_cs <= REL_TOL, f"lp_step rel err {rel_cs} > {REL_TOL}"
    _, da, ad = (a if a is None else a.to(dev) for a in corr.gen_normalized_adjs(
        pd.edge_index, pd.n_node, which={lp.A1, lp.A2}))
    assert (lp.fn, lp.A1, lp.A2) == ("double_correlation_autoscale", "DA", "AD")
    cs_ms = median_ms(lambda: corr.double_correlation_autoscale(
        y, model_out, idx, idx, da, lp.alpha1, lp.num_propagations1, ad,
        lp.alpha2, lp.num_propagations2, nc), reps=3, warmup=1)
    log(f"  lp_step kernel vs plain rel={rel_cs:.3e}; lp_step {step_s * 1e3:.3f} ms "
        f"(host adjacency builds included); its {n_cs} propagations on the "
        f"card {cs_ms:.3f} ms [{card_name}]")
    return {"lp": res, "lp_rel_err": rel, "lp_ms": lp_ms,
            "propagation_ms": lp_ms / n_prop, "dad_spmm_ms": spmm_ms,
            "cs_acc_test": cs_res["acc_test"], "lp_step_rel_err": rel_cs,
            "cs_propagations_ms": cs_ms, "cs_pipeline_s": cs_s}


def lp_split(n_node: int, n_edge: int, n_pos: int = EVAL_POS, n_neg: int = EVAL_NEG):
    """``bench_linkpred_torch.py:build_split`` at seed 0 on a power-law graph:
    ``n_pos`` valid and ``n_pos`` test positives with ``n_neg`` sampled
    non-edges each, the other edges train; message edges = symmetrize(train).
    Returns (split_edge, message edges, host seconds)."""
    from bench_linkpred_torch import build_split
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph

    t0 = time.perf_counter()
    e = fast_powerlaw_graph(n_node, n_edge, 0)
    split_edge, msg, _, _ = build_split(e, n_node, np.random.default_rng(0), 0,
                                        n_pos, n_neg)
    return split_edge, msg, time.perf_counter() - t0


@contextlib.contextmanager
def plain_kernels():
    """Route ``spmm``'s kernel calls to the plain version (the bf16 one with
    its rounding), for the parity steps."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    def plain(bf16):
        return lambda ip, ix, w, x, schedule=None: K.spmm_csr_plain(ip, ix, w, x, bf16=bf16)

    saved = K.spmm_csr_f32, K.spmm_csr_bf16
    K.spmm_csr_f32, K.spmm_csr_bf16 = plain(False), plain(True)
    try:
        yield
    finally:
        K.spmm_csr_f32, K.spmm_csr_bf16 = saved


def lp_grads(cfg, model, g, x, batch):
    """Loss and gradients of one train-mode step (no update) on graph ``g``,
    the hoisted aggregation recomputed for it; on a rank's ``DistGraph``
    (``x`` its rows) the rank's gradients after the replicated ones are
    summed (the sharded trainer's rule)."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import (
        comm_of, sum_replicated_grads)

    const = lpm.link_const(cfg, g, x)
    model.train()
    model.zero_grad(set_to_none=True)
    loss = lpm.make_loss_fn(cfg, model)(const, *batch)
    comm = comm_of(g)
    (loss if comm is None else loss / comm.world_size).backward()
    if comm is not None:
        sum_replicated_grads(model, comm)
    return loss.item(), {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def lp_parity(cfg, g, reorderings, x, train_edges, tag) -> dict:
    """One step at dropout 0 from fixed weights, the kernels against the
    plain versions, in loss and every gradient: each within the larger of
    REL_TOL and 4x the plain step's own sum-order floor, the largest
    difference of the same plain step on each graph of ``reorderings`` (the
    edges of every row summed in another order). One reordering alone is
    too few where ReLU masks flip with the sum order (the default config's
    layer 0): its floor for one tensor ranged 2.5e-4 to 1.0e-3 over two
    runs, and a kernel step at 1.01e-3 then failed 4x the lower one."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

    dev = x.device
    cfg = dataclasses.replace(cfg, dropout=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = lpm.LinkPredModel(cfg, g.n_node, x.shape[1], generator=gen)
    b = cfg.batch_size
    pos = torch.as_tensor(train_edges[:b].astype(np.int64), device=dev)
    neg = torch.randint(0, g.n_node, (b, cfg.num_neg, 2), generator=gen, device=dev)
    valid = (torch.arange(b, device=dev) < b * 3 // 4).float()
    batch = (pos, neg, None, valid)
    loss_k, grads_k = lp_grads(cfg, model, g, x, batch)
    with plain_kernels():
        loss_p, grads_p = lp_grads(cfg, model, g, x, batch)
        floors = [lp_grads(cfg, model, g_re, x, batch) for g_re in reorderings]
    rows = {"loss": (abs(loss_k - loss_p) / abs(loss_p),
                     max(abs(loss_f - loss_p) / abs(loss_p) for loss_f, _ in floors))}
    for k in grads_p:
        assert torch.isfinite(grads_k[k]).all(), (tag, k)
        rows[k] = (rel_err(grads_k[k], grads_p[k]),
                   max(rel_err(grads_f[k], grads_p[k]) for _, grads_f in floors))
    log(f"  {tag}: loss kernel={loss_k:.8f} plain={loss_p:.8f}")
    for k, (rel, floor) in rows.items():
        bound = max(REL_TOL, 4 * floor)
        log(f"  {tag} {k:32s} rel={rel:.3e} order floor={floor:.3e} "
            f"(bound {bound:.1e})")
        assert rel <= bound, (tag, k, rel, bound)
    return {k: {"rel": r, "floor": f} for k, (r, f) in rows.items()}


def lp_timed(cfg, g, x, split_edge, msg, card_name, totals) -> dict:
    """The bench config's TIMED_STEPS-step epoch (best of 2 after a warm-up)
    and the warm OGB-style eval: EVAL_POS positives x OGB_NEG uniform
    destinations, one encode, the pair-scoring kernel once a split (held to
    2 launches an eval and added to ``totals``), grouped MRR."""
    from gnn_tail_generalization_tpu_torch.linkpred import metrics as M
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.linkpred import sampling

    dev, n, bsz = x.device, g.n_node, cfg.batch_size
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.device(dev):
        model = lpm.LinkPredModel(cfg, n, x.shape[1], generator=gen)
    const = lpm.link_const(cfg, g, x)
    epoch = lpm.make_epoch_fn(cfg, model, lpm.make_optimizer(cfg, model.parameters()),
                              n, TIMED_STEPS, bsz, TIMED_STEPS * bsz)
    pos_all = torch.as_tensor(
        split_edge["train"]["edge"][:TIMED_STEPS * bsz].astype(np.int64), device=dev)
    keys = sampling.build_membership(sampling.edge_keys(msg, n)).to(dev)
    model.train()
    epoch_s = []
    for _ in range(3):  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = epoch(const, pos_all, keys, gen)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        assert torch.isfinite(losses).all(), losses
    best = min(epoch_s[1:])
    log(f"  {TIMED_STEPS}-step epoch s {[round(s, 4) for s in epoch_s]} (first warms "
        f"up): {best / TIMED_STEPS * 1e3:.3f} ms a step [{card_name}]")

    val = torch.as_tensor(split_edge["valid"]["edge"][:EVAL_POS].astype(np.int64),
                          device=dev)
    neg = torch.stack([val[:, 0].repeat_interleave(OGB_NEG),
                       torch.randint(0, n, (EVAL_POS * OGB_NEG,), generator=gen,
                                     device=dev)], dim=1)

    def ogb_eval():
        model.eval()
        with torch.no_grad():
            h = lpm.encode_all(model, const)
            pos_s = lpm.predict_chunked(model, h, val)
            neg_s = lpm.predict_chunked(model, h, neg)
        return M.mrr(pos_s, neg_s.reshape(EVAL_POS, OGB_NEG))  # reads back

    _build.reset_launch_counts()
    ogb_eval()
    eval_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        mrr = ogb_eval()
        eval_s.append(time.perf_counter() - t0)
    assert np.isfinite(mrr), mrr
    assert _build.launch_counts("pair_dot") == {"pair_dot_f32": 2 * 3}, _build.LAUNCHES
    totals["pair_dot_f32"] += _build.LAUNCHES["pair_dot_f32"]
    log(f"  OGB eval: {EVAL_POS} positives x {OGB_NEG} destinations, MRR={mrr:.4f}, "
        f"warm s {[round(s, 4) for s in eval_s]} [{card_name}]")
    return {"epoch_s": epoch_s, "step_ms": best / TIMED_STEPS * 1e3,
            "ogb_eval_s": min(eval_s), "ogb_mrr": mrr}


def run_linkpred(cfg, x, split_edge, msg, n_node, expect, tag, card_name,
                 totals, dev, **kw) -> dict:
    """``train_linkpred`` on the card with the launch counts reset before and
    read after; fails unless they equal ``expect`` (0 where it names none)
    and every loss and statistic is finite."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

    expect = {k: expect.get(k, 0) for k in _build.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = lpm.train_linkpred(cfg, x, msg, n_node, split_edge=split_edge,
                             msg_edges=msg, log_every=1, device=dev, **kw)
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {tag}: launches {counts}, epoch s {[round(s, 4) for s in out['epoch_s']]}, "
        f"losses {out['epoch_loss']}, {out['last_results']}, peak {peak_gb:.2f} GiB "
        f"[{card_name}]")
    assert counts == expect, f"{tag} launched {counts}, expected {expect}"
    assert np.isfinite(out["epoch_loss"]).all(), out["epoch_loss"]
    assert all(np.isfinite(v) for v in out["stats"].values()), out["stats"]
    for k, v in counts.items():
        totals[k] += v
    return {"launches": counts, "epoch_s": out["epoch_s"],
            "epoch_loss": out["epoch_loss"], "results": out["last_results"],
            "peak_gib": peak_gb}


def linkpred_phase(card_name: str, totals: dict, dev) -> tuple:
    """Phase 7: I2-GTL link prediction at the ogbl-citation2 shape. Returns
    its numbers, the message edges, which phase 9 trains on, and the split,
    which phase 11 trains on."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    t_phase = time.perf_counter()
    split_edge, msg, split_s = lp_split(C2_NODES, C2_EDGES)
    # the JAX package's bench config (bench_linkpred.py:100-105) and the
    # reference's default; both train SAGE on the same message graph
    bench = link_bench_config()
    default = lpm.LinkPredConfig()
    t0 = time.perf_counter()
    g_host = lpm.link_graph(bench, msg, C2_NODES)
    csr_s = time.perf_counter() - t0
    g = g_host.to(dev)
    max_in = int((g_host.indptr[1:] - g_host.indptr[:-1]).max())
    log(f"  citation2-shape graph: n_node={g.n_node} message edges={g.n_edge} "
        f"max_in_degree={max_in}; host build: split {split_s:.1f} s, CSR pair "
        f"{csr_s:.1f} s")

    log("  (i) both kernels against the plain version on the citation2 graph, d=256")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_ms = {}
    for tag, gg in (("citation2 fwd", g), ("citation2 transposed", g.transpose())):
        x = torch.randn(gg.n_node, 256, generator=gen, device=dev)
        for name, fn, bf16 in (("spmm_csr_f32", K.spmm_csr_f32, False),
                               ("spmm_csr_bf16", K.spmm_csr_bf16, True)):
            kernel_ms[f"{name} {tag}"] = compare(name, fn, gg, x, bf16, card_name, tag,
                                                 reps=5)
        del x
    torch.cuda.empty_cache()
    log(f"  (i) the attention rows' kernel against the plain version, d={ATTN_D}")
    attn_rows = check_attn_rows(g, gen, card_name)
    torch.cuda.empty_cache()
    log(f"  (i) the pair-scoring kernel against the plain version, d={PAIR_D}")
    pair_dot = check_pair_dot(card_name, dev)
    torch.cuda.empty_cache()

    x = torch.randn(C2_NODES, C2_FEATS, generator=gen, device=dev)
    steps = 2 * 8
    log("  (ii) the bench config through train_linkpred: 2 epochs of 8 steps")
    # bf16 launches: 1 hoisted layer-1 aggregation, 2 per train step (layer-2
    # forward and its transposed backward), 1 per eval encode (layer 2); the
    # pair-scoring kernel once a split the eval scores (mrr: valid and test
    # positives and negatives)
    bench_run = run_linkpred(
        bench, x, split_edge, msg, C2_NODES,
        {"spmm_csr_bf16": 1 + 2 * steps + 1, "pair_dot_f32": 4},
        "bench config", card_name, totals, dev, epochs=2, eval_steps=2,
        max_steps_per_epoch=8)
    assert np.isfinite(bench_run["results"]["MRR"]).all()
    log("  (iii) the bench config's timed epoch and OGB-style eval")
    timed = lp_timed(bench, g, x, split_edge, msg, card_name, totals)
    torch.cuda.empty_cache()

    log("  (iv) LinkPredConfig() through train_linkpred: 2 epochs of 8 steps")
    # f32 launches: per step the layer-1 and layer-2 forwards and both
    # transposed backwards (the embedding trains), 2 per eval encode; the
    # pair-scoring kernel once a split the eval scores: under the default
    # recall_my@1.25 the valid and test positives and negatives and the
    # train positives
    default_run = run_linkpred(
        default, None, split_edge, msg, C2_NODES,
        {"spmm_csr_f32": 4 * steps + 2, "pair_dot_f32": SCORED_RECALL},
        "default config", card_name, totals, dev, epochs=2, eval_steps=2,
        max_steps_per_epoch=8)
    torch.cuda.empty_cache()

    log("  (v) one-step parity on the citation2 graph, kernels vs plain (dropout 0)")
    perm = np.random.default_rng(2).permutation(msg.shape[1])
    g_re = [lpm.link_graph(bench, msg[:, perm], C2_NODES).to(dev),
            row_shuffled(g, 3), row_shuffled(g, 4)]
    train_edges = split_edge["train"]["edge"]
    parity = {"bench": lp_parity(bench, g, g_re, x, train_edges, "bench"),
              "default": lp_parity(default, g, g_re,
                                   torch.zeros(C2_NODES, 1, device=dev),
                                   train_edges, "default")}
    del g_re, x
    torch.cuda.empty_cache()

    log("  (vi) GCN and Transformer at the bench shape: 2 steps each")
    split_b, msg_b, _ = lp_split(BENCH_NODES, BENCH_EDGES)
    others = {}
    # the Transformer a step: B1 once a layer forward (A_alpha v) and three
    # times backward (dv, dq, dk), the attention rows' kernels once a layer
    # each way; the eval encode the forward of both layers; the one eval's
    # five scored splits (recall_my) a pair-scoring launch each
    for kind, expect in (
            ("GCN", {"spmm_csr_f32": 2 * 4 + 2, "pair_dot_f32": SCORED_RECALL}),
            ("Transformer", {"spmm_csr_f32": 2 * 8 + 2, "pair_dot_f32": SCORED_RECALL,
                             "edge_attn_rows_f32": 2 * 4 + 2})):
        others[kind] = run_linkpred(
            lpm.LinkPredConfig(encoder=kind), None, split_b, msg_b, BENCH_NODES,
            expect, kind, card_name, totals, dev, epochs=1, max_steps_per_epoch=2)

    log("  (vii) --exp_mode=I2_GTL through the port's main (2,000-node stand-in)")
    _build.reset_launch_counts()
    cli = port_main.main(I2GTL_ARGS)[0]
    counts = _build.launch_counts("spmm_csr")
    assert not any(counts.values()), counts  # the dense product
    # 2 runs of 5 epochs, an eval an epoch, its five splits a launch each
    counts = _build.launch_counts("pair_dot")
    assert counts == {"pair_dot_f32": 2 * 5 * SCORED_RECALL}, counts
    totals["pair_dot_f32"] += counts["pair_dot_f32"]
    assert all(np.isfinite(v) for v in cli.values()), cli
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 7: {phase_s:.1f} s")

    return {"phase_s": phase_s, "n_node": C2_NODES, "n_msg_edges": g.n_edge, "max_in_degree": max_in,
            "host_build_s": {"split": split_s, "csr_pair": csr_s},
            "kernels_d256": kernel_ms, "attn_rows": attn_rows, "pair_dot": pair_dot,
            "bench": {**bench_run, "step_ms": bench_run["epoch_s"][1] / 8 * 1e3},
            "bench_timed": timed,
            "default": {**default_run,
                        "step_ms": default_run["epoch_s"][1] / 8 * 1e3},
            "parity": parity, "others": others, "cli": cli}, msg, split_edge


def reader_phase(card_name: str, totals: dict, root: str) -> dict:
    """Phase 8 (i): the full-size fake ogbn-arxiv raw set through the reader,
    prepare, and 3 epochs through main --data_root under auto."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.data.datasets import load_dataset, prepare
    from gnn_tail_generalization_tpu_torch.data.synthetic import write_fake_ogbn_arxiv_raw

    t0 = time.perf_counter()
    write_fake_ogbn_arxiv_raw(root)
    write_s = time.perf_counter() - t0
    cfg = build_config(**port_main.parse_args(READER_ARGS)[0])
    t0 = time.perf_counter()
    data = load_dataset(cfg, root)
    read_s = time.perf_counter() - t0
    assert data.name == "ogbn-arxiv", f"the reader did not fire: {data.name}"
    assert data.x.shape == (BENCH_NODES, 128) and data.x.dtype == np.float32
    assert int(data.y.max()) == 39 and int(data.train_mask.sum()) == 90941
    t0 = time.perf_counter()
    pd = prepare(data, cfg)
    prepare_s = time.perf_counter() - t0
    log(f"  fake ogbn-arxiv raw set: write {write_s:.2f} s, read {read_s:.2f} s, "
        f"prepare {prepare_s:.2f} s; {pd.n_node} nodes, {data.edge_index.shape[1]} "
        f"edges read, {pd.graph.n_edge} after the pipeline [{card_name} host]")
    _build.reset_launch_counts()
    res = port_main.main(READER_ARGS + [f"--data_root={root}"])[0]
    counts = _build.launch_counts("spmm_csr")
    expect = expected_launches(cfg, 3)
    log(f"  main --data_root: launches {counts}, step_ms "
        f"{[round(v, 3) for v in res.step_ms]} [{card_name}]")
    assert counts == expect, f"the reader-fed teacher launched {counts}, expected {expect}"
    assert res.records.shape == (3, 6) and np.isfinite(res.records).all(), res.records
    for k, v in counts.items():
        totals[k] += v
    return {"write_s": write_s, "read_s": read_s, "prepare_s": prepare_s,
            "n_edge": pd.graph.n_edge, "launches": counts, "step_ms": res.step_ms}


def i2gtl_phase(pd, card_name: str, totals: dict, slice_step_ms: dict) -> dict:
    """Phase 8 (ii): the I2-GTL teacher on the arxiv slice through main under
    both kernels, and one step of the f32 kernel against the plain version
    with fixed pairs."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.train import edgewise as ew

    out = {}
    for method in ("auto", "pallas_bf16"):
        argv = I2GTL_NODEC_ARGS + [f"--spmm_method={method}"]
        cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
        _build.reset_launch_counts()
        res = port_main.main(argv)[0]
        counts = _build.launch_counts("spmm_csr")
        # no loss-masked view under the edgewise loss: 2 launches a layer in
        # the train step (forward, transposed backward), 1 in the eval
        expect = expected_launches(cfg, 3)
        assert counts == expect, f"I2-GTL ({method}) launched {counts}, expected {expect}"
        assert res.columns[-2:] == ["linkp_train", "linkp_test"], res.columns
        mrr = res.records[:, -2:]
        assert np.isfinite(res.records).all() and (mrr > 0).all() and (mrr <= 1).all(), (
            res.records)
        for k, v in counts.items():
            totals[k] += v
        log(f"  I2-GTL nodeC ({method}): launches {counts}, linkp_train/test "
            f"{mrr.round(4).tolist()}, step_ms {[round(v, 3) for v in res.step_ms]} "
            f"(phase 3: {[round(v, 3) for v in slice_step_ms[method]]}) [{card_name}]")
        out[method] = {"launches": counts, "step_ms": res.step_ms,
                       "linkp": mrr.tolist()}
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(
        I2GTL_NODEC_ARGS)[0]), pd)
    plan = ew.build_edgewise_plan(cfg, pd)
    dev = torch.device("cuda")
    pairs = ew.draw_pairs(plan, ew.edgewise_consts(plan, dev),
                          torch.Generator(device=dev).manual_seed(0), "train")
    log("  one-step parity, I2-GTL, f32 kernel vs plain version, fixed pairs "
        "(dropout 0):")
    check_step_parity(cfg, pd, order_floor=True, pairs=pairs)
    return out


def edge_grad_phase(gb, card_name: str) -> dict:
    """Phase 8 (iii): spmm_edge_grad on the bench-shape graph at d=256, the
    f32 kernel (the reweighted graph has no plans) against the plain
    version: y, dx and dw, and the forward + backward ms."""
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm_edge_grad

    dev = torch.device("cuda")
    g = gb.to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(g.n_node, 256, generator=gen, device=dev)
    w = torch.rand(g.n_edge, generator=gen, device=dev)
    dy = torch.randn(g.n_node, 256, generator=gen, device=dev)

    def run(method):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = spmm_edge_grad(g, xx, ww, method)
        y.backward(dy)
        return y.detach(), xx.grad, ww.grad

    got, want = run("auto"), run("gather")
    rels = {k: rel_err(a, b) for k, a, b in zip(("y", "dx", "dw"), got, want)}
    del got, want
    ms = median_ms(lambda: run("auto"), reps=10)
    plain_ms = median_ms(lambda: run("gather"), reps=5)
    errs = {k: f"{v:.3e}" for k, v in rels.items()}
    log(f"  spmm_edge_grad, bench graph ({g.n_edge} edges) d=256: rel err {errs}, "
        f"forward + backward {ms:.4f} ms (plain version {plain_ms:.4f} ms) "
        f"[{card_name}]")
    assert all(v <= REL_TOL for v in rels.values()), rels
    return {"rel_err": rels, "ms": ms, "plain_ms": plain_ms}


def multiseed_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 8 (iv): --N_exp through main, each seed's records against
    train_teacher from that seed, bit for bit."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.train.loops import train_teacher

    argv = READER_ARGS + [f"--N_exp={N_EXP}"]
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = port_main.main(argv)
    run_s = time.perf_counter() - t0
    counts = _build.launch_counts("spmm_csr")
    expect = expected_launches(cfg, 3 * N_EXP)
    assert counts == expect, f"--N_exp={N_EXP} launched {counts}, expected {expect}"
    for k, v in counts.items():
        totals[k] += v
    same = []
    for s, res in enumerate(results):
        one = train_teacher(cfg, pd, cfg.random_seed + s, 3, device="cuda")
        same.append(bool(np.array_equal(res.records, one.records)))
    log(f"  --N_exp={N_EXP}: launches {counts}, run {run_s:.2f} s, each seed's "
        f"records bit-identical to a single train_teacher run: {same} [{card_name}]")
    assert len(results) == N_EXP and all(same), same
    return {"launches": counts, "run_s": run_s, "bit_identical": same}


def checkpoint_phase(pd, card_name: str, totals: dict, root: str) -> dict:
    """Phase 8 (v): a save_dir checkpoint read back onto the card, and a
    --prog run repeated."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN
    from gnn_tail_generalization_tpu_torch.train.checkpoint import load_train_state
    from gnn_tail_generalization_tpu_torch.train.loops import train_teacher

    dev = torch.device("cuda")
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(READER_ARGS)[0]), pd)
    _build.reset_launch_counts()
    res = train_teacher(cfg, pd, 0, 3, device=dev, save_dir=root)
    counts = _build.launch_counts("spmm_csr")
    assert counts == expected_launches(cfg, 3), counts
    for k, v in counts.items():
        totals[k] += v
    state = load_train_state(os.path.join(root, "teacherGNN.pt"), map_location=dev)
    g, x = pd.graph.to(dev), torch.as_tensor(pd.x, device=dev)
    outs = []
    for sd in (res.state_dict, state["params"]):
        model = TeacherGNN(cfg).to(dev)
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            outs.append(model(g, x)[1])
    same = bool(torch.equal(*outs))
    log(f"  save_dir round trip: state epoch {state['epoch']}, eval forward "
        f"bit-identical after the reload: {same} [{card_name}]")
    assert same and state["epoch"] == 3

    argv = READER_ARGS + ["--epochs=1", "--prog=0-1", f"--records_path={root}"]
    _build.reset_launch_counts()
    first = port_main.main(argv)
    first_counts = _build.launch_counts("spmm_csr")
    _build.reset_launch_counts()
    again = port_main.main(argv)
    again_counts = _build.launch_counts("spmm_csr")
    log(f"  --prog=0-1: first run launches {first_counts}, repeated run "
        f"{len(again)} results, launches {again_counts}")
    assert len(first) == 1 and first_counts == expected_launches(cfg, 1), first_counts
    assert again == [] and not any(again_counts.values()), again_counts
    for k, v in first_counts.items():
        totals[k] += v
    return {"reload_bit_identical": same, "prog_first_launches": first_counts,
            "prog_repeat_launches": again_counts}


def scratch_dir(prefix: str) -> str:
    """A new directory under the checkout's ``_chip/`` (gitignored); the
    caller removes it."""
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_chip")
    os.makedirs(scratch, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=scratch)


def cli_phase(gb, pd, card_name: str, totals: dict, slice_step_ms: dict) -> dict:
    """Phase 8: the rest of the single-device CLI on the card. Its files go
    to a directory under ``_chip/`` (gitignored), removed at the end."""
    t_phase = time.perf_counter()
    root = scratch_dir("phase8-")
    try:
        log("  (i) a full-size fake ogbn-arxiv raw set through the reader and main")
        readers = reader_phase(card_name, totals, os.path.join(root, "data"))
        torch.cuda.empty_cache()
        log("  (ii) --exp_mode=I2_GTL --task=nodeC on the arxiv slice")
        i2gtl = i2gtl_phase(pd, card_name, totals, slice_step_ms)
        log("  (iii) spmm_edge_grad against the plain version")
        edge_grad = edge_grad_phase(gb, card_name)
        torch.cuda.empty_cache()
        log(f"  (iv) --N_exp={N_EXP} through main")
        multiseed = multiseed_phase(pd, card_name, totals)
        log("  (v) a save_dir checkpoint and a repeated --prog run")
        ckpt = checkpoint_phase(pd, card_name, totals, os.path.join(root, "runs"))
    finally:
        shutil.rmtree(root)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 8: {phase_s:.1f} s")
    return {"phase_s": phase_s, "readers": readers, "i2gtl": i2gtl,
            "spmm_edge_grad": edge_grad, "multiseed": multiseed, "checkpoint": ckpt}


def row_shuffled(g, seed: int):
    """``g`` (on the card) with the edges of every row of both CSRs in
    another order: the same adjacency, summed in another order, in a few
    ms where a host rebuild from permuted edges (``reordered_graph``) takes
    9-16 s at 33M edges. Only the SpMM reads the result, so ``t_from_fwd``
    is left as it was."""
    from gnn_tail_generalization_tpu_torch.graph.core import edge_rows

    gen = torch.Generator(device=g.indptr.device).manual_seed(seed)

    def shuffle(indptr, indices, weight):
        rows = edge_rows(indptr, indices.numel()).double()
        order = torch.argsort(rows + torch.rand(rows.shape, generator=gen,
                                                device=rows.device, dtype=torch.float64))
        return indices[order].contiguous(), weight[order].contiguous()

    ix, w = shuffle(g.indptr, g.indices, g.weight)
    ix_t, w_t = shuffle(g.indptr_t, g.indices_t, g.weight_t)
    return dataclasses.replace(g, indices=ix, weight=w, indices_t=ix_t, weight_t=w_t)


def baseline_grads(model, args) -> tuple:
    """Loss and gradients (None where a parameter takes no part) of one
    train-mode step, no update, on a copy of ``model``."""
    model = copy.deepcopy(model).train()
    loss = model(*args)
    loss.backward()
    return loss.item(), {k: None if p.grad is None else p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def baseline_parity(tag, model, args, args_re) -> dict:
    """One step from ``model``'s weights through the f32 kernel against the
    plain version (``plain_kernels``), loss and every gradient within the
    larger of REL_TOL and 4x the plain step's own sum-order floor
    (``args_re``: the same inputs on ``row_shuffled``), as ``lp_parity``.
    The GIN layers' pre-batch-norm biases have a gradient that is zero up
    to rounding: both steps must keep it there (<= 1e-5 of the largest
    gradient), as the CPU tests hold it."""
    loss_k, grads_k = baseline_grads(model, args)
    with plain_kernels():
        loss_p, grads_p = baseline_grads(model, args)
        loss_f, grads_f = baseline_grads(model, args_re)
    scale = max(g.abs().max().item() for g in grads_p.values() if g is not None)
    rows = {"loss": (abs(loss_k - loss_p) / abs(loss_p), abs(loss_f - loss_p) / abs(loss_p))}
    rounding = []
    for k, gp in grads_p.items():
        if gp is None:  # no part in the loss (EGI's fc_m at two hops)
            assert grads_k[k] is None, (tag, k)
            continue
        assert torch.isfinite(grads_k[k]).all(), (tag, k)
        if k.endswith("dense.1.bias"):
            worst = max(grads_k[k].abs().max().item(), gp.abs().max().item())
            assert worst <= 1e-5 * scale, (tag, k, worst, scale)
            rounding.append(k)
            continue
        rows[k] = (rel_err(grads_k[k], gp), rel_err(grads_f[k], gp))
    log(f"  {tag}: loss kernel={loss_k:.8f} plain={loss_p:.8f}; rounding-level "
        f"(pre-batch-norm) gradients in both: {rounding}")
    for k, (rel, floor) in rows.items():
        bound = max(REL_TOL, 4 * floor)
        log(f"  {tag} {k:32s} rel={rel:.3e} order floor={floor:.3e} (bound {bound:.1e})")
        assert rel <= bound, (tag, k, rel, bound)
    return {k: {"rel": r, "floor": f} for k, (r, f) in rows.items()}


def expected_baseline_launches(alg: str, epochs: int) -> dict:
    """The f32 kernel's launches of ``gen_baseline_embs`` at more than 4,096
    nodes: per epoch, each two-layer GIN pass aggregates the features (no
    gradient, so no backward launch) and then the first layer's output
    (forward and transposed backward) -- DGI runs two passes, EGI one;
    VGAE's base aggregates the features, its two towers each the base's
    output (forward and backward). The final embedding is two forwards."""
    per_epoch = {"DGI": 2 * 3, "EGI": 3, "VGAE": 1 + 2 * 2}[alg]
    return {"spmm_csr_f32": per_epoch * epochs + 2, "spmm_csr_bf16": 0,
            "spmm_csr_plain": 0}


def baselines_phase(msg, gb, card_name: str, totals: dict, dev) -> dict:
    """Phase 9: the self-supervised baselines on the card."""
    from gnn_tail_generalization_tpu_torch.baselines import api, dgi, egi, vgae
    from gnn_tail_generalization_tpu_torch.baselines import pretrain_gin as pg
    from gnn_tail_generalization_tpu_torch.baselines import structure_pretrain as sp
    from gnn_tail_generalization_tpu_torch.baselines.egi_bound import egi_bound
    from gnn_tail_generalization_tpu_torch.graph.core import (
        build_graph, edge_rows, standard_pipeline)
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    t_phase = time.perf_counter()
    out = {"gen_baseline_embs": {}}
    log(f"  (i) gen_baseline_embs at the citation2 shape ({C2_NODES} nodes, "
        f"hidden {BASELINE_HIDDEN}, {BASELINE_EPOCHS} epochs, patience 20)")
    for alg in ("DGI", "EGI", "VGAE"):
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        embs = api.gen_baseline_embs(msg, C2_NODES, alg, hidden_dim=BASELINE_HIDDEN,
                                     epochs=BASELINE_EPOCHS, device=dev, stats=stats)
        run_s = time.perf_counter() - t0
        counts = _build.launch_counts("spmm_csr")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        expect = expected_baseline_launches(alg, stats["epochs_run"])
        width = 32 if alg == "VGAE" else BASELINE_HIDDEN
        epoch_ms = statistics.median(stats["epoch_ms"])
        sample_s = sum(stats.get("sample_s", []))
        log(f"  {alg}: embs {embs.shape}, {stats['epochs_run']} epochs (best "
            f"{stats['best_epoch']}), launches {counts}, median epoch {epoch_ms:.3f} ms, "
            f"losses first/last {stats['loss'][0]:.5f}/{stats['loss'][-1]:.5f}; host s: "
            f"pipeline {stats['pipeline_s']:.2f}, build {stats['build_s']:.2f}, flow "
            f"sampling {sample_s:.3f}; run {run_s:.1f} s, peak {peak_gib:.2f} GiB "
            f"[{card_name}]")
        assert embs.shape == (C2_NODES, width) and np.isfinite(embs).all(), alg
        assert counts == expect, f"{alg} launched {counts}, expected {expect}"
        for k, v in counts.items():
            totals[k] += v
        out["gen_baseline_embs"][alg] = {
            "epochs_run": stats["epochs_run"], "best_epoch": stats["best_epoch"],
            "launches": counts, "epoch_ms": stats["epoch_ms"], "median_epoch_ms": epoch_ms,
            "pipeline_s": stats["pipeline_s"], "build_s": stats["build_s"],
            "sample_s": sample_s, "run_s": run_s, "peak_gib": peak_gib}
        del embs
        torch.cuda.empty_cache()

    log("  (ii) one step each at the citation2 shape, f32 kernel vs plain version")
    t0 = time.perf_counter()
    e = standard_pipeline(msg, C2_NODES)
    g_host = build_graph(e, C2_NODES, with_dense=False, with_plans=True)
    x = torch.as_tensor(api.degree_bucketing(e, C2_NODES, BASELINE_HIDDEN), device=dev)
    host_s = time.perf_counter() - t0
    g = g_host.to(dev)
    g_re = row_shuffled(g, 5)
    log(f"  baseline graph: {g.n_edge} edges (message edges + self loops), host "
        f"pipeline + build {host_s:.1f} s")
    kernel_ms = {}
    gen = torch.Generator(device=dev).manual_seed(4)
    for d in (BASELINE_HIDDEN, 32):
        xd = torch.randn(C2_NODES, d, generator=gen, device=dev)
        kernel_ms[f"d={d}"] = compare("spmm_csr_f32", K.spmm_csr_f32, g, xd, False,
                                      card_name, "citation2 baseline fwd", reps=10)
    del xd
    n = C2_NODES
    perm = torch.randperm(n, generator=gen, device=dev)
    nprng = np.random.default_rng(0)
    flows = egi.sample_ego_flows(g_host.indptr.numpy(), g_host.indices.numpy(),
                                 nprng.choice(n, size=64, replace=False), 2, 5,
                                 nprng).to(dev)
    bidx = torch.randperm(n, generator=gen, device=dev)[:256]
    noise = torch.randn(n, 32, generator=gen, device=dev)
    init = torch.Generator().manual_seed(0)  # the weights are drawn on the host
    models = {"DGI": dgi.DGI(BASELINE_HIDDEN, BASELINE_HIDDEN, generator=init).to(dev),
              "EGI": egi.EGI(BASELINE_HIDDEN, BASELINE_HIDDEN, generator=init).to(dev),
              "VGAE": vgae.VGAE(BASELINE_HIDDEN, BASELINE_HIDDEN, 32, generator=init).to(dev)}
    extra = {"DGI": (perm,), "EGI": (flows, perm), "VGAE": (bidx, noise)}
    out["parity"] = {alg: baseline_parity(alg, m, (g, x, *extra[alg]), (g_re, x, *extra[alg]))
                     for alg, m in models.items()}
    out["kernel_ms"] = kernel_ms
    del g, g_re, x, models, noise, perm
    torch.cuda.empty_cache()

    log(f"  (iii) GIN pretraining and StructFeatPretrain at the bench shape "
        f"({gb.n_node} nodes, {gb.n_edge} edges)")
    e_b = np.stack([gb.indices.numpy(), edge_rows(gb.indptr, gb.n_edge).numpy()])
    x_b = api.degree_bucketing(e_b, gb.n_node, BASELINE_HIDDEN)
    out["pretrain_gin"] = {}
    for variant, per_epoch in (("masking", 3), ("contextpred", 6)):
        stats = {}
        _build.reset_launch_counts()
        embs, _ = pg.train_pretrain_gin(gb, x_b, variant, hidden_dim=BASELINE_HIDDEN,
                                        epochs=BASELINE_EPOCHS, device=dev, stats=stats)
        counts = _build.launch_counts("spmm_csr")
        # masking: one two-layer GIN pass an epoch; contextpred: the
        # substruct pass on the graph and the context pass on the union
        expect = {"spmm_csr_f32": per_epoch * BASELINE_EPOCHS + 2, "spmm_csr_bf16": 0,
                  "spmm_csr_plain": 0}
        epoch_ms = statistics.median(stats["epoch_ms"])
        ctx = f", context builder {stats['context_s']:.2f} s" if "context_s" in stats else ""
        log(f"  {variant}: launches {counts}, median epoch {epoch_ms:.3f} ms, loss "
            f"first/last {stats['loss'][0]:.5f}/{stats['loss'][-1]:.5f}{ctx} "
            f"[{card_name}]")
        assert counts == expect, f"{variant} launched {counts}, expected {expect}"
        assert torch.isfinite(embs).all() and np.isfinite(stats["loss"]).all(), variant
        for k, v in counts.items():
            totals[k] += v
        out["pretrain_gin"][variant] = {"launches": counts, "median_epoch_ms": epoch_ms,
                                        "context_s": stats.get("context_s")}
        del embs

    (gm, *pairs), host_s = timed(lambda: struct_pretrain_inputs(e_b, gb.n_node))
    n_b = gb.n_node
    model = sp.StructFeatPretrain(BASELINE_HIDDEN, BASELINE_HIDDEN,
                                  generator=torch.Generator().manual_seed(0)).to(dev)
    _build.reset_launch_counts()
    loss = model(gb.to(dev), gm.to(dev), torch.as_tensor(x_b, device=dev),
                 *(torch.as_tensor(a, device=dev) for a in pairs))
    loss.backward()
    counts = _build.launch_counts("spmm_csr")
    grads_ok = all(torch.isfinite(p.grad).all() for p in model.parameters())
    log(f"  StructFeatPretrain: loss {loss.item():.5f}, gradients finite {grads_ok}, "
        f"launches {counts}; host masked graph + centralities {host_s:.2f} s")
    # two two-layer GIN stacks on a trained input: forward and backward each
    assert counts == {"spmm_csr_f32": 8, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}, counts
    assert np.isfinite(loss.item()) and grads_ok
    for k, v in counts.items():
        totals[k] += v
    out["struct_pretrain"] = {"loss": loss.item(), "launches": counts, "host_s": host_s}

    log("  (iv) egi_bound between the bench graph and the citation2 graph, 64 pairs")
    t0 = time.perf_counter()
    bound_val = egi_bound(e_b, n_b, msg, C2_NODES, n_pairs=64)
    bound_s = time.perf_counter() - t0
    log(f"  egi_bound = {bound_val:.6f}, host {bound_s:.2f} s [{card_name} host]")
    assert np.isfinite(bound_val) and bound_val >= 0
    out["egi_bound"] = {"value": bound_val, "host_s": bound_s}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 9: {out['phase_s']:.1f} s")
    return out


def struct_pretrain_inputs(e: np.ndarray, n_node: int, half: int = 2048) -> tuple:
    """(the graph of ``e`` [2, E] with 30% of its edges masked, link edges
    [2 * half, 2] (``half`` of ``e`` then ``half`` random pairs), their
    labels, node pairs [2 * half, 2], their centrality labels): the inputs
    of one ``StructFeatPretrain`` step, drawn from a seed."""
    from gnn_tail_generalization_tpu_torch.baselines import structure_pretrain as sp
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph

    rng = np.random.default_rng(6)
    keep = rng.random(e.shape[1]) > 0.3
    gm = build_graph(e[:, keep], n_node, with_dense=False)
    cents = sp.compute_centralities(e, n_node)
    pos = e[:, rng.integers(0, e.shape[1], half)].T
    link_edges = np.concatenate([pos, rng.integers(0, n_node, (half, 2))])
    link_labels = np.concatenate([np.ones(half), np.zeros(half)]).astype(np.int32)
    pairs = rng.integers(0, n_node, (2 * half, 2))
    cent_labels = (cents[pairs[:, 0]] > cents[pairs[:, 1]]).astype(np.int32)
    return gm, link_edges, link_labels, pairs, cent_labels


def bucket_phase(edges: np.ndarray, gb, card_name: str) -> dict:
    """Phase 10 (i): the bench graph split over DIST_BUCKET_SHARDS shards in
    this process (no process group: the buckets are built per shard). Every
    bucket's kernels against the plain version, forward and transposed, at
    d=256 f32 and bf16; and each shard's ring-order sum of its buckets
    against the one-device kernel's rows of y = A @ x."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import build_dist_graph

    dev = torch.device("cuda")
    s, n = DIST_BUCKET_SHARDS, gb.n_node
    gen = torch.Generator(device=dev).manual_seed(10)
    t0 = time.perf_counter()
    shards = [build_dist_graph(edges, n, Comm(k, s, dev, "nccl")) for k in range(s)]
    build_s = time.perf_counter() - t0
    rows, n_pad = shards[0].rows_per_shard, shards[0].n_node_pad
    x = torch.zeros(n_pad, 256, device=dev)
    x[:n] = torch.randn(n, 256, generator=gen, device=dev)
    sizes = [[b.n_edge for b in g.buckets] for g in shards]
    log(f"  {s} shards of {rows} rows (n_node_pad {n_pad}), host build {build_s:.1f} s; "
        f"edges per bucket (k, j): {sizes}")
    worst = {"spmm_csr_f32": 0.0, "spmm_csr_bf16": 0.0}
    ring_err = {}
    for name, fn, bf16 in (("spmm_csr_f32", K.spmm_csr_f32, False),
                           ("spmm_csr_bf16", K.spmm_csr_bf16, True)):
        for tag, one, pick in (("fwd", gb, lambda g: g.buckets),
                               ("transposed", gb.transpose(), lambda g: g.buckets_t)):
            one = one.to(dev)
            y_one = fn(one.indptr, one.indices, one.weight, x[:n], schedule=one.schedule)
            y_ring = []
            for k, g in enumerate(shards):
                y = torch.zeros(rows, 256, device=dev)
                for t in range(s):  # the ring's order on shard k
                    j = (k + t) % s
                    b = pick(g)[j].to(dev)
                    blk = x[j * rows: (j + 1) * rows]
                    part = fn(b.indptr, b.indices, b.weight, blk, schedule=b.schedule)
                    ref = K.spmm_csr_plain(b.indptr, b.indices, b.weight, blk, bf16=bf16)
                    worst[name] = max(worst[name], rel_err(part, ref))
                    y += part
                y_ring.append(y)
            ring_err[f"{name} {tag}"] = rel_err(torch.cat(y_ring)[:n], y_one)
            del one, y_one, y_ring
    log(f"  every bucket's kernel vs plain, max rel err {worst}; ring-order sums vs "
        f"the one-device kernel {ring_err} [{card_name}]")
    assert all(v <= REL_TOL for v in (*worst.values(), *ring_err.values())), (
        worst, ring_err)
    del shards, x
    torch.cuda.empty_cache()
    return {"shards": s, "rows_per_shard": rows, "edges_per_bucket": sizes,
            "host_build_s": build_s, "bucket_rel_err": worst, "ring_rel_err": ring_err}


def expected_dist_launches(cfg, epochs: int, g, g_last) -> dict:
    """A rank's SpMM launches in ``epochs`` sharded teacher epochs, beside
    ``expected_launches``: per layer two SpMMs in the train step (forward,
    transposed backward; the last layer's on the loss-masked view
    ``g_last`` where there is one) and one in the eval forward, each a ring
    that launches one kernel a bucket of the rank that has an edge. The
    buckets keep their kernel under graph dropout (only their weights
    change), so every launch is the method's kernel."""
    def live(bs):
        return sum(b.n_edge > 0 for b in bs)

    fwd, bwd = live(g.buckets), live(g.buckets_t)
    per_epoch = cfg.num_layers * (2 * fwd + bwd)
    if g_last is not None:
        per_epoch += live(g_last.buckets) + live(g_last.buckets_t) - fwd - bwd
    counts = {"spmm_csr_f32": 0, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    kernel = "spmm_csr_bf16" if cfg.spmm_method == "pallas_bf16" else "spmm_csr_f32"
    counts[kernel] = per_epoch * epochs
    return counts


def fitted_like(argv, cfg):
    """The config of ``argv`` with the node, feature and class counts of the
    fitted ``cfg`` (a rank's prepared data holds only its rows)."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import apply_arch_configs, build_config

    return apply_arch_configs(dataclasses.replace(
        build_config(**port_main.parse_args(argv)[0]), N_nodes=cfg.N_nodes,
        num_feats=cfg.num_feats, num_classes=cfg.num_classes, dropout=0.0))


def timed_ms(fn, dev, reps: int = 10) -> float:
    """Median wall ms of ``fn`` on this rank, the card synchronized around
    each call (a ring waits for its neighbours, so device events alone
    would miss the host-staged hops)."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dist_step_grads(model, cfg, g, g_last, x, y, mask):
    """One sharded train step's loss (summed over the ranks) and this rank's
    gradients after the replicated ones are summed (no optimizer update)."""
    from gnn_tail_generalization_tpu_torch.train.loops import teacher_step_grads

    comm = g.comm
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = teacher_step_grads(cfg, model, g, x, y, mask, g_last=g_last)
    total = comm.all_reduce_sum_(loss.detach().clone()).item()
    return total, {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def dist_rank(comm, argv: list) -> dict:
    """Phase 10, one rank (started by ``parallel/launch.py:spawn``): the
    data of ``argv`` prepared for this rank and the sharded teacher trained
    in each of ``DIST_RUNS`` (launch counts read around each run); with
    more than one rank also the ring and the all-reduce timed, one
    kernel-vs-plain step, sharded DropEdge and the I2-GTL teacher. Runs on
    the rank's device (the CPU for a dry run of this function)."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import (
        dist_spmm, is_row_sharded)
    from gnn_tail_generalization_tpu_torch.train import loops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, dev = comm.world_size, comm.device
    t0 = time.perf_counter()
    base = build_config(**port_main.parse_args(argv)[0])
    # the edge view for DropEdge; no other run reads it
    cfg, pd = port_main.load_prepared(
        dataclasses.replace(base, apply_graph_dropout=True), "data", comm,
        rb=DIST_PAD // s)
    cfg = dataclasses.replace(cfg, apply_graph_dropout=False, dropout=0.0)
    # the global count of nodes behind each accuracy column
    train, sp = pd.train_mask, pd.splits
    sets = [train, pd.test_mask] + [m & ~train for m in (
        sp.large_deg_mask, sp.small_deg_mask, sp.zero_deg_mask)]
    n_sets = comm.all_reduce_sum_(torch.tensor([float(m.sum()) for m in sets], device=dev))
    out = {"rank": comm.rank, "prepare_s": time.perf_counter() - t0,
           "n_node_pad": pd.graph.n_node_pad, "n_sets": n_sets.cpu().numpy(), "runs": {}}

    def run(name, cfg_r, epochs):
        _build.reset_launch_counts()
        comm.counts.update(dict.fromkeys(comm.counts, 0))
        res = loops.train_teacher(cfg_r, pd, cfg_r.random_seed, epochs, device=dev)
        out["runs"][name] = {
            "records": res.records, "columns": res.columns, "step_ms": res.step_ms,
            "launches": _build.launch_counts("spmm_csr"), "comm": dict(comm.counts),
            "expected": expected_dist_launches(cfg_r, epochs, pd.graph,
                                               loops.final_agg_view(cfg_r, pd)),
            "visits": 3 * cfg_r.num_layers * epochs * s,
            "replicated": {k: v.cpu().numpy() for k, v in res.state_dict.items()
                           if not is_row_sharded(k)}}

    for name, (method, seed) in DIST_RUNS.items():
        run(name, dataclasses.replace(cfg, spmm_method=method,
                                      random_seed=cfg.random_seed + seed), DIST_EPOCHS)
    if s == 1:  # no collective to time
        return out
    g = pd.graph.to(dev)
    x = torch.randn(g.rows_per_shard, 256, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(comm.rank))
    out["ring_ms"] = {m: timed_ms(lambda: dist_spmm(g, x, m), dev)
                      for m in ("auto", "pallas_bf16")}
    n_rep = sum(v.size for v in out["runs"]["auto"]["replicated"].values())
    flat = torch.randn(n_rep, device=dev)
    out["all_reduce_ms"] = timed_ms(lambda: comm.all_reduce_sum_(flat), dev)
    out["all_reduce_floats"] = n_rep

    # one step, kernels vs plain versions, from the same weights
    cfg_k = dataclasses.replace(cfg, spmm_method="pallas")
    g_last = loops.final_agg_view(cfg_k, pd)
    g_last = None if g_last is None else g_last.to(dev)
    kernel_model = loops._teacher_model(cfg_k, 0, None, g).to(dev)
    plain_model = copy.deepcopy(kernel_model)
    for m in plain_model.modules():
        if hasattr(m, "spmm_method"):
            m.spmm_method = "gather"
    xs, ys = torch.as_tensor(pd.x, device=dev), torch.as_tensor(pd.y, device=dev)
    mask = torch.as_tensor(pd.train_mask, device=dev)
    loss_k, grads_k = dist_step_grads(kernel_model, cfg_k, g, g_last, xs, ys, mask)
    loss_p, grads_p = dist_step_grads(plain_model, cfg_k, g, g_last, xs, ys, mask)
    out["step_parity"] = {"loss": abs(loss_k - loss_p) / abs(loss_p),
                          **{k: rel_err(grads_k[k], grads_p[k]) for k in grads_p}}
    del kernel_model, plain_model, grads_k, grads_p

    run("DropEdge", fitted_like(argv + DIST_DROPEDGE, cfg), DIST_EXTRA_EPOCHS)
    run("I2-GTL", fitted_like(argv + DIST_I2GTL, cfg), DIST_EXTRA_EPOCHS)
    return out


def flipped_nodes(a: np.ndarray, b: np.ndarray, n_sets: np.ndarray) -> np.ndarray:
    """[epochs, columns]: the nodes whose argmax moved between two teacher
    records (their accuracy columns, in percent of ``n_sets`` nodes)."""
    return np.abs(a - b)[:, 1:] * n_sets / 100


def sharded_phase(edges: np.ndarray, gb, card_name: str, totals: dict) -> tuple:
    """Phase 10: the row-sharded teacher (``parallel/``) on the card. Returns
    its summary, and what phase 12 is held to: the S = 1 and S = 2 records
    of each run and the node counts behind each accuracy column."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import comm_volume_stats
    from gnn_tail_generalization_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    log(f"  (i) the bench graph in {DIST_BUCKET_SHARDS} shards: buckets vs plain, "
        f"ring-order sums")
    buckets = bucket_phase(edges, gb, card_name)
    two = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    runs, records = {}, {}
    for s, transport in ((1, "nccl"), (2, two)):
        where = ("one rank, no collectives" if s == 1 else
                 "over nccl, a card a rank" if transport == "nccl" else
                 "over gloo, 2 ranks on one card, host-staged")
        log(f"  (ii) S = {s} ({where}): {DIST_EPOCHS} epochs of each of "
            f"{list(DIST_RUNS)}, rb = {DIST_PAD // s}")
        t0 = time.perf_counter()
        ranks = spawn(dist_rank, s, transport, "cuda", SLICE_ARGS)
        spawn_s = time.perf_counter() - t0
        for r in ranks:
            for name, run in r["runs"].items():
                brief = (s, r["rank"], name, run["launches"], run["expected"], run["comm"])
                assert run["launches"] == run["expected"], brief
                # every SpMM visits S buckets: launched, or empty and skipped
                assert (sum(run["launches"].values()) + run["comm"]["skipped_buckets"]
                        == run["visits"]), brief
                assert np.isfinite(run["records"]).all(), (name, run["records"])
                # only the main path's runs count: the parity step came after
                for k, v in run["launches"].items():
                    totals[k] += v
        for name in ranks[0]["runs"]:
            states = [r["runs"][name]["replicated"] for r in ranks]
            same = all(np.array_equal(st[k], states[0][k])
                       for st in states[1:] for k in states[0])
            assert same, f"S={s} {name}: replicated parameters differ between ranks"
            recs = [r["runs"][name]["records"] for r in ranks]
            assert all(np.array_equal(rc, recs[0]) for rc in recs[1:]), name
        r0 = ranks[0]
        for name, run in r0["runs"].items():
            log(f"    {name:11s} launches/rank {run['launches']} ring shifts/rank "
                f"{run['comm']['ring_shifts']} all-reduces/rank "
                f"{run['comm']['all_reduces']} step_ms "
                f"{[round(v, 3) for v in run['step_ms']]} [{card_name}]")
        log(f"    n_node_pad {r0['n_node_pad']}, prepare {r0['prepare_s']:.1f} s a rank, "
            f"spawn to results {spawn_s:.1f} s; replicated parameters bit-equal "
            f"across ranks [{card_name}]")
        runs[s] = {"where": where, "spawn_s": spawn_s,
                   **{k: r0[k] for k in ("prepare_s", "n_node_pad")},
                   "runs": {name: {k: run[k] for k in ("step_ms", "launches", "comm")}
                            for name, run in r0["runs"].items()},
                   "ranks_launches": [r["runs"]["auto"]["launches"] for r in ranks]}
        if s > 1:
            log(f"    ring ms per SpMM (d=256, {where}) {r0['ring_ms']}; all-reduce of "
                f"{r0['all_reduce_floats']} floats {r0['all_reduce_ms']:.4f} ms "
                f"[{card_name}]")
            runs[s].update({k: r0[k] for k in ("ring_ms", "all_reduce_ms",
                                               "all_reduce_floats")})
            runs[s]["step_parity"] = [r["step_parity"] for r in ranks]
            for r in ranks:
                bad = {k: v for k, v in r["step_parity"].items() if v > REL_TOL}
                log(f"    rank {r['rank']}: one step, kernels vs plain, max rel diff "
                    f"{max(r['step_parity'].values()):.3e} (bound {REL_TOL:.0e})")
                assert not bad, bad
            for name in ("DropEdge", "I2-GTL"):
                run = r0["runs"][name]
                log(f"    {name}: columns {run['columns']} last "
                    f"{np.round(run['records'][-1], 4).tolist()}")
            mrr = r0["runs"]["I2-GTL"]["records"][:, -2:]
            assert r0["runs"]["I2-GTL"]["columns"][-2:] == ["linkp_train", "linkp_test"]
            assert (mrr > 0).all() and (mrr <= 1).all(), mrr
        records[s] = {m: r0["runs"][m]["records"] for m in DIST_RUNS}
    n_sets = ranks[0]["n_sets"]
    flipped = {}
    for m in DIST_RUNS:
        a, b = records[1][m], records[2][m]
        flips = flipped_nodes(a, b, n_sets)
        flipped[m] = flips.max(axis=0).tolist()
        log(f"  records S = 1 vs S = 2 ({m}): max |diff| {np.abs(a - b).max():.3e}, "
            f"loss rel {np.abs(a[:, 0] - b[:, 0]).max() / np.abs(a[:, 0]).max():.3e}, "
            f"nodes flipped per accuracy column {flips.max(axis=0).round(2).tolist()} "
            f"of {n_sets.astype(int).tolist()}")
        if DIST_RUNS[m][0] == "auto":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3, err_msg=f"S=1 vs S=2 {m}")
        else:
            # bf16 rounds each layer's operands: a sum-order change of ~1e-7
            # moves an operand next to a rounding boundary by 2^-8, which
            # can move a near-tied argmax; the loss holds 1e-4
            np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=1e-4, err_msg=m)
            assert flips.max() <= DIST_BF16_FLIPS, (m, flips)
    stats = {s: comm_volume_stats(edges, gb.n_node, s, d_feat=256, rb=DIST_PAD // s)
             for s in (2, 4)}
    for s, st in stats.items():
        log(f"  comm_volume_stats S = {s}, d = 256 f32: ring {st['ring_bytes_per_spmm']} "
            f"bytes per SpMM ({st['ring_bytes_per_chip_per_spmm']} a card), halo lower "
            f"bound {st['halo_bytes_lower_bound']} (ratio {st['ring_over_halo']:.2f})")

    log(f"  (iii) main --n_devices=2 ({two})")
    t0 = time.perf_counter()
    cli = port_main.main(DIST_CLI_ARGS + ([] if two == "nccl" else ["--dist_transport=gloo"]))
    cli_s = time.perf_counter() - t0
    rec = cli[0].records
    assert rec.shape == (2, 6) and np.isfinite(rec).all(), rec
    phase_s = time.perf_counter() - t_phase
    log(f"  cli: {cli_s:.1f} s, records {np.round(rec[-1], 4).tolist()}")
    log(f"  phase 10: {phase_s:.1f} s")
    return ({"phase_s": phase_s, "buckets": buckets, "runs": runs,
             "flipped_nodes": flipped, "comm_volume": stats, "cli_s": cli_s},
            {"records": records, "n_sets": n_sets})

def student_dist_launches(name: str, cfg, g, g_last, dad) -> dict:
    """A rank's SpMM launches in phase 11's run ``name``: SEMLP's teacher as
    ``expected_dist_launches`` plus one ring a layer for the SE-table
    forward; LP one ring a propagation on the DAD adjacency; the MLP
    students none. One launch a non-empty bucket a ring."""
    counts = {"spmm_csr_f32": 0, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    kernel = "spmm_csr_bf16" if cfg.spmm_method == "pallas_bf16" else "spmm_csr_f32"
    if name.startswith("SEMLP"):
        counts = expected_dist_launches(cfg, STUDENT_DIST_EPOCHS, g, g_last)
        counts[kernel] += cfg.num_layers * sum(b.n_edge > 0 for b in g.buckets)
    elif name.startswith("LP"):
        counts[kernel] = N_PROP * sum(b.n_edge > 0 for b in dad.buckets)
    return counts


def check_dist_replace(comm, cfg, pd, res) -> dict:
    """Phase 11 (i): ``dist_latent_replace`` at SEMLP's shape (the run's own
    [169343, 512] SE table, REPLACE_BATCH queries from part 1) against the
    one-device op on the whole table, gathered; its ms a call. A row may
    differ only where its K-th score is tied."""
    from gnn_tail_generalization_tpu_torch.models.semlp import SEMLPPart1
    from gnn_tail_generalization_tpu_torch.ops.topk_attention import (
        dist_latent_replace, latent_neighbor_replace)
    from gnn_tail_generalization_tpu_torch.train import loops
    from gnn_tail_generalization_tpu_torch.utils import debug

    dev, g = comm.device, pd.graph
    k = cfg.SEMLP_topK_2_replace
    se = loops.collect_teacher_se(cfg, pd, res.extra["teacher"].best_state_dict,
                                  device=dev)
    with torch.device("meta"):
        part1 = SEMLPPart1(cfg, se.shape[1])
    part1.load_state_dict(res.extra["part1"].state_dict, assign=True)
    part1.to(dev).eval()
    take = loops.make_take_rows(g)
    with torch.no_grad():
        x = torch.as_tensor(pd.x, device=dev)
        q = part1(take(x, torch.arange(REPLACE_BATCH, device=dev)))
        q = q * res.state_dict["alphas"][0]

    def op():
        return dist_latent_replace(g, q, se, k, g.n_node, g.rows_per_shard)

    got = op()
    ms = timed_ms(op, dev, reps=3)
    # one call recorded: a top-K launch a row chunk and one for the merge of
    # the shards' candidates, and no read back to the host
    debug.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        op()
    counters = debug.recorded()["counters"]
    debug.reset()
    want_calls = -(-REPLACE_BATCH // 8192) + 1
    assert counters == {"replace.select_calls": want_calls}, (counters, want_calls)
    full = comm.all_gather(se).reshape(-1, se.shape[1])[:g.n_node]
    out = {"table": list(full.shape), "batch": REPLACE_BATCH, "ms": ms,
           "counters": counters}
    if comm.shard == 0:
        want = latent_neighbor_replace(q, full, k)
        diff = (got - want).abs()
        rel = diff.amax(dim=1) / want.abs().amax(dim=1).clamp(min=1e-30)
        differ = (rel > REL_TOL).nonzero()[:, 0]
        for r in differ.tolist():  # explained only by a tie at the K-th place
            top = torch.topk(q[r] @ full.T, k + 1).values
            assert top[k - 1] == top[k], (r, top)
        out.update(max_abs_diff=float(diff.max()), rows_differ=int((diff.amax(1) > 0).sum()),
                   rows_beyond_tol=int(differ.numel()))
        if comm.world_size == 1:
            out["one_device_ms"] = median_ms(lambda: latent_neighbor_replace(q, full, k),
                                             reps=3, warmup=1)
    return out


def check_dist_propagation(comm, cfg, pd) -> dict:
    """Phase 11 (iii): one sharded LP run (N_PROP propagations at d = the
    classes) and C&S's stage pair on sharded DA / AD adjacencies, the
    kernels against ``plain_kernels()``."""
    from gnn_tail_generalization_tpu_torch.propagation import correlation as corr

    dev, g = comm.device, pd.graph
    nc = cfg.num_classes
    y = torch.as_tensor(pd.y, device=dev)
    idx = torch.as_tensor(pd.train_idx, device=dev)
    lp = cfg.lpStep
    adj = {w: corr.gen_normalized_dist_adj(pd.edge_index, g.n_node, comm, w, rb=g.rb).to(dev)
           for w in ("DAD", lp.A1, lp.A2)}
    full = torch.softmax(torch.randn(g.n_node_pad, nc, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(0)), 1)
    model_out = g.local_rows(full)

    def run():
        out = corr.label_propagation(y, idx, adj["DAD"], 0.5, N_PROP, nc)
        cs = corr.double_correlation_autoscale(
            y, model_out, idx, idx, adj[lp.A1], lp.alpha1, lp.num_propagations1,
            adj[lp.A2], lp.alpha2, lp.num_propagations2, nc)
        return (out,) + cs

    kern = run()
    with plain_kernels():
        plain = run()
    names = ("lp", "cs_corrected", "cs_smoothed")
    mine = torch.tensor([[float((a - b).abs().max()), float(b.abs().max())]
                         for a, b in zip(kern, plain)], device=dev)
    every = comm.all_gather(mine).amax(dim=0)  # the largest over the ranks
    return {"rel_err": {k: float(v[0] / v[1]) for k, v in zip(names, every)},
            "cs": [lp.fn, lp.A1, lp.A2]}


def link_bench_config(**kw):
    """Phase 7's bench config (``bench_linkpred_torch.py:bench_config``:
    SAGE + DOT, ``pallas_bf16``), with ``kw``."""
    from bench_linkpred_torch import bench_config

    return dataclasses.replace(bench_config(), **kw)


def dist_link_rank(comm, reset) -> dict:
    """Phase 11 (iv) at the bench shape, one rank: the bench config's
    widths at dropout 0 and in f32 (``auto``: under ``pallas_bf16`` each
    Dense layer rounds its input to bf16, so a 1e-7 sum-order change between
    S = 1 and S = 2 moves the MRR far past 1e-4) through
    ``train_linkpred(comm=...)``, LINK_STEPS steps an epoch, 2 epochs, a
    small eval split; then one step through the kernels against the plain
    versions, bounded by the plain step's own sum-order floor (the plain
    step on the one-device graph, which sums each row whole where the ring
    sums it a bucket at a time)."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

    dev, n = comm.device, BENCH_NODES
    split, msg, _ = lp_split(n, BENCH_EDGES)
    for part in ("valid", "test"):
        split[part] = {"edge": split[part]["edge"][:LINK_EVAL_POS],
                       "edge_neg": split[part]["edge_neg"][:LINK_EVAL_POS * EVAL_NEG]}
    cfg = link_bench_config(dropout=0.0, spmm_method="auto")
    x = torch.randn(n, C2_FEATS, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    reset()
    run = lpm.train_linkpred(cfg, x, msg, n, epochs=2, eval_steps=2, split_edge=split,
                             msg_edges=msg, max_steps_per_epoch=LINK_STEPS, comm=comm,
                             device=dev)
    launches, counts = _build.launch_counts("spmm_csr"), dict(comm.counts)
    g = lpm.link_dist_graph(cfg, msg, n, comm).to(dev)
    live = [sum(b.n_edge > 0 for b in bs) for bs in (g.buckets, g.buckets_t)]
    n_pos = len(split["train"]["edge"])
    bsz = min(cfg.batch_size, n_pos)
    steps = 2 * -(-min(n_pos, LINK_STEPS * bsz) // bsz)  # train_linkpred's n_steps
    # the hoisted aggregation, per step layer 2 forward and its transposed
    # backward, one eval encode (layer 2)
    expect = {"spmm_csr_f32": live[0] * (steps + 2) + live[1] * steps,
              "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    out = {"stats": run["stats"], "epoch_s": run["epoch_s"], "epoch_loss": run["epoch_loss"],
           "graph_build_s": run["graph_build_s"], "launches": launches,
           "expected": expect, "comm": counts}

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = lpm.LinkPredModel(cfg, n, C2_FEATS, generator=gen)
    pos = torch.as_tensor(split["train"]["edge"][:cfg.batch_size].astype(np.int64),
                          device=dev)
    b = pos.shape[0]
    neg = torch.randint(0, n, (b, cfg.num_neg, 2), generator=gen, device=dev)
    batch = (pos, neg, None, (torch.arange(b, device=dev) < b * 3 // 4).float())
    xl = lpm.shard_rows(x, g, dev)
    loss_k, grads_k = lp_grads(cfg, model, g, xl, batch)
    with plain_kernels():
        loss_p, grads_p = lp_grads(cfg, model, g, xl, batch)
        g_one = lpm.link_graph(cfg, msg, n).to(dev)
        loss_f, grads_f = lp_grads(cfg, model, g_one, x, batch)
    rows = {"loss": (abs(loss_k - loss_p) / abs(loss_p), abs(loss_f - loss_p) / abs(loss_p))}
    for k in grads_p:
        rows[k] = (rel_err(grads_k[k], grads_p[k]), rel_err(grads_f[k], grads_p[k]))
    out["step_parity"] = rows
    return out


def student_dist_rank(comm) -> dict:
    """Phase 11 (i)-(iv), one rank (started by ``parallel/launch.py:spawn``;
    S = 1 runs in the calling process, one rank with no collective): the
    arxiv slice prepared for this rank, each of ``STUDENT_DIST_RUNS``
    through ``run_experiment`` with the launch and collective counts read
    around it; then the replace op, the propagation parity and the sharded
    link prediction."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import is_row_sharded
    from gnn_tail_generalization_tpu_torch.propagation import correlation as corr
    from gnn_tail_generalization_tpu_torch.train import loops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, dev = comm.world_size, comm.device
    t0 = time.perf_counter()
    cfg0, pd = port_main.load_prepared(build_config(**port_main.parse_args(SEMLP_ARGS)[0]),
                                       "data", comm, rb=DIST_PAD // s)
    g = pd.graph
    dad = corr.gen_normalized_dist_adj(pd.edge_index, g.n_node, comm, "DAD", rb=g.rb)
    # the nodes behind each accuracy column (part 2's acc_test: one batch)
    train, sp = pd.train_mask, pd.splits
    sets = {"acc_train": train, "acc_test": pd.test_mask,
            "head": sp.large_deg_mask & ~train, "tail": sp.small_deg_mask & ~train,
            "iso": sp.zero_deg_mask & ~train}
    n_sets = comm.all_reduce_sum_(torch.tensor([float(m.sum()) for m in sets.values()],
                                               device=dev))
    out = {"rank": comm.rank, "prepare_s": time.perf_counter() - t0, "runs": {},
           "n_sets": dict(zip(sets, n_sets.tolist())),
           "batch": min(cfg0.batch_size, len(pd.train_idx))}

    def reset():
        _build.reset_launch_counts()
        comm.counts.update(dict.fromkeys(comm.counts, 0))

    semlp = None
    for name, (argv, method) in STUDENT_DIST_RUNS.items():
        cfg = dataclasses.replace(fitted_like(argv, cfg0), spmm_method=method)
        reset()
        res = loops.run_experiment(cfg, pd, cfg.random_seed, STUDENT_DIST_EPOCHS,
                                   device=dev)
        run = {"launches": _build.launch_counts("spmm_csr"), "comm": dict(comm.counts),
               "expected": student_dist_launches(name, cfg, g,
                                                 loops.final_agg_view(cfg, pd), dad)}
        if isinstance(res, dict):  # LP
            run["result"] = res
        else:
            phases = {"teacher": res.extra.get("teacher"), "part1": res.extra.get("part1"),
                      "part2": res}
            run["phases"] = {
                p: {"records": r.records, "columns": r.columns, "step_ms": r.step_ms,
                    "eval_ms": r.eval_ms,
                    "replicated": {k: v.cpu().numpy() for k, v in r.state_dict.items()
                                   if not is_row_sharded(k)}}
                for p, r in phases.items() if r is not None}
        out["runs"][name] = run
        if name == "SEMLP auto":
            semlp = (cfg, res)
    out["replace"] = check_dist_replace(comm, semlp[0], pd, semlp[1])
    out["propagation"] = check_dist_propagation(comm, cfg0, pd)
    out["link"] = dist_link_rank(comm, reset)
    return out


def link_c2_one_rank(card_name: str, split_edge, msg, phase7_step_ms: float,
                     totals: dict) -> dict:
    """Phase 11 (iv) at the citation2 shape, S = 1 in this process: the
    bench config through ``train_linkpred(comm=...)`` as phase 7 (ii) runs
    it, the host bucket build's seconds, the launches and the step ms."""
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm

    dev = torch.device("cuda")
    comm = Comm(0, 1, dev, "nccl")
    x = torch.randn(C2_NODES, C2_FEATS, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    _build.reset_launch_counts()
    run = lpm.train_linkpred(link_bench_config(), x, msg, C2_NODES, epochs=2, eval_steps=2,
                             split_edge=split_edge, msg_edges=msg, max_steps_per_epoch=8,
                             comm=comm, device=dev)
    counts = _build.launch_counts("spmm_csr")
    expect = {"spmm_csr_f32": 0, "spmm_csr_bf16": 1 + 2 * 16 + 1, "spmm_csr_plain": 0}
    step_ms = run["epoch_s"][1] / 8 * 1e3
    log(f"  (iv) citation2 shape, S = 1 (one rank, no collectives): host bucket build "
        f"{run['graph_build_s']:.1f} s, launches {counts}, epoch s "
        f"{[round(v, 4) for v in run['epoch_s']]}, step {step_ms:.3f} ms against phase "
        f"7's one-device {phase7_step_ms:.3f} ms, stats {run['stats']} [{card_name}]")
    assert counts == expect, (counts, expect)
    assert np.isfinite(run["epoch_loss"]).all() and all(
        np.isfinite(v) for v in run["stats"].values()), run
    for k, v in counts.items():
        totals[k] += v
    return {"graph_build_s": run["graph_build_s"], "epoch_s": run["epoch_s"],
            "step_ms": step_ms, "phase7_step_ms": phase7_step_ms, "launches": counts}


def sharded_students_phase(card_name: str, totals: dict, split_edge, msg,
                           phase7_step_ms: float) -> dict:
    """Phase 11: the sharded students, LP and C&S, and link prediction."""
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    link_c2 = link_c2_one_rank(card_name, split_edge, msg, phase7_step_ms, totals)
    del split_edge, msg
    torch.cuda.empty_cache()
    two = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    results = {}
    for s, transport in ((1, two), (2, two)):
        where = ("one rank, no collectives" if s == 1 else
                 "over nccl, a card a rank" if transport == "nccl" else
                 "over gloo, 2 ranks on one card, host-staged")
        log(f"  S = {s} ({where}), rb = {DIST_PAD // s}: {list(STUDENT_DIST_RUNS)}, "
            f"{STUDENT_DIST_EPOCHS} epochs a phase")
        t0 = time.perf_counter()
        ranks = ([student_dist_rank(Comm(0, 1, dev, transport))] if s == 1 else
                 spawn(student_dist_rank, s, transport, "cuda"))
        torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        for r in ranks:
            for name, run in r["runs"].items():
                assert run["launches"] == run["expected"], (s, r["rank"], name, run)
                for k, v in run["launches"].items():
                    totals[k] += v
            link = r["link"]
            assert link["launches"] == link["expected"], (s, r["rank"], link)
            for k, v in link["launches"].items():
                totals[k] += v
        r0 = ranks[0]
        for name, run in r0["runs"].items():  # replicated state and records
            if "phases" not in run:
                assert all(r["runs"][name]["result"] == run["result"] for r in ranks), name
                log(f"    {name:18s} {run['result']} launches/rank "
                    f"{[r['runs'][name]['launches'] for r in ranks]} [{card_name}]")
                continue
            for p, ph in run["phases"].items():
                assert np.isfinite(ph["records"]).all(), (name, p)
                for r in ranks[1:]:
                    other = r["runs"][name]["phases"][p]
                    assert np.array_equal(other["records"], ph["records"]), (name, p)
                    assert all(np.array_equal(other["replicated"][k], v)
                               for k, v in ph["replicated"].items()), (name, p)
                log(f"    {name:18s} {p:7s} step_ms "
                    f"{[round(v, 3) for v in ph['step_ms']]}"
                    + (f" eval_ms {[round(v, 3) for v in ph['eval_ms']]}"
                       if ph["eval_ms"] else "") + f" [{card_name}]")
            log(f"    {name:18s} launches/rank {[r['runs'][name]['launches'] for r in ranks]}"
                f", collectives/rank {r0['runs'][name]['comm']}")
        rep = r0["replace"]
        log(f"    (i) dist_latent_replace, table {rep['table']}, B={rep['batch']}: "
            f"{rep['ms']:.3f} ms a call"
            + (f" (one-device op {rep['one_device_ms']:.3f} ms)" if s == 1 else "")
            + f", one call recorded: {rep['counters']} (no host read)"
            + f"; against the one-device op: max abs diff {rep['max_abs_diff']:.3e}, "
            f"{rep['rows_differ']} rows differ, {rep['rows_beyond_tol']} beyond "
            f"{REL_TOL:.0e} (each a tie at the K-th place) [{card_name}]")
        prop = r0["propagation"]["rel_err"]
        log(f"    (iii) LP ({N_PROP} propagations) and C&S "
            f"{r0['propagation']['cs']}, kernels vs plain: {prop}")
        assert all(v <= REL_TOL for v in prop.values()), prop
        link = r0["link"]
        log(f"    (iv) bench-shape link prediction: host bucket build "
            f"{link['graph_build_s']:.1f} s, epoch s "
            f"{[round(v, 4) for v in link['epoch_s']]} ({LINK_STEPS} steps), stats "
            f"{link['stats']}, launches/rank {[r['link']['launches'] for r in ranks]} "
            f"[{card_name}]")
        for r in ranks:
            for k, (rel, floor) in r["link"]["step_parity"].items():
                bound = max(REL_TOL, 4 * floor)
                assert rel <= bound, (s, r["rank"], k, rel, bound)
        worst = max(r["link"]["step_parity"].items(), key=lambda kv: kv[1][0] /
                    max(REL_TOL, 4 * kv[1][1]))
        log(f"    one sharded step, kernels vs plain: worst {worst[0]} rel "
            f"{worst[1][0]:.3e} (order floor {worst[1][1]:.3e})")
        log(f"    S = {s}: {wall:.1f} s, prepare {r0['prepare_s']:.1f} s a rank")
        results[s] = {"where": where, "wall_s": wall, "ranks": ranks}

    one, two_r = results[1]["ranks"][0], results[2]["ranks"][0]
    flipped = {}  # run and phase -> the most nodes an accuracy column moved by
    for name, run in one["runs"].items():
        other = two_r["runs"][name]
        if "phases" not in run:  # LP: accuracies x100, rounded to 2 places
            nodes = {c: abs(other["result"][c] - v) * one["n_sets"][c] / 100
                     for c, v in run["result"].items()}
            flipped[name] = max(nodes.values())
        for p, ph in run.get("phases", {}).items():
            a, b = ph["records"], other["phases"][p]["records"]
            loss = [i for i, c in enumerate(ph["columns"]) if c.startswith("loss")]
            np.testing.assert_allclose(b[:, loss], a[:, loss], rtol=1e-4, atol=1e-3,
                                       err_msg=f"{name} {p}")
            count = dict(one["n_sets"], **({"acc_test": one["batch"]} if p == "part2"
                                           else {}))
            nodes = [np.abs(a[:, i] - b[:, i]) * count[c] / 100
                     for i, c in enumerate(ph["columns"]) if i not in loss]
            flipped[f"{name} {p}"] = float(max(v.max() for v in nodes)) if nodes else 0.0
    for key, moved in flipped.items():
        # bf16 rounds each layer's operands: a sum-order change of ~1e-7 can
        # move a near-tied argmax (phase 10); f32 moves none
        assert moved <= (DIST_BF16_FLIPS if "bf16" in key else 0), (key, moved)
    log(f"  records S = 1 vs S = 2: losses within 1e-4 / 1e-3; nodes an accuracy "
        f"column moved by, per run and phase {flipped}")
    for k in ("valid_mean", "test_mean"):
        a, b = one["link"]["stats"][k], two_r["link"]["stats"][k]
        assert abs(a - b) <= 1e-4 * abs(a), (k, a, b)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 11: {phase_s:.1f} s")
    return {"phase_s": phase_s, "link_c2_s1": link_c2, "flipped_nodes": flipped,
            **{f"S{s}": {"where": r["where"], "wall_s": r["wall_s"],
                         **{k: r["ranks"][0][k] for k in ("replace", "propagation",
                                                          "prepare_s")},
                         "link": {k: r["ranks"][0]["link"][k] for k in (
                             "stats", "epoch_s", "graph_build_s", "launches")},
                         "step_ms": {n: {p: ph["step_ms"] for p, ph in run["phases"].items()}
                                     for n, run in r["ranks"][0]["runs"].items()
                                     if "phases" in run}}
               for s, r in results.items()}}


def two_axis_buckets(edges: np.ndarray, n: int, card_name: str) -> dict:
    """Phase 12 (i) and (iv), in this process (the layouts as one rank sees
    them, no process group): both kernels against the plain version (1e-5
    relative) on an intra hier bucket (rank (0, 0), its host's other card),
    a cross hier bucket whose table is the halo host 1 ships to host 0
    (assembled from host 1's list, pads zero), and a 2-D bucket (graph shard
    0 of 2, source shard 1) at width 128 (a model shard's half of d = 256)
    and 20 (its half of 40 classes), with each launch's ms; and
    ``hier_comm_stats`` at d = 256."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import build_dist_graph
    from gnn_tail_generalization_tpu_torch.parallel.hier import (build_hier_graph,
                                                                 hier_comm_stats)
    from gnn_tail_generalization_tpu_torch.parallel.mesh import HOST_CHIP, DeviceMesh

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    h00, h10 = (build_hier_graph(edges, n, DeviceMesh.layout((2, 2), HOST_CHIP, p),
                                 rb=TWO_AXIS_RB["hier"]) for p in (0, 2))
    d0 = build_dist_graph(edges, n, Comm(0, 2, dev, "nccl"), rb=TWO_AXIS_RB["mesh_2d"])
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.zeros(h00.n_node_pad, 256, device=dev)
    x[:n] = torch.randn(n, 256, generator=gen, device=dev)
    rows, rows2 = h00.rows_per_shard, d0.rows_per_shard
    idx = h10.halo_idx[0].to(dev)  # host-local rows of host 1, -1 pads
    glob = (2 * rows + idx).clamp(0, h00.n_node_pad - 1)
    halo = torch.where((idx >= 0)[:, None], x[glob], torch.zeros((), device=dev))
    # tag -> (bucket, table, (whole width, model shard) of a column slice)
    cases = {"hier intra (0,0)<-(0,1) d=256": (h00.intra[1], x[rows: 2 * rows], None),
             "hier cross (0,0)<-host 1 halo d=256": (h00.cross[0], halo, None)}
    for d, shard in ((256, 0), (256, 1), (40, 0), (40, 1)):
        w = d // 2
        cases[f"2-D bucket (0,1) d={w} model shard {shard}"] = (
            d0.buckets[1], x[rows2: 2 * rows2, shard * w: (shard + 1) * w], (d, shard))
    out = {"host_build_s": build_s, "cases": {}}
    for tag, (b, table, whole) in cases.items():
        b = b.to(dev)
        table = table.contiguous()
        row = {"n_edge": b.n_edge, "table_rows": table.shape[0]}
        for name, fn, bf16 in (("spmm_csr_f32", K.spmm_csr_f32, False),
                               ("spmm_csr_bf16", K.spmm_csr_bf16, True)):
            got = fn(b.indptr, b.indices, b.weight, table, schedule=b.schedule)
            ref = K.spmm_csr_plain(b.indptr, b.indices, b.weight, table, bf16=bf16)
            row[name] = {"rel_err": rel_err(got, ref), "ms": median_ms(
                lambda: fn(b.indptr, b.indices, b.weight, table, schedule=b.schedule))}
            if whole is not None:
                d, shard = whole
                full = fn(b.indptr, b.indices, b.weight,
                          x[rows2: 2 * rows2, :d].contiguous(), schedule=b.schedule)
                w = d // 2
                row[name]["equal_to_whole_width"] = torch.equal(
                    got, full[:, shard * w: (shard + 1) * w])
        out["cases"][tag] = row
        same = ("" if whole is None else
                f"; bit-equal to those columns of the d={whole[0]} launch: f32 "
                f"{row['spmm_csr_f32']['equal_to_whole_width']} bf16 "
                f"{row['spmm_csr_bf16']['equal_to_whole_width']}")
        log(f"    {tag}: {b.n_edge} edges, f32 rel {row['spmm_csr_f32']['rel_err']:.2e} "
            f"{row['spmm_csr_f32']['ms']:.4f} ms, bf16 rel "
            f"{row['spmm_csr_bf16']['rel_err']:.2e} {row['spmm_csr_bf16']['ms']:.4f} ms"
            f"{same} [{card_name}]")
        assert max(row[k]["rel_err"] for k in ("spmm_csr_f32", "spmm_csr_bf16")) <= REL_TOL
        assert whole is None or all(row[k]["equal_to_whole_width"]
                                    for k in ("spmm_csr_f32", "spmm_csr_bf16")), tag
    out["hier_comm_stats"] = hier_comm_stats(h00, d_feat=256)
    log(f"    hier_comm_stats d = 256 f32: {out['hier_comm_stats']}; u_max {h00.u_max}, "
        f"halo rows unpadded {h00.dcn_rows} (transposed {h00.dcn_rows_t})")
    out["u_max"], out["u_max_t"] = h00.u_max, h00.transpose().u_max
    del h00, h10, d0, x, halo
    torch.cuda.empty_cache()
    return out


def hier_launches(cfg, epochs: int, g) -> dict:
    """A hier rank's launches in ``epochs`` teacher epochs: per layer a
    forward and a transposed backward in the train step (no loss-masked view
    on the two-level layout) and a forward in the eval, each launching one
    kernel a non-empty intra or cross bucket of the rank."""
    def live(d):
        return sum(b.n_edge > 0 for b in d.intra + d.cross)

    counts = {"spmm_csr_f32": 0, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    kernel = "spmm_csr_bf16" if cfg.spmm_method == "pallas_bf16" else "spmm_csr_f32"
    counts[kernel] = cfg.num_layers * (2 * live(g.fwd) + live(g.bwd)) * epochs
    return counts


def two_axis_rank(world, argv: list) -> dict:
    """Phase 12, one of four ranks (started by ``parallel/launch.py:spawn``):
    the slice of ``argv`` prepared on the (host, chip) mesh and on the
    (graph, model) mesh; per layout the teacher in each of ``DIST_RUNS``
    (launch counts and every communicator's counts read around each run);
    then one hier step through the kernels and the plain versions, and the
    plain step on a graph built from permuted edges (the sum-order floor),
    and the ms of a hier SpMM, its intra ring and halo exchange, and of a
    2-D SpMM at d = 256."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config
    from gnn_tail_generalization_tpu_torch.data.datasets import (
        load_dataset, prepare_hier, prepare_sharded)
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import is_row_sharded
    from gnn_tail_generalization_tpu_torch.parallel.hier import (
        build_hier_graph, halo_exchange, intra_ring)
    from gnn_tail_generalization_tpu_torch.parallel.mesh import (GRAPH_MODEL, HOST_CHIP,
                                                                 DeviceMesh)
    from gnn_tail_generalization_tpu_torch.train import loops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = world.device
    meshes = {"hier": DeviceMesh(world, (2, 2), HOST_CHIP),
              "mesh_2d": DeviceMesh(world, (2, 2), GRAPH_MODEL)}
    comms = [world] + [m.comm(a) for m in meshes.values() for a in m.names]
    t0 = time.perf_counter()
    base = build_config(**port_main.parse_args(argv)[0])
    data = load_dataset(base, "data")
    cfg = dataclasses.replace(port_main.fitted_to(base, data), dropout=0.0)
    pds = {"hier": prepare_hier(data, cfg, meshes["hier"], rb=TWO_AXIS_RB["hier"]),
           "mesh_2d": prepare_sharded(data, cfg, meshes["mesh_2d"],
                                      rb=TWO_AXIS_RB["mesh_2d"], model_axis="model")}
    out = {"rank": world.rank, "prepare_s": time.perf_counter() - t0,
           "coords": {k: m.coords for k, m in meshes.items()}, "runs": {}}
    for layout, pd in pds.items():
        for run, (method, seed) in DIST_RUNS.items():
            cfg_r = dataclasses.replace(cfg, spmm_method=method,
                                        random_seed=cfg.random_seed + seed)
            _build.reset_launch_counts()
            for c in comms:
                c.counts.update(dict.fromkeys(c.counts, 0))
            res = loops.train_teacher(cfg_r, pd, cfg_r.random_seed, TWO_AXIS_EPOCHS,
                                      device=dev)
            g = pd.graph
            expected = (hier_launches(cfg_r, TWO_AXIS_EPOCHS, g) if layout == "hier" else
                        expected_dist_launches(cfg_r, TWO_AXIS_EPOCHS, g,
                                               loops.final_agg_view(cfg_r, pd)))
            out["runs"][f"{layout} {run}"] = {
                "records": res.records, "columns": res.columns, "step_ms": res.step_ms,
                "launches": _build.launch_counts("spmm_csr"), "expected": expected,
                "comm": {f"{m}/{a}": dict(meshes[m].comm(a).counts)
                         for m in meshes for a in meshes[m].names},
                "state": {k: v.cpu().numpy() for k, v in res.state_dict.items()
                          if not is_row_sharded(k)}}

    # (iii) one hier step, kernels vs plain, and the plain step's order floor
    pd = pds["hier"]
    g = pd.graph.to(dev)
    perm = np.random.default_rng(1).permutation(pd.edge_index.shape[1])
    g_re = build_hier_graph(pd.edge_index[:, perm], pd.graph.n_node, meshes["hier"],
                            rb=TWO_AXIS_RB["hier"]).to(dev)
    cfg_k = dataclasses.replace(cfg, spmm_method="pallas")
    kernel_model = loops._teacher_model(cfg_k, 0, None, g).to(dev)
    plain_model = copy.deepcopy(kernel_model)
    for m in plain_model.modules():
        if hasattr(m, "spmm_method"):
            m.spmm_method = "gather"
    floor_model = copy.deepcopy(plain_model)
    xs, ys = torch.as_tensor(pd.x, device=dev), torch.as_tensor(pd.y, device=dev)
    mask = torch.as_tensor(pd.train_mask, device=dev)
    loss_k, grads_k = dist_step_grads(kernel_model, cfg_k, g, None, xs, ys, mask)
    loss_p, grads_p = dist_step_grads(plain_model, cfg_k, g, None, xs, ys, mask)
    loss_f, grads_f = dist_step_grads(floor_model, cfg_k, g_re, None, xs, ys, mask)
    out["step_parity"] = {
        k: {"rel": rel_err(grads_k[k], grads_p[k]), "floor": rel_err(grads_f[k], grads_p[k])}
        for k in grads_p}
    out["step_parity"]["loss"] = {"rel": abs(loss_k - loss_p) / abs(loss_p),
                                  "floor": abs(loss_f - loss_p) / abs(loss_p)}
    del kernel_model, plain_model, floor_model, grads_k, grads_p, grads_f, g_re

    # (iv) the ms of one d = 256 SpMM and its parts
    x = torch.randn(g.rows_per_shard, 256, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(world.rank))
    out["hier_ms"] = {
        "spmm auto": timed_ms(lambda: spmm(g, x, "auto"), dev, TWO_AXIS_REPS),
        "spmm pallas_bf16": timed_ms(lambda: spmm(g, x, "pallas_bf16"), dev,
                                     TWO_AXIS_REPS),
        "intra ring f32": timed_ms(lambda: intra_ring(g, x, K.spmm_csr_f32), dev,
                                   TWO_AXIS_REPS),
        "halo exchange": timed_ms(lambda: halo_exchange(g, x, 1), dev, TWO_AXIS_REPS)}
    g2 = pds["mesh_2d"].graph.to(dev)
    x2 = torch.randn(g2.rows_per_shard, 256, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(world.rank))
    out["mesh_2d_ms"] = {m: timed_ms(lambda: spmm(g2, x2, m), dev, TWO_AXIS_REPS)
                         for m in TWO_AXIS_METHODS}
    return out


def two_axis_phase(card_name: str, totals: dict, s1: dict, slice_columns: list) -> dict:
    """Phase 12: the two-axis layouts (``parallel/hier.py``, the 2-D mesh of
    ``parallel/distgraph.py``) on the card."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    cfg, pd = slice_data()
    log("  (i) buckets of both layouts vs plain; (iv) hier_comm_stats")
    buckets = two_axis_buckets(pd.edge_index, pd.n_node, card_name)
    del pd
    transport = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    where = ("over nccl, a card a rank" if transport == "nccl" else
             "over gloo, 4 ranks on one card, host-staged")
    log(f"  (ii)-(iv) 4 ranks {where}: hier (2, 2) rb = {TWO_AXIS_RB['hier']}, "
        f"2-D (2, 2) rb = {TWO_AXIS_RB['mesh_2d']}, {TWO_AXIS_EPOCHS} epochs of "
        f"{list(DIST_RUNS)} each")
    t0 = time.perf_counter()
    ranks = spawn(two_axis_rank, 4, transport, "cuda", SLICE_ARGS)
    spawn_s = time.perf_counter() - t0
    n_sets = s1["n_sets"]
    summary = {layout: {"where": where, "spawn_s": spawn_s, "runs": {}}
               for layout in ("hier", "mesh_2d")}
    for name in ranks[0]["runs"]:
        layout, run_name = name.split(" ", 1)
        method = DIST_RUNS[run_name][0]
        for r in ranks:
            run = r["runs"][name]
            assert run["launches"] == run["expected"], (name, r["rank"], run["launches"],
                                                        run["expected"])
            assert np.isfinite(run["records"]).all(), (name, run["records"])
            assert np.array_equal(run["records"], ranks[0]["runs"][name]["records"]), name
            for k, v in run["launches"].items():
                totals[k] += v
        # whole parameters bit-equal on every rank; a 2-D column slice on
        # the ranks of its model shard
        groups = ([ranks] if layout == "hier" else
                  [[r for r in ranks if r["coords"]["mesh_2d"]["model"] == m]
                   for m in range(2)])
        for grp in groups:
            st = [r["runs"][name]["state"] for r in grp]
            bad = [k for k in st[0] if not all(np.array_equal(o[k], st[0][k]) for o in st[1:])]
            assert not bad, (name, bad)
        run0 = ranks[0]["runs"][name]
        a, b = s1["records"][1][run_name][:TWO_AXIS_EPOCHS], run0["records"]
        flips = flipped_nodes(a, b, n_sets)
        flips_s2 = flipped_nodes(s1["records"][2][run_name][:TWO_AXIS_EPOCHS], b, n_sets)
        loss_rel = float(np.abs(a[:, 0] - b[:, 0]).max() / np.abs(a[:, 0]).max())
        log(f"    {name:25s} launches/rank {[r['runs'][name]['launches'] for r in ranks]} "
            f"step_ms {[round(v, 3) for v in run0['step_ms']]} [{card_name}]")
        log(f"      vs phase 10's S = 1: loss rel {loss_rel:.3e}, nodes flipped per "
            f"accuracy column {flips.max(axis=0).round(2).tolist()} (vs its S = 2: "
            f"{flips_s2.max(axis=0).round(2).tolist()}); comm counts rank 0 {run0['comm']}")
        if method == "auto":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=1e-4, err_msg=name)
            assert flips.max() <= DIST_BF16_FLIPS, (name, flips)
        summary[layout]["runs"][run_name] = {
            "step_ms": run0["step_ms"], "loss_rel_vs_s1": loss_rel,
            "flipped_nodes": flips.max(axis=0).tolist(),
            "flipped_nodes_vs_s2": flips_s2.max(axis=0).tolist(),
            "launches": [r["runs"][name]["launches"] for r in ranks],
            "comm": run0["comm"]}
    for r in ranks:
        worst = {k: v for k, v in r["step_parity"].items()
                 if v["rel"] > max(REL_TOL, 4 * v["floor"])}
        top = max(r["step_parity"].items(), key=lambda kv: kv[1]["rel"])
        log(f"    rank {r['rank']}: one hier step, kernels vs plain, max rel "
            f"{top[1]['rel']:.3e} ({top[0]}, order floor {top[1]['floor']:.3e})")
        assert not worst, worst
    summary["hier"]["step_parity"] = [r["step_parity"] for r in ranks]
    summary["hier"].update({k: ranks[0][k] for k in ("hier_ms", "prepare_s")})
    summary["mesh_2d"]["spmm_ms"] = ranks[0]["mesh_2d_ms"]
    summary["hier"].update(buckets)
    log(f"    ms a d = 256 SpMM ({where}): hier {ranks[0]['hier_ms']}, 2-D "
        f"{ranks[0]['mesh_2d_ms']} [{card_name}]")

    log(f"  (v) main --hier_mesh=2x2 ({transport})")
    t0 = time.perf_counter()
    cli = port_main.main(HIER_CLI_ARGS + ([] if transport == "nccl"
                                          else ["--dist_transport=gloo"]))
    cli_s = time.perf_counter() - t0
    rec = cli[0].records
    assert cli[0].columns == slice_columns, (cli[0].columns, slice_columns)
    assert rec.shape == (2, len(slice_columns)) and np.isfinite(rec).all(), rec
    summary["hier"]["cli_s"] = cli_s
    phase_s = time.perf_counter() - t_phase
    log(f"  cli: {cli_s:.1f} s, columns {cli[0].columns}, last "
        f"{np.round(rec[-1], 4).tolist()}")
    log(f"  phase 12: {phase_s:.1f} s")
    summary["hier"]["phase_s"] = summary["mesh_2d"]["phase_s"] = phase_s
    return summary


def timed(fn):
    """(fn(), host seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def same_arrays(a, b) -> bool:
    """Bit-equal, dtype included (numpy arrays or tensors, or None twice)."""
    if a is None or b is None:
        return a is None and b is None
    a, b = (np.asarray(x) for x in (a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def same_buckets(got, want) -> bool:
    """Two bucket sets equal slot for slot: indptr, indices, weight, ids."""
    return len(got) == len(want) and all(
        same_arrays(a.indptr, b[0]) and same_arrays(a.indices, b[1])
        and same_arrays(a.weight, b[2]) and same_arrays(a.gid, b[3])
        for a, b in zip(got, want))


def plain_dist_parts(e: np.ndarray, n: int, s: int, rb: int):
    """``build_dist_graph``'s plain code (unit weights, no edge view) timed by
    its parts: the canonical lexsort and the gathers and degrees, once;
    then for each rank the shard masks, each bucket's ``_csr`` and the row
    schedules. Returns (seconds by part, each rank's (forward, transposed)
    buckets as (indptr, indices, weight, None) tuples)."""
    from gnn_tail_generalization_tpu_torch.graph.core import _csr, build_schedule
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import round_up

    parts = {}
    can, parts["lexsort_s"] = timed(lambda: np.lexsort((e[0], e[1])))
    t0 = time.perf_counter()
    ec, w = e[:, can], np.ones(e.shape[1], np.float32)
    n_pad = round_up(n, s * rb)
    rows = n_pad // s
    for r in (0, 1):
        np.bincount(ec[r], minlength=n_pad)
    parts["gather_degrees_s"] = time.perf_counter() - t0
    src_shard, dst_shard = ec[0] // rows, ec[1] // rows
    buckets = []
    for k in range(s):
        lo = k * rows
        t0 = time.perf_counter()
        ids = {}
        for row_end, mine, col_shard in ((1, np.flatnonzero(dst_shard == k), src_shard),
                                         (0, np.flatnonzero(src_shard == k), dst_shard)):
            ids[row_end] = [mine[col_shard[mine] == j] for j in range(s)]
        parts[f"rank {k} masks_s"] = time.perf_counter() - t0
        sets, csr_s, sched_s = [], [], 0.0
        for row_end in (1, 0):
            out = []
            for j, b in enumerate(ids[row_end]):
                (ip, idx, wt, _), sec = timed(lambda: _csr(
                    ec[row_end, b] - lo, ec[1 - row_end, b] - j * rows, w[b], rows,
                    impl="plain"))
                csr_s.append(sec)
                sched_s += timed(lambda: build_schedule(ip.numpy()))[1]
                out.append((ip, idx, wt, None))
            sets.append(out)
        parts[f"rank {k} bucket_csr_s"] = csr_s
        parts[f"rank {k} schedules_s"] = sched_s
        buckets.append(tuple(sets))
    return parts, buckets


def host_builds(msg: np.ndarray, eb: np.ndarray, pd, card_name: str) -> tuple:
    """Phase 13 (i): the plain host builds by their parts, then each native
    build against its plain version, timed, bit for bit. Returns the
    numbers and the bench graph's edges, which (ii) scores."""
    from gnn_tail_generalization_tpu_torch import native
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import (
        _csr, add_self_loops, build_graph, remove_self_loops, symmetrize)
    from gnn_tail_generalization_tpu_torch.linkpred.edge_lp import build_edge_graph
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.parallel.distgraph import build_dist_graph

    out = {}
    n = C2_NODES
    log(f"  (i) build_dist_graph's plain parts at the citation2 shape ({msg.shape[1]} "
        f"message edges), S = {NATIVE_DIST_S}, both ranks (one lexsort)")
    parts, plain_buckets = plain_dist_parts(msg, n, NATIVE_DIST_S, NATIVE_DIST_RB)
    shown = {k: np.round(v, 3).tolist() for k, v in parts.items()}
    log(f"      plain parts, s: {shown} [{card_name}]")
    dist = {"plain_parts_s": parts, "native_s": [], "plain_rank_s": []}
    for k in range(NATIVE_DIST_S):
        g, sec = timed(lambda: build_dist_graph(msg, n, Comm(k, NATIVE_DIST_S, "cpu", "gloo"),
                                                rb=NATIVE_DIST_RB))
        plain_s = (parts["lexsort_s"] + parts["gather_degrees_s"]
                   + parts[f"rank {k} masks_s"] + sum(parts[f"rank {k} bucket_csr_s"])
                   + parts[f"rank {k} schedules_s"])
        equal = (same_buckets(g.buckets, plain_buckets[k][0])
                 and same_buckets(g.buckets_t, plain_buckets[k][1]))
        log(f"      rank {k}: native build_dist_graph {sec:.3f} s against the plain parts' "
            f"{plain_s:.3f} s; buckets bit-equal: {equal} [{card_name}]")
        assert equal, f"rank {k}: native buckets differ from the plain build"
        dist["native_s"].append(sec)
        dist["plain_rank_s"].append(plain_s)
        del g
    del plain_buckets
    out["build_dist_graph_citation2"] = dist

    e_slice = pd.edge_index
    rb4 = DIST_PAD // DIST_BUCKET_SHARDS
    slice4 = {"native_s": [], "plain_s": []}
    for k in range(DIST_BUCKET_SHARDS):
        comm = Comm(k, DIST_BUCKET_SHARDS, "cpu", "gloo")
        got, want = [], []
        for impl, keep, sink in (("native", got, slice4["native_s"]),
                                 ("plain", want, slice4["plain_s"])):
            g, sec = timed(lambda: build_dist_graph(e_slice, pd.graph.n_node, comm, rb=rb4,
                                                    with_edge_view=True, impl=impl))
            keep.append(g)
            sink.append(sec)
        a, b = got[0], want[0]
        equal = all(same_buckets(x, [(y.indptr, y.indices, y.weight, y.gid) for y in z])
                    for x, z in ((a.buckets, b.buckets), (a.buckets_t, b.buckets_t)))
        equal = equal and all(same_arrays(getattr(a.edge_view, f), getattr(b.edge_view, f))
                              for f in ("indptr", "indices", "weight"))
        assert equal, f"slice S = {DIST_BUCKET_SHARDS} rank {k}: native differs from plain"
    log(f"      the slice ({e_slice.shape[1]} edges) at S = {DIST_BUCKET_SHARDS}, every rank, "
        f"with the edge view: native {np.round(slice4['native_s'], 3).tolist()} s, plain "
        f"{np.round(slice4['plain_s'], 3).tolist()} s, buckets and views bit-equal "
        f"[{card_name}]")
    out["build_dist_graph_slice_s4"] = slice4

    log("  (i) _csr on the citation2 message edges, forward and transposed")
    csr = {}
    w = np.ones(msg.shape[1], np.float32)
    for tag, rows, cols in (("fwd", msg[1], msg[0]), ("transposed", msg[0], msg[1])):
        got, nat_s = timed(lambda: _csr(rows, cols, w, n))
        want, plain_s = timed(lambda: _csr(rows, cols, w, n, impl="plain"))
        equal = all(same_arrays(a, b) for a, b in zip(got, want))
        log(f"      {tag}: native {nat_s:.3f} s, plain {plain_s:.3f} s, bit-equal: {equal} "
            f"[{card_name}]")
        assert equal, f"_csr {tag}: native differs from plain"
        csr[tag] = {"native_s": nat_s, "plain_s": plain_s}
        del got, want
    out["csr_citation2"] = csr

    log("  (i) gen_baseline_embs's host part, plain: standard_pipeline's steps, then "
        "build_graph")
    base = {}
    e1, base["symmetrize_s"] = timed(lambda: symmetrize(msg, n))
    e2, base["remove_self_loops_s"] = timed(lambda: remove_self_loops(e1))
    e3, base["add_self_loops_s"] = timed(lambda: add_self_loops(e2, n))
    del e1, e2
    _, base["build_graph_plain_s"] = timed(lambda: build_graph(
        e3, n, with_dense=False, with_plans=True, impl="plain"))
    log(f"      {e3.shape[1]} edges, s: {base} (the native build: phase 9's build_s) "
        f"[{card_name}]")
    out["baseline_host"] = base
    del e3

    log(f"  (i) build_edge_graph on the bench graph's {BENCH_EDGES} edges")
    scored = np.ascontiguousarray(fast_powerlaw_graph(BENCH_NODES, BENCH_EDGES, 0).T)
    inc = np.bincount(scored.reshape(-1))
    eg = {}
    for cap in (ELP_CAP, None):
        got, nat_s = timed(lambda: build_edge_graph(scored, cap))
        want, plain_s = timed(lambda: native.edge_graph(scored[:, 0], scored[:, 1], cap, 0,
                                                        impl="plain"))
        equal = same_arrays(got, want)
        n_pairs = got.shape[1] - len(scored)
        n_capped = int((inc > cap).sum()) if cap else 0
        log(f"      max_degree={cap}: {n_pairs} pairs + {len(scored)} self loops, "
            f"{n_capped} capped nodes (max incidence {inc.max()}); native {nat_s:.3f} s, "
            f"plain {plain_s:.3f} s, bit-equal: {equal} [{card_name}]")
        assert equal, f"build_edge_graph max_degree={cap}: native differs from plain"
        eg[str(cap)] = {"pairs": n_pairs, "capped_nodes": n_capped, "native_s": nat_s,
                        "plain_s": plain_s}
        del got, want
    out["edge_graph_bench"] = eg
    return out, scored


def xmc_blocks(scored: np.ndarray, n_node: int) -> int:
    """run_xmc_lp's column blocks (of 128) over ``scored``: the distinct
    destinations of its distinct edges."""
    _, first = np.unique(scored[:, 0] * n_node + scored[:, 1], return_index=True)
    return -(-len(np.unique(scored[first, 1])) // 128)


@contextlib.contextmanager
def edge_graph_hook(built: dict, adj=None):
    """Around ``linkpred/edge_lp.py``'s runs: record the DAD edge graph a run
    builds on the host, and its seconds, in ``built``; or, with ``adj``
    given, hand the run that host graph in place of a new build (the plain
    run after the kernel run, on the same edges)."""
    from gnn_tail_generalization_tpu_torch.linkpred import edge_lp as elp

    saved = elp.build_edge_graph, elp._dad_edge_graph

    def record(edge_adj, m):
        g, built["dad_s"] = timed(lambda: saved[1](edge_adj, m))
        built["adj"] = g
        return g

    if adj is None:
        elp._dad_edge_graph = record
    else:
        elp.build_edge_graph = lambda *a, **k: None
        elp._dad_edge_graph = lambda edge_adj, m: adj
    try:
        yield
    finally:
        elp.build_edge_graph, elp._dad_edge_graph = saved


def elp_run(tag, fn, expect, card_name, totals) -> tuple:
    """One edge-LP entry point on the card, launches counted, then the same
    call on the plain version (on the host graph the first call built, where
    it built one), within REL_TOL relative. Returns its numbers and that
    host graph."""
    built = {}
    _build.reset_launch_counts()
    with edge_graph_hook(built):
        out, run_s = timed(lambda: (fn(), torch.cuda.synchronize())[0])
    counts = _build.launch_counts("spmm_csr")
    adj = built.get("adj")
    with plain_kernels(), (contextlib.nullcontext() if adj is None
                           else edge_graph_hook({}, adj)):
        ref = fn()
    err = rel_err(out, ref)
    expect = {k: expect.get(k, 0) for k in counts}
    log(f"      {tag}: {tuple(out.shape)}, {run_s:.3f} s (host build included"
        + (f", its DAD build {built['dad_s']:.3f} s" if adj is not None else "")
        + f"), launches {counts}, vs the plain SpMM rel err {err:.3e} [{card_name}]")
    assert torch.isfinite(out).all(), tag
    assert counts == expect, f"{tag} launched {counts}, expected {expect}"
    assert err <= REL_TOL, f"{tag}: rel err {err} > {REL_TOL}"
    for k, v in counts.items():
        totals[k] += v
    return {"run_s": run_s, "dad_s": built.get("dad_s"), "launches": counts,
            "rel_err": err}, adj


def edge_lp_phase(scored, eb, card_name, totals, dev) -> dict:
    """Phase 13 (ii): run_logit_lp, run_emb_lp and run_xmc_lp on the card,
    the kernel against the plain version, the SpMM and a propagation on the
    edge graph timed, and evaluate with each mode."""
    from gnn_tail_generalization_tpu_torch.linkpred import edge_lp as elp
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

    out = {}
    m = len(scored)
    gen = torch.Generator(device=dev).manual_seed(13)
    log(f"  (ii) edge LP over the bench graph's {m} edges (max_degree {ELP_CAP}), "
        f"{ELP_PROPS} propagations")
    logits = torch.randn(m, generator=gen, device=dev)
    out["run_logit_lp"], adj = elp_run(
        "run_logit_lp", lambda: elp.run_logit_lp(scored, logits, m // 2, 3 * m // 4,
                                                 max_degree=ELP_CAP),
        {"spmm_csr_f32": ELP_PROPS}, card_name, totals)
    h = torch.randn(BENCH_NODES, ELP_EMB_D, generator=gen, device=dev)
    out["run_emb_lp"], _ = elp_run(
        f"run_emb_lp (d = {ELP_EMB_D})",
        lambda: elp.run_emb_lp(scored, h, max_degree=ELP_CAP),
        {"spmm_csr_f32": ELP_PROPS}, card_name, totals)
    del h
    adj_d = adj.to(dev)
    log(f"      the edge graph: {adj.n_edge} edges over {m} rows")
    for d in (1, 2 * ELP_EMB_D):
        x = torch.rand(m, d, generator=gen, device=dev)
        r = compare("spmm_csr_f32", K.spmm_csr_f32, adj_d, x, False, card_name,
                    f"edge graph d={d}", reps=5)
        y0 = x.clamp(1e-9, 1 - 1e-9)
        prop_ms = median_ms(lambda: elp.yag_propagate(adj_d, y0, y0, 0.995, ELP_PROPS),
                            reps=3, warmup=1) / ELP_PROPS
        log(f"      d={d}: {prop_ms:.4f} ms a propagation (SpMM, axpy, clamp) [{card_name}]")
        out[f"spmm_d{d}"] = {**r, "propagation_ms": prop_ms}
        del x, y0
    del adj_d, adj
    torch.cuda.empty_cache()

    xs = scored[:XMC_SCORED]
    blocks = xmc_blocks(xs, BENCH_NODES)
    lx = torch.randn(XMC_SCORED, generator=gen, device=dev)
    out["run_xmc_lp"], _ = elp_run(
        f"run_xmc_lp ({XMC_SCORED} scored edges, {blocks} blocks of 128 columns, "
        f"the {eb.shape[1]}-edge bench graph)",
        lambda: elp.run_xmc_lp(eb, BENCH_NODES, xs, lx, XMC_SCORED // 2,
                               3 * XMC_SCORED // 4),
        {"spmm_csr_f32": blocks * ELP_PROPS}, card_name, totals)
    torch.cuda.empty_cache()

    split, msg_s, _ = lp_split(ELP_SPLIT_NODES, ELP_SPLIT_EDGES, ELP_SPLIT_POS, ELP_SPLIT_NEG)
    all_edges = np.concatenate([split[s][k] for s in ("train", "valid", "test")
                                for k in ("edge", "edge_neg") if k in split[s]])
    hub = int(np.bincount(all_edges.reshape(-1)).max())
    log(f"  (ii) evaluate with each edge_lp_mode: train_linkpred (LinkPredConfig(), "
        f"mrr), 1 epoch of 1 step on a {ELP_SPLIT_NODES}-node split, {len(all_edges)} "
        f"scored edges, the largest node on {hub}")
    assert hub > ELP_CAP, hub
    evals = {}
    for mode in ("logit", "emb", "xmc"):
        cfg = lpm.LinkPredConfig(edge_lp_mode=mode, eval_metric="mrr")
        # f32: 4 a step and 2 an eval encode (phase 7 (iv)), then the
        # propagations: one a column block of 128 in xmc mode; the pair-scoring
        # kernel once a split, five (the train positives guide the propagation)
        elp_n = ELP_PROPS * (xmc_blocks(all_edges, ELP_SPLIT_NODES) if mode == "xmc" else 1)
        expect = {**dict.fromkeys(_build.launch_counts("spmm_csr"), 0),
                  "spmm_csr_f32": 4 + 2 + elp_n, "pair_dot_f32": SCORED_RECALL}
        _build.reset_launch_counts()
        run = lpm.train_linkpred(cfg, None, msg_s, ELP_SPLIT_NODES, epochs=1,
                                 split_edge=split, msg_edges=msg_s, max_steps_per_epoch=1,
                                 device=dev)
        counts = {**_build.launch_counts("spmm_csr"), **_build.launch_counts("pair_dot")}
        mrr = run["last_results"]["MRR"]
        log(f"      {mode}: MRR {mrr}, launches {counts} [{card_name}]")
        assert np.isfinite(mrr).all(), (mode, mrr)
        assert counts == expect, f"evaluate {mode} launched {counts}, expected {expect}"
        for k, v in counts.items():
            totals[k] += v
        evals[mode] = {"MRR": mrr, "launches": counts}
    out["evaluate"] = evals
    return out


def native_phase(msg, eb, pd, card_name: str, totals: dict, dev) -> dict:
    """Phase 13: the host library and edge LP on the card."""
    t_phase = time.perf_counter()
    builds, scored = host_builds(msg, eb, pd, card_name)
    out = {"host_builds": builds}
    out["edge_lp"] = edge_lp_phase(scored, eb, card_name, totals, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['phase_s']:.1f} s")
    return out


def bespoke_inputs(pd) -> dict:
    """What phase 14 needs of the slice, as numpy: its edges (the loader's
    pipeline and isolation crafting applied), the edge list's degrees,
    features, labels and train mask."""
    from gnn_tail_generalization_tpu_torch.graph.core import degrees

    dout, din = degrees(pd.edge_index, pd.n_node)
    return {"edge_index": pd.edge_index, "n": pd.n_node, "x": pd.x,
            "y": pd.y.astype(np.int64), "train_mask": pd.train_mask,
            "deg_in": din, "deg_out": dout}


def bespoke_params(kind: str, inp: dict, n_node_pad: int) -> dict:
    """The whole initial parameters of the 1-D (``"1d"``) or 2-D teacher from
    ``BESPOKE_SEED``, cut to ``n_node_pad`` SE rows, the rows of padding
    zero (the same draws for every S)."""
    from gnn_tail_generalization_tpu_torch.parallel import distributed as D
    from gnn_tail_generalization_tpu_torch.parallel import tensor_parallel as TP

    n, n_feat, n_class = inp["n"], inp["x"].shape[1], int(inp["y"].max()) + 1
    shape = (BESPOKE_SEED, D.distgraph.round_up(n, 2), n_feat, BESPOKE_HIDDEN, n_class)
    p = D.init_dist_teacher(*shape) if kind == "1d" else TP.init_2d_teacher(*shape)
    p["se0"][n:] = 0
    p["se0"] = p["se0"][:n_node_pad]
    return p


def bespoke_batch(inp: dict, coords: dict, sizes: dict, dev) -> dict:
    """A rank's rows of the node arrays, padded to ``ceil(n / G) * G`` rows
    (G the graph axis's size)."""
    from gnn_tail_generalization_tpu_torch.parallel import distributed as D

    npad = D.distgraph.round_up(inp["n"], sizes["graph"])
    whole = {k: D.pad_rows(np.asarray(inp[k]), npad)
             for k in ("x", "y", "train_mask", "deg_in", "deg_out")}
    return D.local_slices(whole, D.batch_shardings(whole), coords, sizes, dev)


def bespoke_run(step, params, batch, sg, steps: int, dev) -> dict:
    """``steps`` SGD steps through ``step``, the launches read around them:
    the losses, each step's host ms (card synchronized), and after
    ``BESPOKE_SHARDED_STEPS`` steps this rank's blocks of the parameters
    other than the SE table and the SE block's squared norm."""
    _build.reset_launch_counts()
    losses, ms, held = [], [], None
    for i in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, loss = step(params, batch, sg)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == BESPOKE_SHARDED_STEPS:
            held = {"blocks": {k: v.cpu().numpy() for k, v in params.items() if k != "se0"},
                    "se_sq": float((params["se0"].double() ** 2).sum())}
    return {"losses": np.array(losses), "step_ms": ms,
            "launches": _build.launch_counts("spmm_csr"), **held}


def bespoke_launches(steps: int, dev) -> dict:
    """The SpMM launches of ``steps`` bespoke steps on a rank: 4 a step (two
    layers, forward and transposed backward) of the f32 kernel; of its plain
    version on the CPU (a dry run of these functions)."""
    counts = {"spmm_csr_f32": 0, "spmm_csr_bf16": 0, "spmm_csr_plain": 0}
    counts["spmm_csr_f32" if dev.type == "cuda" else "spmm_csr_plain"] = 4 * steps
    return counts


def spmm_and_grad(fn, x, ct) -> tuple:
    """(fn(x), d(fn(x) . ct)/dx)."""
    x = x.detach().clone().requires_grad_()
    y = fn(x)
    y.backward(ct)
    return y.detach(), x.grad


def csr_view(sg, transposed: bool):
    """A ``ShardedGraph``'s forward or transposed CSR in the form
    ``compare`` reads (square at S = 1)."""
    from types import SimpleNamespace

    t = "_t" if transposed else ""
    indptr = getattr(sg, "indptr" + t)
    return SimpleNamespace(indptr=indptr, indices=getattr(sg, "indices" + t),
                           weight=getattr(sg, "weight" + t),
                           schedule=getattr(sg, "schedule" + t),
                           n_node=indptr.numel() - 1, n_edge=sg.n_edge)


def bespoke_rank(comm, inp: dict) -> dict:
    """Phase 14 (iii), one of S ranks: both SpMMs at d = 256 and 40, forward
    and backward, against S = 1's ``dist_spmm`` on the same x; the 1-D step,
    ``BESPOKE_SHARDED_STEPS`` steps; the ms of one d = 256 all-gather,
    reduce-scatter and SpMM of each kind."""
    from gnn_tail_generalization_tpu_torch.parallel import distributed as D
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.utils.convert import dist_teacher_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, s, k = comm.device, comm.world_size, comm.shard
    t0 = time.perf_counter()
    ei, n = inp["edge_index"], inp["n"]
    sg = D.shard_graph(ei, n, s, k, device=dev)
    rg = D.shard_graph_ring(ei, n, comm, device=dev)
    sg1, one = D.shard_graph(ei, n, 1, 0, device=dev), Comm(0, 1, dev, comm.transport)
    npad, rows = sg.n_node_pad, sg.rows_per_shard
    assert rg.n_node_pad == npad, (rg.n_node_pad, npad)
    mine = slice(k * rows, (k + 1) * rows)
    out = {"rank": comm.rank, "device": dev, "shard": k, "n_node_pad": npad, "spmm": {},
           "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device=dev).manual_seed(14)
    for d in (256, 40):
        x, ct = (torch.randn(npad, d, generator=gen, device=dev) for _ in range(2))
        y1, dx1 = spmm_and_grad(lambda t: D.dist_spmm(sg1, t, one), x[:n], ct[:n])
        y1, dx1 = (torch.cat([t, t.new_zeros(npad - n, d)])[mine] for t in (y1, dx1))
        for name, fn in (("all-gather", lambda t: D.dist_spmm(sg, t, comm)),
                         ("ring", lambda t: D.dist_spmm_ring(rg, t))):
            y, dx = spmm_and_grad(fn, x[mine], ct[mine])
            out["spmm"][f"{name} d={d}"] = {"y": rel_err(y, y1), "dx": rel_err(dx, dx1)}
    coords, sizes = {"graph": k}, {"graph": s}
    batch = bespoke_batch(inp, coords, sizes, dev)
    params = dist_teacher_params(bespoke_params("1d", inp, npad), k, s, dev)
    step = D.make_dist_train_step(comm, BESPOKE_LR, BESPOKE_SE_REG)
    comm.counts.update(dict.fromkeys(comm.counts, 0))
    out["run"] = bespoke_run(step, params, batch, sg, BESPOKE_SHARDED_STEPS, dev)
    out["run"]["comm"] = dict(comm.counts)
    x = torch.randn(rows, 256, generator=gen, device=dev)
    full = torch.randn(npad, 256, generator=gen, device=dev)
    out["ms"] = {
        "all-gather": timed_ms(lambda: comm.all_gather(x), dev, BESPOKE_REPS),
        "reduce-scatter": timed_ms(lambda: comm.reduce_scatter_sum(full), dev, BESPOKE_REPS),
        "dist_spmm": timed_ms(lambda: D.dist_spmm(sg, x, comm), dev, BESPOKE_REPS),
        "dist_spmm_ring": timed_ms(lambda: D.dist_spmm_ring(rg, x), dev, BESPOKE_REPS)}
    # a rank receives S - 1 blocks in an all-gather and sends S - 1 in a
    # reduce-scatter, of R x 256 f32 each
    out["bytes_a_rank"] = (s - 1) * rows * 256 * 4
    return out


def bespoke_2d_rank(mesh, inp: dict) -> dict:
    """Phase 14 (iv), one of four ranks of the (graph 2, model 2) mesh: the
    2-D step, ``BESPOKE_SHARDED_STEPS`` steps."""
    from gnn_tail_generalization_tpu_torch.parallel import distributed as D
    from gnn_tail_generalization_tpu_torch.parallel import tensor_parallel as TP
    from gnn_tail_generalization_tpu_torch.utils.convert import teacher_2d_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, g = mesh.device, mesh.coords["graph"]
    sg = D.shard_graph(inp["edge_index"], inp["n"], mesh.shape["graph"], g, device=dev)
    batch = bespoke_batch(inp, mesh.coords, mesh.shape, dev)
    params = teacher_2d_params(bespoke_params("2d", inp, sg.n_node_pad), mesh.coords,
                               mesh.shape, dev)
    step = TP.make_2d_train_step(mesh, BESPOKE_LR, BESPOKE_SE_REG)
    run = bespoke_run(step, params, batch, sg, BESPOKE_SHARDED_STEPS, dev)
    run["comm"] = {a: dict(mesh.comm(a).counts) for a in mesh.names}
    return {"rank": mesh.rank, "device": dev, "coords": mesh.coords, "run": run}


def held_to(name: str, got: dict, want: dict, card_name: str) -> dict:
    """A sharded run's losses, parameters and SE norm against the one-rank
    run's within ``BESPOKE_REL``."""
    steps = BESPOKE_SHARDED_STEPS
    errs = {"losses": float(np.abs(got["losses"][:steps] - want["losses"][:steps]).max()
                            / np.abs(want["losses"][:steps]).max()),
            "se_sq": abs(got["se_sq"] - want["se_sq"]) / want["se_sq"],
            **{k: float(np.abs(got["blocks"][k] - v).max() / max(np.abs(v).max(), 1e-30))
               for k, v in want["blocks"].items()}}
    log(f"    {name}: losses {np.round(got['losses'], 6).tolist()}, step_ms "
        f"{[round(v, 3) for v in got['step_ms']]}; vs one rank: max rel "
        f"{max(errs.values()):.3e} (bound {BESPOKE_REL:.0e}) [{card_name}]")
    bad = {k: v for k, v in errs.items() if not v <= BESPOKE_REL}
    assert not bad, (name, bad)
    return errs


def bespoke_phase(pd, card_name: str, totals: dict, dev) -> dict:
    """Phase 14: the bespoke sharded teachers (``parallel/distributed.py``,
    ``parallel/tensor_parallel.py``) on the card."""
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.ops.spmm import spmm
    from gnn_tail_generalization_tpu_torch.parallel import distributed as D
    from gnn_tail_generalization_tpu_torch.parallel import tensor_parallel as TP
    from gnn_tail_generalization_tpu_torch.parallel.comm import Comm
    from gnn_tail_generalization_tpu_torch.parallel.launch import spawn
    from gnn_tail_generalization_tpu_torch.utils.convert import (dist_teacher_params,
                                                                 teacher_2d_params)

    t_phase = time.perf_counter()
    inp = bespoke_inputs(pd)
    n = inp["n"]
    one = Comm(0, 1, dev, "nccl")
    sg = D.shard_graph(inp["edge_index"], n, 1, 0, device=dev)
    g = pd.graph.to(dev)
    out = {"n_node": n, "n_edge": sg.n_edge, "spmm": {}}
    log(f"  (i) S = 1 (one rank, no collective): n_node_pad {sg.n_node_pad}, "
        f"{sg.n_edge} edges")
    gen = torch.Generator(device=dev).manual_seed(14)
    for d in (256, 40):
        x, ct = (torch.randn(n, d, generator=gen, device=dev) for _ in range(2))
        for tag, transposed in (("fwd", False), ("transposed", True)):
            compare("spmm_csr_f32", K.spmm_csr_f32, csr_view(sg, transposed), x, False,
                    card_name, f"bespoke S=1 {tag}", reps=10)
        y, dx = spmm_and_grad(lambda t: D.dist_spmm(sg, t, one), x, ct)
        y_ref, dx_ref = spmm_and_grad(lambda t: spmm(g, t, "auto"), x, ct)
        errs = {"y": rel_err(y, y_ref), "dx": rel_err(dx, dx_ref)}
        ms = {"fwd": median_ms(lambda: D.dist_spmm(sg, x, one), reps=10),
              "fwd+bwd": median_ms(lambda: spmm_and_grad(
                  lambda t: D.dist_spmm(sg, t, one), x, ct), reps=10)}
        log(f"    dist_spmm d={d} vs ops/spmm.spmm (one device): rel y {errs['y']:.3e} "
            f"dx {errs['dx']:.3e}; ms {ms} [{card_name}]")
        assert max(errs.values()) <= REL_TOL, (d, errs)
        out["spmm"][d] = {**errs, "ms": ms}
    del x, ct, y, dx, y_ref, dx_ref, g

    init = bespoke_params("1d", inp, n)
    (f_in, hidden), n_class = init["w0"].shape, init["w1"].shape[1]
    log(f"  (ii) make_dist_train_step at S = 1: {f_in} -> {hidden} -> {n_class}, SE on "
        f"layer 0, {BESPOKE_STEPS} SGD steps (lr {BESPOKE_LR}, se_reg {BESPOKE_SE_REG})")
    batch = bespoke_batch(inp, {"graph": 0}, {"graph": 1}, dev)
    params = dist_teacher_params(init, 0, 1, dev)
    s1 = bespoke_run(D.make_dist_train_step(one, BESPOKE_LR, BESPOKE_SE_REG), params,
                     batch, sg, BESPOKE_STEPS, dev)
    expect = bespoke_launches(BESPOKE_STEPS, dev)
    log(f"    losses {np.round(s1['losses'], 6).tolist()}, step_ms "
        f"{[round(v, 3) for v in s1['step_ms']]}, launches {s1['launches']} [{card_name}]")
    assert np.isfinite(s1["losses"]).all() and s1["losses"][-1] < s1["losses"][0], s1
    assert s1["launches"] == expect, (s1["launches"], expect)
    for kname, v in s1["launches"].items():
        totals[kname] += v

    def grads(method, graph):
        return D.sharded_grads(params, lambda p: D.dist_teacher_loss(
            one, graph, p, batch["x"], batch["y"], batch["train_mask"], batch["deg_in"],
            batch["deg_out"], BESPOKE_SE_REG, method), D.param_shardings(params), one)

    perm = np.random.default_rng(1).permutation(inp["edge_index"].shape[1])
    sg_re = D.shard_graph(inp["edge_index"][:, perm], n, 1, 0, device=dev)
    (lk, gk), (lp, gp), (lf, gf) = (grads("auto", sg), grads("gather", sg),
                                    grads("gather", sg_re))
    parity = {"loss": {"rel": rel_err(lk, lp), "floor": rel_err(lf, lp)},
              **{k: {"rel": rel_err(gk[k], gp[k]), "floor": rel_err(gf[k], gp[k])}
                 for k in gp}}
    top = max(parity.items(), key=lambda kv: kv[1]["rel"])
    log(f"    one step, kernel vs plain: max rel {top[1]['rel']:.3e} ({top[0]}, order "
        f"floor {top[1]['floor']:.3e})")
    bad = {k: v for k, v in parity.items() if v["rel"] > max(REL_TOL, 4 * v["floor"])}
    assert not bad, bad
    del sg_re, gk, gp, gf, params
    out["s1"] = {"losses": s1["losses"].tolist(), "step_ms": s1["step_ms"],
                 "launches": s1["launches"], "step_parity": parity}

    log(f"  the 2-D step on a 1 x 1 mesh (its one-rank run), "
        f"{BESPOKE_SHARDED_STEPS} steps")
    mesh1 = TP.make_2d_mesh(one, 1, 1)
    params = teacher_2d_params(bespoke_params("2d", inp, n), mesh1.coords, mesh1.shape, dev)
    s1_2d = bespoke_run(TP.make_2d_train_step(mesh1, BESPOKE_LR, BESPOKE_SE_REG), params,
                        batch, sg, BESPOKE_SHARDED_STEPS, dev)
    expect = bespoke_launches(BESPOKE_SHARDED_STEPS, dev)
    log(f"    losses {np.round(s1_2d['losses'], 6).tolist()}, step_ms "
        f"{[round(v, 3) for v in s1_2d['step_ms']]}, launches {s1_2d['launches']}")
    assert s1_2d["launches"] == expect, s1_2d["launches"]
    assert np.isfinite(s1_2d["losses"]).all()
    for kname, v in s1_2d["launches"].items():
        totals[kname] += v
    out["s1_2d"] = {"losses": s1_2d["losses"].tolist(), "step_ms": s1_2d["step_ms"]}
    del params, batch, sg
    torch.cuda.empty_cache()

    two = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    where = ("over nccl, a card a rank" if two == "nccl" else
             "over gloo, 2 ranks on one card, host-staged")
    log(f"  (iii) S = 2 ({where}): both SpMMs vs S = 1, the 1-D step "
        f"{BESPOKE_SHARDED_STEPS} steps")
    t0 = time.perf_counter()
    ranks = spawn(bespoke_rank, 2, two, "cuda", inp)
    out["s2"] = {"where": where, "spawn_s": time.perf_counter() - t0, "ranks": []}
    for r in ranks:
        worst = max(max(v.values()) for v in r["spmm"].values())
        log(f"    rank {r['rank']}: SpMMs vs S = 1, max rel {worst:.3e}: {r['spmm']}")
        assert worst <= REL_TOL, r["spmm"]
        run = r["run"]
        expect = bespoke_launches(BESPOKE_SHARDED_STEPS, r["device"])
        assert run["launches"] == expect, (r["rank"], run["launches"])
        for kname, v in run["launches"].items():
            totals[kname] += v
        assert np.array_equal(run["losses"], ranks[0]["run"]["losses"])
        log(f"    rank {r['rank']}: launches {run['launches']}, comm {run['comm']}; ms "
            f"{ {k: round(v, 3) for k, v in r['ms'].items()} } (d = 256, "
            f"{r['bytes_a_rank']} B a rank each way) [{card_name}]")
        out["s2"]["ranks"].append({k: r[k] for k in ("spmm", "ms", "bytes_a_rank",
                                                     "build_s")})
    whole = dict(ranks[0]["run"], se_sq=sum(r["run"]["se_sq"] for r in ranks))
    out["s2"]["vs_s1"] = held_to("S = 2 1-D step", whole, s1, card_name)
    out["s2"].update(losses=whole["losses"].tolist(), step_ms=whole["step_ms"])

    four = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    where = ("over nccl, a card a rank" if four == "nccl" else
             "over gloo, 4 ranks on one card, host-staged")
    log(f"  (iv) the 2-D step on a (graph 2, model 2) mesh ({where}), "
        f"{BESPOKE_SHARDED_STEPS} steps")
    t0 = time.perf_counter()
    ranks = spawn(bespoke_2d_rank, 4, four, "cuda", inp, mesh=((2, 2), ("graph", "model")))
    spawn_s = time.perf_counter() - t0
    blocks = {}
    for r in ranks:
        run = r["run"]
        expect = bespoke_launches(BESPOKE_SHARDED_STEPS, r["device"])
        assert run["launches"] == expect, (r["rank"], run["launches"])
        for kname, v in run["launches"].items():
            totals[kname] += v
        assert np.array_equal(run["losses"], ranks[0]["run"]["losses"])
        if r["coords"]["graph"] == 0:
            blocks[r["coords"]["model"]] = run["blocks"]
        log(f"    rank {r['rank']} at {r['coords']}: launches {run['launches']}, comm "
            f"{run['comm']}")
    cat = {"w0": 1, "b0": 0, "w1": 0}
    whole = dict(ranks[0]["run"], se_sq=sum(r["run"]["se_sq"] for r in ranks), blocks={
        k: (np.concatenate([blocks[m][k] for m in (0, 1)], axis=cat[k]) if k in cat
            else blocks[0][k]) for k in blocks[0]})
    out["mesh_2d"] = {"where": where, "spawn_s": spawn_s, "losses": whole["losses"].tolist(),
                      "step_ms": whole["step_ms"],
                      "vs_one_rank": held_to("2 x 2 2-D step", whole, s1_2d, card_name)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14: {out['phase_s']:.1f} s")
    return out


def run_twin(*argv: str) -> tuple:
    """``python3 <argv>`` from the checkout's root with the twins' timeout:
    (its JSON last line, parsed, and its seconds). Fails unless it exits 0."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-u", *argv],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=TWIN_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        log(out.stderr[-4000:])
        raise AssertionError(f"{' '.join(argv)} exited {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1]), secs


def bench_twins_phase(card_name: str, totals: dict) -> dict:
    """Phase 15: both bench twins in subprocesses; their lines checked, their
    launch counts added to ``totals``."""
    import bench_linkpred_torch as LP
    import bench_torch as BT


    t_phase = time.perf_counter()
    bench, bench_s = run_twin("bench_torch.py")
    print(json.dumps(bench), flush=True)
    log(f"  bench_torch.py: {bench_s:.1f} s; step_ms {bench['step_ms']:.4f} "
        f"(windows {[round(v, 4) for v in bench['step_ms_windows']]}), value "
        f"{bench['value']}, vs_baseline {bench['vs_baseline']:.3f}, dist_step_ms "
        f"{bench['dist_step_ms']:.4f}, dist rel diff {bench['dist_loss_rel_diff_max']:.3e} "
        f"[{card_name}]")
    assert np.isfinite(bench["value"]) and bench["value"] > 0, bench["value"]
    assert bench["dist_numerics_ok"] is True, bench["dist_loss_rel_diff_max"]
    timed = BT.WINDOWS * BT.TIMED_STEPS
    assert bench["timed_steps"] == timed, bench["timed_steps"]
    expect = dict.fromkeys(_build.launch_counts("spmm_csr"), 0)  # the twins report these
    expect["spmm_csr_bf16"] = 2 * bench["num_layers"] * timed
    for key in ("kernel_launches", "dist_kernel_launches"):
        log(f"  bench_torch.py {key}: {bench[key]}, expected {expect}")
        assert bench[key] == expect, (key, bench[key], expect)

    link, link_s = run_twin("bench_linkpred_torch.py")
    print(json.dumps(link), flush=True)
    ogb = link["ogb_1000neg_eval"]
    log(f"  bench_linkpred_torch.py: {link_s:.1f} s; step_ms {link['step_ms']:.4f}, "
        f"warm_epoch_s {link['warm_epoch_s']:.4f}, warm_eval_s {ogb['warm_eval_s']:.4f}, "
        f"mrr_test {link['mrr_test']:.4f}, OGB MRR {ogb['mrr']:.4f} [{card_name}]")
    assert np.isfinite(link["mrr_test"]), link["mrr_test"]
    assert 0 < ogb["mrr"] <= 1, ogb["mrr"]
    assert (link["warm_epoch_steps"], link["timed_epochs"]) == (LP.TIMED_STEPS,
                                                               LP.TIMED_EPOCHS)
    expect_lp = dict.fromkeys(_build.launch_counts("spmm_csr"), 0)
    expect_lp["spmm_csr_bf16"] = 2 * LP.TIMED_STEPS * LP.TIMED_EPOCHS
    log(f"  bench_linkpred_torch.py kernel_launches: {link['kernel_launches']}, "
        f"expected {expect_lp}")
    assert link["kernel_launches"] == expect_lp, (link["kernel_launches"], expect_lp)
    for counts in (bench["kernel_launches"], bench["dist_kernel_launches"],
                   link["kernel_launches"]):
        for k, v in counts.items():
            totals[k] += v
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 15: {phase_s:.1f} s")
    return {"phase_s": phase_s, "bench_torch": {**bench, "seconds": bench_s},
            "bench_linkpred_torch": {**link, "seconds": link_s}}


def profile_phase(pd, card_name: str, totals: dict) -> dict:
    """Phase 16: ``profile_step.py``'s ``PROFILE_CELLS`` in a subprocess;
    its JSON checked, its launch counts added to ``totals``."""
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch.config import build_config

    t_phase = time.perf_counter()
    out_dir = scratch_dir("phase16-")
    try:
        report, secs = run_twin("profile_step.py", *(a for c in PROFILE_CELLS
                                                      for a in ("--cell", c)),
                                "--out", out_dir)
    finally:
        shutil.rmtree(out_dir)
    log(f"  profile_step.py {' '.join(f'--cell {c}' for c in PROFILE_CELLS)}: {secs:.1f} s")
    trick, lp = PROFILE_CELLS
    argv = TRICK_BASE + TRICK_RUNS[trick]
    cfg = port_main.fitted_to(build_config(**port_main.parse_args(argv)[0]), pd)
    expect = {trick: expected_launches(cfg, report["epochs"]),
              lp: {**dict.fromkeys(_build.launch_counts("spmm_csr"), 0),
                   "spmm_csr_f32": N_PROP}}
    out = {}
    for name in PROFILE_CELLS:
        cell = out[name] = report["cells"][name]
        print(json.dumps(cell), flush=True)
        classes = sum(cell["by_class_ms"].values())
        top = sorted(cell["share"].items(), key=lambda kv: -kv[1])[:3]
        log(f"  {name}: step_ms {cell['step_ms']:.4f}, device ms a step "
            f"{cell['device_ms_per_step']:.4f}, launches a step "
            f"{cell['launches_per_step']:.1f}, idle share {cell['loop_idle_share']:.4f}, "
            f"window wall {cell['wall_ms']:.3f} ms, host-bound {cell['host_bound']}, top "
            f"classes {[(k, round(v, 4)) for k, v in top]} [{card_name}]")
        assert abs(classes - cell["device_ms"]) <= 1e-6 * cell["device_ms"], (
            name, classes, cell["device_ms"])
        assert 0 <= cell["loop_idle_share"] < 1, (name, cell["loop_idle_share"])
        log(f"  {name} kernel_launches {cell['kernel_launches']}, expected {expect[name]}")
        assert cell["kernel_launches"] == expect[name], (name, cell["kernel_launches"],
                                                        expect[name])
        for k, v in cell["kernel_launches"].items():
            totals[k] += v
    host_top = out[lp].get("host_top")
    log(f"  {lp} host, cumulative, of a {out[lp].get('host_wall_ms', float('nan')):.3f} ms "
        f"run under cProfile (unprofiled {out[lp]['wall_ms']:.3f} ms):")
    for r in host_top or []:
        log(f"    {r['s']:9.4f} s {r['share']:7.4f}  {r['function']}")
    assert host_top, f"{lp}: no host_top (host-bound {out[lp]['host_bound']})"
    assert all(0 <= r["share"] <= 1 for r in host_top), host_top
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 16: {phase_s:.1f} s")
    return {"phase_s": phase_s, "seconds": secs, **out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from gnn_tail_generalization_tpu_torch import main as port_main
    from gnn_tail_generalization_tpu_torch import native
    from gnn_tail_generalization_tpu_torch.data.synthetic import fast_powerlaw_graph
    from gnn_tail_generalization_tpu_torch.graph.core import (
        build_graph, standard_pipeline)
    from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K
    from gnn_tail_generalization_tpu_torch.train.loops import final_agg_view
    from gnn_tail_generalization_tpu_torch.utils.device import card

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = card()
    dev = torch.device("cuda")

    log("== phase 1: environment")
    log(f"card: {card_name}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    log(f"nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    log(f"kernels built into {_build.load()._name}")
    log(f"build_s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    log(f"host library built into {native.load()._name} "
        f"({time.perf_counter() - t0:.2f} s)")

    log("== phase 2: kernels vs plain versions on the card")
    t0 = time.perf_counter()
    n = BENCH_NODES
    eb = standard_pipeline(fast_powerlaw_graph(n, BENCH_EDGES, 0), n)
    gb = build_graph(eb, n, with_dense=False)
    max_in = int((gb.indptr[1:] - gb.indptr[:-1]).max())
    log(f"bench-shape graph: n_node={gb.n_node} n_edge={gb.n_edge} "
        f"max_in_degree={max_in} (host build {time.perf_counter() - t0:.1f} s)")
    cfg, pd = slice_data()
    g_last = final_agg_view(cfg, pd)
    log(f"slice graph: n_node={pd.graph.n_node} n_edge={pd.graph.n_edge}; "
        f"loss-masked view n_edge={g_last.n_edge}")
    gen = torch.Generator(device=dev).manual_seed(0)
    bg, sg = boundary_graph(), star_graph()
    log(f"degree-boundary graph: n_node={bg.n_node} n_edge={bg.n_edge}; star graph: "
        f"n_node={sg.n_node} n_edge={sg.n_edge}, {STAR_EDGES} edges into node 0")
    graphs = [("bench fwd", gb.to(dev), (256, 40)),
              ("bench transposed", gb.transpose().to(dev), (256, 40)),
              ("slice fwd", pd.graph.to(dev), (256,)),
              ("slice transposed", pd.graph.transpose().to(dev), (256,)),
              ("slice loss-masked fwd", g_last.to(dev), (256,)),
              ("slice loss-masked transp.", g_last.transpose().to(dev), (256,)),
              ("hub rows", hub_graph().to(dev), (16,)),
              ("degree boundary fwd", bg.to(dev), (256, 40, 16, 33)),
              ("degree boundary transp.", bg.transpose().to(dev), (256, 40, 16, 33)),
              ("star fwd", sg.to(dev), (256, 40)),
              ("star transposed", sg.transpose().to(dev), (256, 40))]
    kernels = (("spmm_csr_f32", K.spmm_csr_f32, False),
               ("spmm_csr_bf16", K.spmm_csr_bf16, True))
    stats = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS}
    for tag, g, widths in graphs:
        for d in widths:
            if tag.startswith("star"):
                # multiples of 1/8 in [-1, 1]: every partial sum of the
                # 1M-edge row is exact in f32, in any order
                x = torch.randint(-8, 9, (g.n_node, d), generator=gen, device=dev) / 8
            else:
                x = torch.randn(g.n_node, d, generator=gen, device=dev)
            for name, fn, bf16 in kernels:
                r = compare(name, fn, g, x, bf16, card_name, tag)
                st = stats[name]
                st["max_abs_err"] = max(st["max_abs_err"], r["max_abs_err"])
                st["max_rel_err"] = max(st["max_rel_err"], r["rel_err"])
                if tag == "bench fwd" and d == 256:
                    st.update({k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "share_of_bound")})
                if tag == "degree boundary fwd" and d == 40:
                    direct = fn(g.indptr, g.indices, g.weight, x)  # builds its schedule
                    same = torch.equal(direct, fn(g.indptr, g.indices, g.weight, x,
                                                  schedule=g.schedule))
                    log(f"  {name:14s} call without a schedule bit-identical: {same}")
                    assert same, f"{name}: the schedule built from indptr differs"
    del graphs, bg, sg  # gb (on the host) returns in phase 8
    torch.cuda.empty_cache()

    log("== phase 3: the slice through the port's main")
    launches, step_ms = {}, {}
    totals = dict.fromkeys(_build.LAUNCHES, 0)  # launches over every phase
    for method, kernel in (("auto", "spmm_csr_f32"),
                           ("pallas_bf16", "spmm_csr_bf16")):
        _build.reset_launch_counts()
        results = port_main.main(SLICE_ARGS + [f"--spmm_method={method}"])
        counts = _build.launch_counts("spmm_csr")
        log(f"  launch counts after --spmm_method={method}: {counts}")
        assert counts[kernel] > 0, f"{kernel} never launched on the slice"
        expect = {k: (counts[kernel] if k == kernel else 0) for k in counts}
        assert counts == expect, f"--spmm_method={method} launched {counts}"
        launches[kernel] = counts[kernel]
        rec = results[0].records
        assert rec.shape == (3, 6) and np.isfinite(rec).all(), rec
        for k, v in counts.items():
            totals[k] += v
        step_ms[method] = results[0].step_ms
        log(f"  step_ms ({method}) = {step_ms[method]} [{card_name}]")
    log("  one-step parity, f32 kernel vs plain version (dropout 0):")
    check_step_parity(cfg, pd)

    log("== phase 4: the Cold Brew student")
    student = student_phase(pd, launches["spmm_csr_f32"], card_name, totals)

    log("== phase 5: the trick zoo through the port's main")
    tricks = trick_phase(pd, card_name, totals)

    log("== phase 6: label propagation and Correct & Smooth")
    propagation = propagation_phase(pd, card_name, totals)
    torch.cuda.empty_cache()

    log("== phase 7: link prediction at the ogbl-citation2 shape")
    linkpred, msg, split_edge = linkpred_phase(card_name, totals, dev)
    torch.cuda.empty_cache()

    log("== phase 8: the reader, the I2-GTL teacher, multi-seed, checkpoints")
    cli = cli_phase(gb, pd, card_name, totals, step_ms)
    torch.cuda.empty_cache()

    log("== phase 9: the self-supervised baselines")
    baselines = baselines_phase(msg, gb, card_name, totals, dev)
    torch.cuda.empty_cache()

    log("== phase 10: the row-sharded teacher")
    sharded, s1_reference = sharded_phase(eb, gb, card_name, totals)

    log("== phase 11: the sharded students, LP and C&S, link prediction")
    students_dist = sharded_students_phase(card_name, totals, split_edge, msg,
                                           linkpred["bench"]["step_ms"])
    del split_edge

    log("== phase 12: the two-axis layouts (hier host x card, 2-D graph x model)")
    two_axis = two_axis_phase(card_name, totals, s1_reference, results[0].columns)

    log("== phase 13: the host library (native/) and edge LP")
    host_lib = native_phase(msg, eb, pd, card_name, totals, dev)
    del msg
    torch.cuda.empty_cache()

    log("== phase 14: the bespoke sharded teachers (all-gather SpMM, 1-D and 2-D SGD)")
    bespoke = bespoke_phase(pd, card_name, totals, dev)
    torch.cuda.empty_cache()

    log("== phase 15: the bench twins (bench_torch.py, bench_linkpred_torch.py)")
    twins = bench_twins_phase(card_name, totals)

    log(f"== phase 16: the profiler (profile_step.py, cells {', '.join(PROFILE_CELLS)})")
    profile = profile_phase(pd, card_name, totals)

    assert totals["spmm_csr_plain"] == 0 and totals["edge_attn_rows_plain"] == 0, totals
    stats["edge_attn_rows_f32"].update(linkpred["attn_rows"])
    stats["pair_dot_f32"].update({k: v for k, v in linkpred["pair_dot"].items()
                                  if k not in ("positives", "negatives")})
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": totals[name], **stats[name]}
               for name, (replaces, source) in KERNELS.items()]
    print(json.dumps({"kernels": kernels, "step_ms": step_ms,
                      "student": student, "trick_step_ms": tricks,
                      "propagation": propagation, "linkpred": linkpred,
                      "cli": cli, "baselines": baselines, "sharded": sharded,
                      "sharded_students": students_dist, **two_axis,
                      "native": host_lib, "bespoke": bespoke, "bench_twins": twins,
                      "profile": profile, "card": card_name}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
