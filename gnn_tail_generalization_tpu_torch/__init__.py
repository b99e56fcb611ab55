"""PyTorch + CUDA port of gnn_tail_generalization_tpu (Cold Brew, ICLR 2022).

The JAX package ``gnn_tail_generalization_tpu`` stays the reference; this
package mirrors its layout, imports ``torch``, ``numpy`` and ``scipy`` only,
and carries its own copies of the host-side code it needs. Everything the
JAX package does on one device is ported; the multi-device layer comes
last. Every SpMM runs on hand-written CUDA kernels (``csrc/spmm_csr.cu``,
bound in ``ops/spmm_kernels.py``). Every entry point runs on the card
(``device="cuda"``) unless its caller asks for the CPU, and raises where
torch finds no card (``utils/device.py``).

- ``graph/``     CSR graph container, host-side construction, degree analysis
- ``native/``    host C++ (built by g++ at first use): the CSR sorts, the
                 row-sharded buckets, the edge-LP edge graph
- ``data/``      the Planetoid/OGB/WebKB raw readers, synthetic stand-ins and
                 fake raw-set writers, the preparation pipeline
- ``ops/``       SpMM (dense, plain, CUDA f32 and bf16 kernels) with autograd,
                 its edge-weight and degree-normalized forms, SDDMM scores;
                 the students' latent-neighbour search
- ``nn/``        GCN conv with Structural Embeddings, the trick zoo, backbone,
                 the MLP stacks
- ``models/``    TeacherGNN, the SEMLP parts, StudentBaseMLP, GraphMLP
- ``propagation/`` label propagation, Correct & Smooth
- ``linkpred/``  I2-GTL link prediction
- ``baselines/`` the self-supervised baselines (DGI, EGI, VGAE, GIN and
                 structural pretraining, MI measures, the EGI bound) and
                 ``gen_baseline_embs``
- ``train/``     the teacher (with the I2-GTL edgewise loss) and student
                 loops, multi-seed runs, checkpoints, Adam, head/tail/iso eval
- ``utils/``     flax -> torch parameter conversion, batch-run records,
                 profiler traces and NaN guards, the entry points' device
"""

__version__ = "0.1.0"
