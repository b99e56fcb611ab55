"""PyTorch + CUDA port of gnn_tail_generalization_tpu (Cold Brew, ICLR 2022).

The JAX package ``gnn_tail_generalization_tpu`` stays the reference; this
package mirrors its layout, imports ``torch``, ``numpy`` and ``scipy`` only,
and carries its own copies of the host-side code it needs. Ported so far: the
TeacherGNN full-graph training path, whose SpMM runs on hand-written CUDA
kernels (``csrc/spmm_csr.cu``, bound in ``ops/spmm_kernels.py``), and the
Cold Brew students (SEMLP, StudentBaseMLP, GraphMLP).

- ``graph/``   CSR graph container, host-side construction, degree analysis
- ``data/``    synthetic dataset stand-ins and the preparation pipeline
- ``ops/``     SpMM (dense, plain, CUDA f32 and bf16 kernels) with autograd;
               the students' latent-neighbour search
- ``nn/``      GCN conv with Structural Embeddings, residual tricks, backbone,
               the MLP stacks
- ``models/``  TeacherGNN, the SEMLP parts, StudentBaseMLP, GraphMLP
- ``train/``   the teacher and student loops, Adam, head/tail/isolation eval
- ``utils/``   flax -> torch parameter conversion
"""

__version__ = "0.1.0"
