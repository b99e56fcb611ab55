"""PyTorch + CUDA port of gnn_tail_generalization_tpu (Cold Brew, ICLR 2022).

The JAX package ``gnn_tail_generalization_tpu`` stays the reference; this
package mirrors its layout, imports ``torch`` and ``numpy`` only, and carries
its own copies of the host-side code it needs. Ported so far: the TeacherGNN
full-graph training path, whose SpMM runs on hand-written CUDA kernels
(``csrc/spmm_csr.cu``, bound in ``ops/spmm_kernels.py``).

- ``graph/``   CSR graph container, host-side construction, degree analysis
- ``data/``    synthetic dataset stand-ins and the preparation pipeline
- ``ops/``     SpMM (dense, plain, CUDA f32 and bf16 kernels) with autograd
- ``nn/``      GCN conv with Structural Embeddings, residual tricks, backbone
- ``models/``  TeacherGNN
- ``train/``   the teacher training loop, Adam, head/tail/isolation eval
- ``utils/``   flax -> torch parameter conversion
"""

__version__ = "0.1.0"
