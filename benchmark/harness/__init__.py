"""The benchmark's own code: the yardstick that the port is measured by.

Nothing here imports JAX or the JAX package. The port
(``gnn_tail_generalization_tpu_torch``) is imported only by the cell
entries under ``benchmark/entries/``; the references under
``benchmark/reference/`` import nothing of it.
"""
