"""attn_ms.*: device ms a step of the graph attention op (``gnn.attn``, each
forward call, and ``gnn.attn.backward``, each backward): the edge-softmax
kernels and the attention's B1 aggregations."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: n in ("gnn.attn", "gnn.attn.backward"))
