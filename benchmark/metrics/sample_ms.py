"""sample_ms.*: device ms a step of the link epoch's draws
(``gnn.link.sample``: the permutation and the negatives)."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: n == "gnn.link.sample")
