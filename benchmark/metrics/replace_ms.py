"""replace_ms.*: device ms a step of the latent-neighbour replacement
(``gnn.replace``), in the train step and the eval forwards together."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: n == "gnn.replace")
