"""score_ms.*: device ms a step of the link evaluation's chunked scorer
(``gnn.link.score``: every ``predict_chunked`` call)."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: n == "gnn.link.score")
