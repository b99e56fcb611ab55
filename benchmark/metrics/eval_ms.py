"""eval_ms.*: device ms a step of the trainers' eval spans
(``gnn.<trainer>.eval``: the eval forwards and their accuracies)."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: spans.phase(n, "eval"))
