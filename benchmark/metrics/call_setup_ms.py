"""call_setup_ms.*: host ms a step of the trainers' set-up spans
(``gnn.<trainer>.setup``: the model built and moved, the inputs copied to
the card), which every call pays before its first epoch."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: spans.phase(n, "setup"), "host_ms")
