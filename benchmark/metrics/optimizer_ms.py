"""optimizer_ms.*: device ms a step of the ``*.optimizer`` spans (the Adam
update, and the link step's gradient clip before it). One reader for every
suffix."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: n.endswith(".optimizer"))
