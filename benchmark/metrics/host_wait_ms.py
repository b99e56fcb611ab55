"""host_wait_ms.*: host ms a step spent in the program's blocking reads
from the card (the ``*.read`` spans; 0 where it made none). One reader for
every suffix."""
from harness import spans


def read(r):
    return spans.span_ms(r, lambda n: n.endswith(".read"), "host_ms", none=0.0)
