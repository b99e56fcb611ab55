"""attn_calls.*: forward calls of the graph attention op a step (the
port's ``attn.calls`` counter): one a Transformer layer."""
from harness import spans


def read(r):
    return spans.counter(r, "attn.calls")
