"""spmm_calls.*: one-device SpMM aggregations a step, forward and
transposed backward (the port's ``spmm.calls`` counter). One reader for
every suffix."""
from harness import spans


def read(r):
    return spans.counter(r, "spmm.calls")
