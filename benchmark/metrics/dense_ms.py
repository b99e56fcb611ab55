"""dense_ms.*: device ms a step of the GEMM class (the dense layers). One
reader for every suffix, which names the step metric it moves."""
from harness import readers


def read(r):
    return readers.class_ms(r, ("gemm",))
