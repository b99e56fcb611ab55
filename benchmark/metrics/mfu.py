"""mfu.*: the step's model FLOPs over its time times the f32 peak, in %. One
reader for every suffix, which names the step metric it moves."""
from harness import readers


def read(r):
    return readers.mfu(r)
