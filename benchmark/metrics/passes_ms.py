"""passes_ms.*: device ms a step of the elementwise, cast/copy, reduction and
index classes (the passes around the dense layers). One reader for every
suffix, which names the step metric it moves."""
from harness import readers


def read(r):
    return readers.class_ms(r, readers.PASSES)
