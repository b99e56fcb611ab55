"""launches.*: device kernels a step, from the traced window. One reader for
every suffix, which names the step metric it moves."""
from harness import readers


def read(r):
    return readers.launches(r)
