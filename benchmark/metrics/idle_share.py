"""idle_share.*: the device's idle share of the traced window from its first
kernel, in %. One reader for every suffix, which names the step metric it
moves."""
from harness import readers


def read(r):
    return readers.idle_share(r)
