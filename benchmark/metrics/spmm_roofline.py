"""spmm_roofline.*: the SpMM work's least time over the SpMM kernels' device
time, in %. One reader for every suffix, which names the step metric it
moves."""
from harness import readers


def read(r):
    return readers.spmm_roofline(r)
