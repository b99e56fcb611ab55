"""topk_ms.*: device ms a step of the sort/top-k class (the latent-neighbour
replacement's selection). One reader for every suffix, which names the step
metric it moves."""
from harness import readers


def read(r):
    return readers.class_ms(r, ("sort/top-k",))
