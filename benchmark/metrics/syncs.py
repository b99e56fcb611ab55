"""syncs.*: the program's blocking reads from the card a step (its
``host_syncs`` counter). One reader for every suffix."""
from harness import spans


def read(r):
    return spans.counter(r, "host_syncs")
