"""prep_s: host seconds of set-up's calls into the port's preparation."""


def read(r):
    return r.stages.get("prep")
