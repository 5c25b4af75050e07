"""Device kernels and copies launched a pair in the profiled stretch (the
dispatch of the model and the step)."""


def read(t):
    return t.launches / t.pairs if t.pairs else None
