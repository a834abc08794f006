"""Seconds from the start of the process to the first timed step: imports,
the CUDA context, loading (or, on a checkout's first run, building) the
kernels, reading (or featurizing) the pool, padding and packing, building
the model, its first steps and the warm-up."""


def read(r):
    return r.setup_s
