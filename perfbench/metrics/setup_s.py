"""Seconds from the process's start to the window's first call: imports,
CUDA's start, the kernels' build or cache lookup, weights and draws from
the seed, the warm-up calls and the graphs' captures."""


def read(ctx):
    return ctx.setup_s
