"""setup_s: process start to the first timed call (host clock): imports,
the CUDA context, the pool, the kernels' build or load, the stopping
boundary, the CUDA graph's capture and the warm calls."""


def read(ctx):
    return ctx.setup_s
