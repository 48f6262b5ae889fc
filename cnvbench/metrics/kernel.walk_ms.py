"""kernel.walk_ms: device time of kernel K7 (walk_kernel, the
permutation walks) a traced call."""

from cnvbench import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not t.samples:
        return None
    us = tr.kernel_us(t, {"walk_kernel"})
    return us / len(t.samples) / 1e3 if us else None
