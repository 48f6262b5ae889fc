"""bins_per_s: coverage bins of every sample completed in the window, over
the window's seconds (host clock): "coverage bins segmented/sec/chip"."""


def read(ctx):
    start, end = ctx.window
    done = sum(r["bins"] for r in ctx.samples if r["ok"])
    return done / (end - start) if end > start and done else None
