"""cbs.boundary_s: seconds the process spent computing the CBS stopping
boundary (canvas_tpu_torch.ops.cbs.BOUNDARY: compute_boundary's cache
misses, in the warm calls, so part of setup_s).  Read in a traced run on
the card; None without one, or where the program keeps no such
counter."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    from canvas_tpu_torch.ops import cbs

    b = getattr(cbs, "BOUNDARY", None)
    return float(b["seconds"]) if b and b["computed"] else None
