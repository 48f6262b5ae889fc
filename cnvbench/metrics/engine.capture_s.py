"""engine.capture_s: seconds the live whole-recursion engine took to
capture its level in a CUDA graph (canvas_tpu_torch.ops.cbs_mega's
engines, capture_s; in the first warm call, so part of setup_s).  Read in
a traced run on the card; None without one, or where no engine
captured."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    from canvas_tpu_torch.ops import cbs_mega

    s = [e.capture_s for e in list(cbs_mega._ENGINES.values())
         if getattr(e, "capture_s", None) is not None]
    return float(sum(s)) if s else None
