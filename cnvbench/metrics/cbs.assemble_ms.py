"""cbs.assemble_ms: the CBS entry's assembly, milliseconds a traced call
(the program's span "cbs.assemble": the leaves turned into segment
lengths, the partition checked, the undo pass), summed inside the trace's
window over the traced calls.  None without a trace of the card, or where
the program records no such span."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or not t.samples:
        return None
    w0, w1 = t.window
    us = [max(0.0, min(e, w1) - max(s, w0)) for n, s, e in t.host
          if n == "cbs.assemble"]
    return sum(us) / len(t.samples) / 1e3 if us else None
