"""engine.start_ms: the whole-recursion engine's set-up, milliseconds a
traced call (the program's span "engine.start": the four copies to the
card and the table's first state), summed inside the trace's window over
the traced calls.  None without a trace of the card, or where the
program records no such span."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or not t.samples:
        return None
    w0, w1 = t.window
    us = [max(0.0, min(e, w1) - max(s, w0)) for n, s, e in t.host
          if n == "engine.start"]
    return sum(us) / len(t.samples) / 1e3 if us else None
