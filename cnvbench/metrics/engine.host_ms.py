"""engine.host_ms: a call's wall less the card's busy time inside it, the
mean over the traced calls (the trace's call spans and device
intervals)."""

from cnvbench import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or not t.samples:
        return None
    merged = tr.union(t.device)
    host = [(e - s) - tr.covered(merged, s, e) for s, e in t.samples]
    return sum(host) / len(host) / 1e3
