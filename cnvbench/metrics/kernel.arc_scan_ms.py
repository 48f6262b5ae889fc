"""kernel.arc_scan_ms: device time of kernel B4 (arc_scan_blocks and
arc_scan_replay, the arc scan) a traced call."""

from cnvbench import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not t.samples:
        return None
    us = tr.kernel_us(t, {"arc_scan_blocks", "arc_scan_replay"})
    return us / len(t.samples) / 1e3 if us else None
