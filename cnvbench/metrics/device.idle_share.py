"""device.idle_share: the share of the traced window in which no operation
ran on the card (1 - the union of device intervals over the window)."""

from cnvbench import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.window is None:
        return None
    w0, w1 = t.window
    return 100.0 * (1.0 - tr.device_busy(t) / (w1 - w0))
