"""sample_p95_ms: the 95th percentile of every call's latency in the
window (host clock around the call, which returns after the card's
read), in milliseconds, over all calls."""

import numpy as np


def read(ctx):
    lat = [r["t1"] - r["t0"] for r in ctx.samples]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
