"""cbs.mega_share: the share of the window's calls that the
whole-recursion engine served (cbs.last_engine() == "mega"); the rest
overflowed its segment table and ran the host-driven frontier engine."""


def read(ctx):
    done = [r for r in ctx.samples if r["ok"]]
    if not done:
        return None
    return 100.0 * sum(r["engine"] == "mega" for r in done) / len(done)
