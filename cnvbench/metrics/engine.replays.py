"""engine.replays: replays of the captured CUDA graph level a call (the
change of cbs_mega.GRAPHS["replays"]), the mean over the window's calls;
a replay batch past the recursion's end replays dead levels."""


def read(ctx):
    rp = [r["replays"] for r in ctx.samples if r["ok"]]
    return sum(rp) / len(rp) if rp else None
