"""cbs.levels: the recursion's levels a call, as the engine counts them
(cbs._LAST_ENGINE["levels"]), the mean over the window's calls."""


def read(ctx):
    lv = [r["levels"] for r in ctx.samples
          if r["ok"] and r.get("levels") is not None]
    return sum(lv) / len(lv) if lv else None
