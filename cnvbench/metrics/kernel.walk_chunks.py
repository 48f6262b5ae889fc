"""kernel.walk_chunks: kernel K7's permutation chunks a call, as the
card tallies them (canvas_tpu_torch.ops.cbs_mega.WORK).  The counter
holds every engine run of the process, the two warm calls too (about
0.06 % of a run's calls, from the same pool).  Read in a traced run on
the card; None without one, or where the program keeps no such
counter."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    from canvas_tpu_torch.ops import cbs_mega

    w = getattr(cbs_mega, "WORK", None)
    return w["walk_chunks"] / w["calls"] if w and w["calls"] else None
