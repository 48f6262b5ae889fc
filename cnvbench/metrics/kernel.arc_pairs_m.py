"""kernel.arc_pairs_m: the recursion's arc pairs a call, in millions:
n (n + 1) / 2 over every level's pending analysable rows, the (i, j)
pairs an unpruned arc scan evaluates, as kernel K16 tallies them on the
card (canvas_tpu_torch.ops.cbs_mega.WORK).  The counter holds every
engine run of the process, the two warm calls too (about 0.06 % of a
run's calls, from the same pool).  Read in a traced run on the card;
None without one, or where the program keeps no such counter."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    from canvas_tpu_torch.ops import cbs_mega

    w = getattr(cbs_mega, "WORK", None)
    return w["arc_pairs"] / w["calls"] / 1e6 if w and w["calls"] else None
