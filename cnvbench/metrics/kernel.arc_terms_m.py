"""kernel.arc_terms_m: the (i, L) pair terms kernel B4 computed a call,
in millions: the live terms of every (lag block, row, position tile) its
first phase scanned, as B4 tallies them on the card
(canvas_tpu_torch.ops.cbs_mega.WORK).  Beside kernel.arc_pairs_m, the
unpruned count, it says how much of the arc scan B4's pruning leaves.
It depends on the order in which the pruning floors rise, so it may
differ a little from run to run.  The counter holds every engine run of
the process, the two warm calls too.  Read in a traced run on the card;
None without one, or where the program keeps no such counter."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    from canvas_tpu_torch.ops import cbs_mega

    w = getattr(cbs_mega, "WORK", None)
    if not w or not w.get("calls") or "arc_terms" not in w:
        return None
    return w["arc_terms"] / w["calls"] / 1e6
