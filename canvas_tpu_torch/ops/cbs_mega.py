"""The whole-recursion CBS engine: the full DNAcopy segmentation (arc scan,
OU tail probability, sequential-stopping permutation walks and
split-location edge tests) with the recursion's state in device tensors,
the final leaf segment table read back once.

Reference semantics: ``CanvasPartition/{ChangePoint,CBSTStatistic,
GetBoundary,TailProbability}.cs``, the same algorithm as the host parity
oracle (``ops/cbs.py``) and the frontier engine (``ops/cbs_device.py``).
It is the counterpart of the JAX package's default CBS engine on an
accelerator and draws the same permutations: on the same input it returns
the same segments.

Design:
  * A fixed-capacity segment table ``[S]`` of (contig, lo, hi, pending)
    slots carries the recursion frontier from level to level.  A split
    turns the parent slot into its first piece and appends the others at a
    cursor; an append beyond the table goes to a slot that is thrown away
    and sets the overflow flag, and the caller then runs the frontier
    engine.
  * Each level analyses the first W pending slots (a stable compaction):
    window gather and centring, the arc scan through kernel B4 at the
    smallest power-of-two tier width (1,024 to Tmax) that holds each
    segment, rows outside a tier zeroed, and the OU tail probability.
  * The sequential-stopping boundary walk (ChangePoint.cs:206-246) runs
    vectorised over a permutation chunk: with ``csum`` the running count of
    permuted statistics at or above the observed one, the first index where
    ``nrej > nrejc`` (reject) or ``np_i >= sbdry[k-1]`` (accept) decides;
    reject wins an exact tie because the reference checks it first.  Each
    row draws its chunks at its own tier width.
  * Split-location edge tests (ChangePoint.cs:359-398, TPermP) draw their
    m1-subsets as the m1 smallest of iid 32-bit keys (the m1-th order
    statistic, ties by index), and stop as soon as the rejection count
    cannot come back under alpha * n_perm.
  * Keys are threefry ``fold_in`` chains on (contig, lo, n), then the
    chunk counter (walks) or 7777 / 7778 and the chunk counter (edges), as
    in the JAX package (ops/threefry.py, equal bit for bit).  Kernels K7
    and K8 derive them on the card from the level key and the rows'
    (contig, lo, n); on CPU tensors their plain versions run the chains
    (cbs_mega_cuda.seg_keys, edge_keys).
  * The walks and the edge tests of a level are one launch each, kernels
    K7 and K8 (ops/cbs_mega_cuda.py), which loop over every row's chunks
    on the card until the row is decided; on CPU tensors their plain
    versions loop over the rows one at a time.  A row's chunk c draws
    from its own key and counter, so the results do not depend on which
    rows share an iteration.
  * One read from the device a level: at its start, one small integer
    tensor with the control values (any pending slot, overflow, any row
    in each tier) and the segment table with the run's counters, so the
    read that ends the loop carries the final table.  Each read is
    counted in SYNCS; nothing else in the engine reads from the device,
    and nothing copies to it after the set-up.
  * Sums and cumulative sums accumulate in float64 and round once to f32,
    and the tail probability runs in float64, so a CUDA run and a CPU run
    see the same statistics.

Documented deviations from the host path, as for the frontier engine
(Monte-Carlo-level): threefry permutations instead of the numpy stream,
f32 statistics with the reference's 1e-5 slack factor, exact arc-scan
ties resolved at block granularity.

Deviation from the JAX package's engine (C5, settled: float64 kept): the
tail probability p1 is float64 here, rounded to f32 before tail_ok = p1
<= alpha and the walk's limit nrejc = int((alpha - p1) n_perm); the JAX
package takes it in float32, off from its own float64 tail by up to
1.6e-4 relative on tests/test_torch_cbs_stats.py's level batch.  tail_ok
agrees, but a limit differs on the rare rows whose (alpha - p1) n_perm
lies that close to an integer, a limit one apart, which can decide a walk
the other way.  The float64 limit is the one the host
engine's float64 tail and Canvas's C# double give, and it keeps a CUDA
run equal to a CPU run (no float32 kernel could match XLA's float32 erfc
and exp bit for bit).  tests/test_torch_cbs_mega.py::
test_tail_precision_changes_walk_limits_c5 shows it.
"""

from __future__ import annotations

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.ops import cbs as _cbs
from canvas_tpu_torch.ops import cbs_mega_cuda
from canvas_tpu_torch.ops.cbs_device import (
    _cumsum, _gather_center, _tail_p_batch_dev, tmax_batch)
from canvas_tpu_torch.ops.cbs_mega_cuda import _fsum

_MAX_LEVELS = 128      # iteration bound (depth x frontier/W chunks)
_MAX_BINS = 65536      # the longest contig the table's tiers hold
_MAX_CONTIGS = 192
_MIN_SLOTS = 64        # the table holds max(64, 4 x contigs) slots

# reads of control values and results from the device, one per copy
SYNCS = {"cbs_mega": 0}


def _read(*parts: torch.Tensor) -> list[int]:
    """The parts (scalars or vectors) as one int64 tensor, copied to the
    host in one read."""
    SYNCS["cbs_mega"] += 1
    return torch.cat([p.reshape(-1).to(torch.int64) for p in parts]).tolist()


def _stable_order(flags: torch.Tensor) -> torch.Tensor:
    """Indices with the True entries first, each part in index order."""
    return torch.argsort((~flags).to(torch.int32), stable=True)


def _tiers(Tmax: int) -> list[int]:
    """Ascending width ladder (powers of two down to 1024): the [P, w]
    permutation sort and the arc scan both scale with the width, so every
    segment runs at the smallest tier that holds it."""
    out = {Tmax}
    w = Tmax // 2
    while w >= 1024:
        out.add(w)
        w //= 2
    return sorted(out)


# ---------------------------------------------------------------------------
# Split-location edge tests (ChangePoint.cs:359-398 / CBSTStatistic.TPermP)
# ---------------------------------------------------------------------------

def _edge_tests(x, n, i1, i2, test_both, key0, seg_c, seg_lo, alpha,
                n_perm, Tmax):
    """(keep1, keep2, edge chunks) for rows whose split needs its edges
    validated; the chunks as a device scalar.  Row r's key is
    fold_in(fold_in(fold_in(key0, seg_c[r]), seg_lo[r]), n[r]).

    Lane layout [2W]: edge 1 of rows 0..W-1, then edge 2.  Edge 1 tests
    the split at i1 inside x[0:i2] (n1 = i1); edge 2 tests the split at
    i2 inside x[i1:n] (n1 = i2 - i1).  TPermP statistics are
    shift-invariant, so the parent's centred windows serve: edge 1 is x
    masked to i2, edge 2 is x shifted left by i1.  The lanes' chunk loops
    are kernel K8 (cbs_mega_cuda.edge_counts)."""
    W = x.shape[0]
    dev = x.device
    wn = torch.cat([i2, n - i1])
    n1 = torch.cat([i1, i2 - i1])
    mask = torch.cat([test_both, test_both])

    pos = torch.arange(Tmax, device=dev)[None, :]
    x2 = torch.nn.functional.pad(x, (0, Tmax))
    xe2 = x2.gather(1, torch.clamp(i1, 0, Tmax)[:, None] + pos)
    xw = torch.where(pos < wn[:, None], torch.cat([x, xe2]), 0.0)

    n2 = wn - n1
    wnf = wn.to(torch.float32)
    xsum1 = _fsum(torch.where(pos < n1[:, None], xw, 0.0))
    xsum = _fsum(xw)
    xbar = xsum / torch.clamp(wnf, min=1.0)
    tss = _fsum(xw * xw) - wnf * xbar * xbar
    m1 = torch.minimum(n1, n2)
    m1f = torch.clamp(m1, min=1).to(torch.float32)
    mean_small = torch.where(n1 <= n2, xsum1 / torch.clamp(n1, min=1),
                             (xsum - xsum1) / torch.clamp(n2, min=1))
    ostat = 0.99999 * (mean_small - xbar).abs()
    tstat = ostat * ostat * m1f * wnf / torch.clamp(wnf - m1f, min=1.0)
    tstat = tstat / (torch.clamp(tss - tstat, min=1e-30)
                     / torch.clamp(wnf - 2.0, min=1.0))
    degen = (n1 <= 1) | (n2 <= 1)
    quick0 = (tstat > 25.0) & (m1 >= 10)
    limit = alpha * n_perm

    active = mask & ~degen & ~quick0
    count, cnt = cbs_mega_cuda.edge_counts(xw, wn, m1, xbar, ostat, active,
                                           key0, seg_c, seg_lo, n, limit,
                                           n_perm)
    p = count.to(torch.float32) / n_perm
    keep = torch.where(degen, False, torch.where(quick0, True, p <= alpha))
    return keep[:W], keep[W:], cnt.sum()


# ---------------------------------------------------------------------------
# The recursion
# ---------------------------------------------------------------------------

def _exclusive_cumsum(v):
    return torch.cumsum(v, dim=0) - v


def _drop_set(table, idx, val):
    """table with table[idx] = val where idx < len(table); writes at
    idx >= len(table) are dropped (they go to an extra slot cut off)."""
    S = table.shape[0]
    ext = torch.cat([table, table[:1]])
    ext[torch.where(idx < S, idx, S)] = val
    return ext[:S]


def _mega_recurse(contigs, n_c, sbdry, key0, alpha, *, S, Tmax, al0, kmax,
                  n_min, n_grid, n_perm, counts):
    """The full CBS recursion on contigs' device.  Returns (seg_c, seg_lo,
    seg_hi, nseg, overflow) on the host; `counts` gains the levels, walk
    and edge chunks, walks accepted and rejected.  One read a level, at
    its start: the control values and the table with its counters."""
    dev = contigs.device
    C = contigs.shape[0]
    tiers = _tiers(Tmax)
    slot = torch.arange(S, device=dev)
    seg_c0 = torch.where(slot < C, slot, -1)
    seg_lo0 = torch.zeros(S, dtype=torch.int64, device=dev)
    seg_hi0 = torch.nn.functional.pad(n_c, (0, S - C))
    pending0 = (slot < C) & (seg_hi0 > 0)
    nseg = torch.full((), C, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    # walks accepted and rejected, walk and edge chunks
    tally = torch.zeros(4, dtype=torch.int64, device=dev)
    big = torch.finfo(torch.float32).max
    pos = torch.arange(Tmax, device=dev)[None, :]

    def table(ctrl):
        """(seg_c, seg_lo, seg_hi, nseg, overflow, tally) of a read."""
        t = ctrl[-(3 * S + 6):]
        return (t[:S], t[S:2 * S], t[2 * S:3 * S], t[3 * S],
                bool(t[3 * S + 1]), t[3 * S + 2:])

    W = min(S, max(32, S // 2))   # frontier rows analysed an iteration
    level = 0
    while level < _MAX_LEVELS:
        # compact: only the first W pending rows analyse this iteration;
        # pending rows beyond W stay pending for the next one
        fsel = _stable_order(pending0)[:W]
        seg_c, seg_lo, seg_hi = seg_c0[fsel], seg_lo0[fsel], seg_hi0[fsel]
        pending = pending0[fsel]
        n = seg_hi - seg_lo
        contig = torch.clamp(seg_c, min=0)
        x, tss = _gather_center(contigs, contig, seg_lo, n, Tmax)
        # constant-window check (host: cur.max() != cur.min())
        valid = pos < n[:, None]
        wmax = torch.where(valid, x, -big).amax(dim=1)
        wmin = torch.where(valid, x, big).amin(dim=1)
        analyzable = pending & (n >= 2 * al0) & (wmax > wmin)
        n_eff = torch.where(analyzable, n, 2)
        in_tiers = [analyzable & (n_eff <= w) & (n_eff > (tiers[t - 1]
                                                         if t else 0))
                    for t, w in enumerate(tiers)]
        ctrl = _read(pending0.any(),
                     torch.stack([it.any() for it in in_tiers]),
                     seg_c0, seg_lo0, seg_hi0, nseg, overflow, tally)
        out = table(ctrl)
        if not ctrl[0] or out[4]:
            break
        x = torch.where(analyzable[:, None], x, 0.0)
        tss = torch.where(analyzable, tss, 0.0)
        cs = _cumsum(x)

        # tiered arc scan: each segment at the smallest width that holds
        # it; rows outside a tier are zeroed, so B4 skips all their blocks
        t2 = torch.zeros(W, dtype=torch.float32, device=dev)
        ti = torch.ones(W, dtype=torch.int64, device=dev)
        tj = torch.full((W,), 2, dtype=torch.int64, device=dev)
        for t, w in enumerate(tiers):
            if not ctrl[1 + t]:
                continue
            in_tier = in_tiers[t]
            r0, r1, r2 = tmax_batch(
                torch.where(in_tier[:, None], cs[:, :w], 0.0),
                torch.where(in_tier, n_eff, 2),
                torch.where(in_tier, tss, 0.0), w, al0)
            t2 = torch.where(in_tier, r0, t2)
            ti = torch.where(in_tier, r1.to(torch.int64), ti)
            tj = torch.where(in_tier, r2.to(torch.int64), tj)
        ostat1 = torch.sqrt(torch.clamp(t2, min=0.0))
        ostat = 0.99999 * t2
        p1 = _tail_p_batch_dev(ostat1.double(), n_eff, kmax,
                               n_grid).float()

        larc = torch.minimum(tj - ti, n - tj + ti)
        considered = analyzable & (ostat1 > 0.1)
        trivial = considered & (ostat1 >= 7.0) & (larc >= 10)
        hybrid = n > n_min
        tail_ok = torch.where(hybrid, p1 <= alpha, True)
        needs = considered & ~trivial & tail_ok
        # host: int((alpha - p1) * n_perm) for hybrid, int(alpha * n_perm)
        # otherwise (f32, truncated toward zero; only walking rows use it)
        nrejc = torch.where(
            hybrid, ((alpha - p1) * n_perm).to(torch.int32),
            (alpha * float(n_perm)).to(torch.int32)).to(torch.int64)

        # --- sequential-stopping permutation walks (kernel K7); a walking
        # row is analysable, so its n_eff is its n and its key the chain
        # of (contig, lo, n) ---
        walked, wchunks = cbs_mega_cuda.walk(
            x, n_eff, tss, key0, contig, seg_lo, needs, hybrid, ostat,
            nrejc, sbdry, n_perm, al0, kmax, n_min)
        accepted = trivial | walked

        # --- split-location edge tests (kernel K8) ---
        at_end = tj >= n          # i2 == n: keep split 1 untested
        at_start = ti <= 0        # i1 == 0: keep split 2 untested
        test_both = accepted & ~at_end & ~at_start
        keep1t, keep2t, echunks = _edge_tests(
            x, n, ti, tj, test_both, key0, contig, seg_lo, alpha, n_perm,
            Tmax)
        keep1 = torch.where(test_both, keep1t, at_end & ~at_start)
        keep2 = torch.where(test_both, keep2t, at_start & ~at_end)
        split1 = accepted & keep1
        split2 = accepted & keep2 & (tj < n)
        tally = tally + torch.stack([(walked & needs).sum(),
                                     (needs & ~walked).sum(),
                                     wchunks.sum(), echunks])

        # --- segment-table update ---
        nsplits = split1.to(torch.int64) + split2.to(torch.int64)
        has_child = nsplits > 0
        first_cut = torch.where(split1, ti, tj)
        second_cut = torch.where(split1 & split2, tj, n)
        extra = torch.where(has_child, 1 + (nsplits == 2).to(torch.int64), 0)
        base = nseg + _exclusive_cumsum(extra)
        idx_a = torch.where(extra >= 1, base, S)
        idx_b = torch.where(extra == 2, base + 1, S)
        # parents first, then the appended children (slots >= nseg)
        seg_hi0 = seg_hi0.clone()
        seg_hi0[fsel] = torch.where(has_child, seg_lo + first_cut, seg_hi)
        pending0 = pending0.clone()
        pending0[fsel] = pending & analyzable & has_child
        for idx, lo_cut, hi_cut in ((idx_a, first_cut, second_cut),
                                    (idx_b, second_cut, n)):
            seg_c0 = _drop_set(seg_c0, idx, seg_c)
            seg_lo0 = _drop_set(seg_lo0, idx, seg_lo + lo_cut)
            seg_hi0 = _drop_set(seg_hi0, idx, seg_lo + hi_cut)
            pending0 = _drop_set(pending0, idx, torch.ones_like(pending))
        nseg = nseg + extra.sum()
        overflow = overflow | (nseg > S)
        level += 1
    else:                     # the level bound ended the loop
        out = table(_read(seg_c0, seg_lo0, seg_hi0, nseg, overflow, tally))
    seg_c, seg_lo, seg_hi, nseg, over, tally = out
    counts["levels"] += level
    for k, v in zip(("walks_accepted", "walks_rejected", "walk_chunks",
                     "edge_chunks"), tally):
        counts[k] += v
    return (np.asarray(seg_c), np.asarray(seg_lo), np.asarray(seg_hi), nseg,
            over or level >= _MAX_LEVELS)


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def _pow2(v: int, floor: int = 8) -> int:
    return max(floor, 1 << (int(v) - 1).bit_length())


def run_cbs_mega(
    coverage_by_contig: dict[str, np.ndarray],
    alpha: float = _cbs.DEFAULT_ALPHA,
    n_perm: int = _cbs.DEFAULT_NPERM,
    undo_method: str = "none",
    seed: int = 0,
    p_method: str = "hybrid",
    min_width: int = _cbs.DEFAULT_MIN_WIDTH,
    kmax: int = _cbs.DEFAULT_KMAX,
    n_min: int = _cbs.DEFAULT_NMIN,
    undo_prune: float = 0.05,
    undo_sd: float = 3.0,
    device: str | torch.device = "cuda",
    counts: dict | None = None,
) -> dict[str, np.ndarray] | None:
    """CBSRunner.Run with the whole recursion on `device` (module
    docstring).  Same contract as ops.cbs.run_cbs: contig -> segment
    lengths.  Returns None when the input does not fit the table (more
    than 65,536 bins in a contig, more than 192 contigs, more segments
    than the table holds, or the level bound reached); the caller then
    runs the frontier engine.  With `counts` given, it gains the run's
    levels, walk chunks, edge-test chunks and walks accepted and rejected.
    Asking for a missing card raises."""
    device = resolve_device(device)
    names = list(coverage_by_contig)
    rows = [np.asarray(coverage_by_contig[k], np.float64) for k in names]
    if sum(len(r) for r in rows) == 0:
        return {}
    nonempty = [c for c, r in enumerate(rows) if len(r)]
    max_len = max(len(rows[c]) for c in nonempty)
    C = len(nonempty)
    if max_len > _MAX_BINS or C > _MAX_CONTIGS:
        return None

    Tmax = _pow2(max_len, floor=1024)
    S = _pow2(max(_MIN_SLOTS, 4 * C))
    sbdry = _cbs.compute_boundary(n_perm, alpha, _cbs.DEFAULT_ETA)
    if undo_method == "sdundo":
        finite = {k: np.asarray(v, np.float64)[np.isfinite(v)]
                  for k, v in coverage_by_contig.items()}
        tsd = float(np.sqrt(_cbs.trimmed_variance(finite))) \
            if any(len(v) for v in finite.values()) else 0.0
    else:
        tsd = 0.0

    mat = np.zeros((C, Tmax), np.float32)
    n_c = np.zeros(C, np.int64)
    for i, c in enumerate(nonempty):
        mat[i, : len(rows[c])] = rows[c]
        n_c[i] = len(rows[c])
    key0 = np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      np.int64)     # jax.random.PRNGKey(seed)
    run_counts = {"levels": 0, "walk_chunks": 0, "edge_chunks": 0,
                  "walks_accepted": 0, "walks_rejected": 0}
    seg_c, seg_lo, seg_hi, nseg, overflow = _mega_recurse(
        torch.as_tensor(mat, device=device),
        torch.as_tensor(n_c, device=device),
        torch.as_tensor(np.asarray(sbdry, np.int64), device=device),
        torch.as_tensor(key0, device=device),
        torch.full((), alpha, dtype=torch.float32, device=device),
        S=S, Tmax=Tmax, al0=min_width, kmax=kmax,
        n_min=n_min if p_method == "hybrid" else (1 << 30),
        n_grid=100, n_perm=n_perm, counts=run_counts)
    if counts is not None:
        for k, v in run_counts.items():
            counts[k] = counts.get(k, 0) + v
    if overflow:
        return None

    # assemble leaves -> per-contig lengths; validate the partition
    result: dict[str, np.ndarray] = {}
    for i, c in enumerate(nonempty):
        sel = seg_c[:nseg] == i
        los = np.sort(seg_lo[:nseg][sel])
        his = np.sort(seg_hi[:nseg][sel])
        n = len(rows[c])
        if (len(los) == 0 or los[0] != 0 or his[-1] != n
                or np.any(los[1:] != his[:-1])):
            raise RuntimeError(f"cbs_mega: the segment table of contig "
                               f"{names[c]} does not tile [0, {n})")
        lengths = (his - los).astype(np.int64)
        if len(lengths) > 1 and undo_method == "prune":
            lengths = _cbs._prune(rows[c], lengths, undo_prune)
        elif len(lengths) > 1 and undo_method == "sdundo":
            lengths = _cbs._sd_undo(rows[c], lengths, tsd, undo_sd)
        result[names[c]] = np.asarray(lengths, np.int64)
    # the frontier engine's empty-contig convention: lengths [0] for n == 0
    for name in names:
        if name not in result:
            result[name] = np.asarray([0], np.int64)
    return result
