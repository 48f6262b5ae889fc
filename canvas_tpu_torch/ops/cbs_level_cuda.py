"""The whole-recursion CBS engine's level body (K13-K16), with its plain
torch versions.

  prologue     (K13): the first W pending slots of the segment table
               (a stable compaction), their windows gathered from the
               contig matrix and centred (float64 sums rounded once to
               f32), the constant-window test, analyzable and n_eff, each
               tier's row mask, the rows that cannot be analysed zeroed,
               the float64 cumsum rounded to f32, and the level's t2, ti,
               tj at a row-in-no-tier's (0, 1, 2).
  tail_decide  (K11 carrying K14): b = sqrt(max(t2, 0)) in float64, its
               tail probability p1 (K11, csrc/cbs_stats.cu), and from p1,
               rounded to f32 (C5), ostat, hybrid, trivial, needs and the
               walk limit nrejc, in one cooperative launch.
  edge_setup   (K15, before K8): accepted and test_both, and for the 2W
               lanes (edge 1 of every row, then edge 2) the windows xw,
               their float64 sums and the statistic's flags degen, quick0
               and active, the lanes' m1, xbar and ostat, and the limit.
  keep_table   (K15 after K8, and K16, one launch): each lane's keep flag
               from K8's count, the rows' keep1 and keep2, the level's edge
               chunks; then split1 and split2, the appended children
               (writes beyond S dropped), the parents' new ends and pending
               flags, nseg, overflow, the run's tally, the level count and
               live.

The segment table and its control words are one int64 buffer, `tab` [3 S
+ CTL]: seg_c, seg_lo, seg_hi [S] each, then nseg, overflow, live, the
level count and the run's tally (TALLY_WORDS: walks accepted and rejected,
walk chunks, edge chunks, and arc pairs, the sum over every level's
pending analysable rows of n (n + 1) / 2, the (i, j) pairs an unpruned arc
scan of the row evaluates: the recursion's work, which B4's pruning does
not change, each added by K16; then arc terms, the (i, L) pair terms that
B4's first phase computed, added by B4 on the card and by nothing on CPU
tensors, so that with the arc pairs it says how much B4's pruning
saves); the pending flags are bool [S].  Every kernel of a level returns
at once where live is 0, so a level after the run's end changes nothing.

On CUDA tensors the wrappers launch csrc/cbs_level.cu (K13 two launches
a call, its slot selection and its tiles; the others one) and, for
tail_decide, csrc/cbs_stats.cu's K11 variant, counted in LAUNCHES (and
cbs_stats_cuda.LAUNCHES["tail_decide"]), and write into the caller's
tensors; on CPU tensors they read live (a host read) and, where it is
set, run the plain versions (tail_decide_plain: decide_prep_plain,
tail_p_plain, decide_plain chained; keep_table_plain: edge_keep_plain,
table_update_plain) and copy their results into them.  K13 and K15
spread each row (lane) over tiles of tile_layout's width, a block a tile
(K13: a thread block cluster a row; K15: its tiles' sums in
level_buffers' k15_part, added by the lane's last tile, counted in
k15_count).  The plain versions are the torch code these kernels replace
in ops/cbs_mega.py, each a function of the level's inputs returning new
tensors; edge_keep divides by a 0-dim tensor, so its p is IEEE division
on every device (torch's CUDA division by a Python scalar multiplies by
the reciprocal).  The kernels repeat them operation for operation but for
the order of their float64 sums: a fixed order over the tiles
(csrc/cbs_level.cu's note on exactness), equal to torch's result where
the sums are exact.
"""

from __future__ import annotations

import ctypes

import torch

from canvas_tpu_torch.ops import cbs_stats_cuda, cuda_lib
from canvas_tpu_torch.ops.cbs_device import _cumsum, _gather_center
from canvas_tpu_torch.ops.cbs_mega_cuda import _check, _fsum

# the control words after the table: four, then the tally's
NSEG, OVERFLOW, LIVE, LEVEL, TALLY = 0, 1, 2, 3, 4
TALLY_WORDS = ("walks_accepted", "walks_rejected", "walk_chunks",
               "edge_chunks", "arc_pairs", "arc_terms")
ARC_TERMS = TALLY + TALLY_WORDS.index("arc_terms")     # B4's word
CTL = TALLY + len(TALLY_WORDS)
MAX_SLOTS = 1024       # K13's compaction and K16: the table in one block
MIN_TIER = 1024        # tier t is MIN_TIER << t wide

# K13's and K15's tiles (csrc/cbs_level.cu's tile_width): at most
# MAX_TILES a row (a thread block cluster), the widest power of two from
# MIN_TILE to min(MAX_TILE, Tmax) whose launch keeps at least
# TARGET_BLOCKS blocks (twice the H100's 132 SMs)
TILE_THREADS = 128
MIN_TILE, MAX_TILE, MAX_TILES = 128, 4096, 16
TARGET_BLOCKS = 264

# launches of the kernels, counted by the wrappers (K13: two a level, its
# slot selection and its tiles; K15's set-up and keep_table one each; K11
# carrying K14 is cbs_stats_cuda's "tail_decide")
LAUNCHES = {"prologue": 0, "edge_setup": 0, "keep_table": 0}
PROLOGUE_LAUNCHES = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cbs_prologue": [_P] * 17 + [_I] * 5 + [_P],
    "cbs_level_layout": [_I, _I, _P],
    "cbs_edge_setup": [_P] * 21 + [_I] * 3 + [_P],
    "cbs_keep_table": [_P] * 23 + [_I] * 4 + [_P],
    "cbs_graph_nodes": [_P, _P],
}

_B, _F, _D, _L, _N = (torch.bool, torch.float32, torch.float64, torch.int64,
                      torch.int32)


# the level's tensors that K13-K16 write: [W] rows, [2W] lanes, and the
# rest with their shapes
_ROWS = {"fsel": _L, "contig": _L, "seg_lo": _L, "n": _L, "pending": _B,
         "analyzable": _B, "n_eff": _L, "tss": _F, "t2": _F, "ti": _N,
         "tj": _N, "b": _D, "p1": _D, "ostat": _F, "hybrid": _B, "needs": _B,
         "trivial": _B, "nrejc": _L, "accepted": _B, "test_both": _B,
         "keep1": _B, "keep2": _B}
_LANES = {"wn": _L, "m1": _L, "xbar": _F, "ostat_e": _F, "degen": _B,
          "quick0": _B, "active": _B}
_OTHER = {"x": _F, "cs": _F, "xw": _F, "in_tier": _B, "limit": _F,
          "echunks": _L}
# K15's scratch: its tiles' sums and its lanes' arrival counters (zero,
# and left zero by every launch)
_SCRATCH = {"k15_part": _D, "k15_count": _N}
K15_PARTS = 3


def tile_layout(rows: int, Tmax: int) -> tuple[int, int]:
    """(tile width, tiles a row) of a K13 or K15 launch over `rows` rows
    of Tmax positions, csrc/cbs_level.cu's tile_width."""
    w = MIN_TILE
    while w < MAX_TILE and Tmax // w > MAX_TILES:
        w *= 2
    while (2 * w <= min(MAX_TILE, Tmax)
           and rows * (Tmax // (2 * w)) >= TARGET_BLOCKS):
        w *= 2
    return w, Tmax // w


def prologue_layout(W: int, Tmax: int) -> tuple[int, int]:
    """K13's tiles: (width, tiles a row) of its W rows."""
    return tile_layout(W, Tmax)


def edge_layout(W: int, Tmax: int) -> tuple[int, int]:
    """K15's tiles: (width, tiles a lane) of its 2 W lanes."""
    return tile_layout(2 * W, Tmax)


def _shape(name: str, W: int, Tmax: int, tiers: int) -> tuple:
    if name == "k15_part":
        return (2 * W * edge_layout(W, Tmax)[1] * K15_PARTS,)
    return {"x": (W, Tmax), "cs": (W, Tmax), "xw": (2 * W, Tmax),
            "in_tier": (tiers, W), "limit": (), "echunks": ()}.get(
        name, (2 * W,) if name in _LANES or name == "k15_count" else (W,))


def level_buffers(W: int, Tmax: int, tiers: int, dev) -> dict:
    """The level's tensors that K13-K16 write, and K15's scratch, by name,
    zeroed."""
    return {k: torch.zeros(_shape(k, W, Tmax, tiers), dtype=dt, device=dev)
            for k, dt in {**_ROWS, **_LANES, **_OTHER, **_SCRATCH}.items()}


def tier_widths(Tmax: int) -> list[int]:
    """The tier widths from MIN_TIER up to Tmax (a power of two >= 1,024),
    ascending: every segment runs at the smallest one that holds it."""
    return [MIN_TIER << t for t in range((Tmax // MIN_TIER).bit_length())]


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def _stable_order(flags: torch.Tensor) -> torch.Tensor:
    """Indices with the True entries first, each part in index order."""
    return torch.argsort((~flags).to(torch.int32), stable=True)


def prologue_plain(contigs, tab, pending0, W: int, al0: int) -> dict:
    """Plain version of K13 on the table tab and pending0 (S slots) and
    the contig matrix contigs f32 [C, Tmax].  Its float64 sums (the row
    sums, the sum of squares, the cumsum) are torch's reductions and scan;
    the kernel adds them in its tile order (prologue_layout's tiles, each
    tile's own order, the tiles in tile order, the cumsum carried from tile
    to tile), the same result wherever the sums are exact."""
    S = pending0.shape[0]
    Tmax = contigs.shape[1]
    dev = contigs.device
    seg_c0, seg_lo0, seg_hi0 = tab[:S], tab[S:2 * S], tab[2 * S:3 * S]
    fsel = _stable_order(pending0)[:W]
    seg_c, seg_lo, seg_hi = seg_c0[fsel], seg_lo0[fsel], seg_hi0[fsel]
    pending = pending0[fsel]
    n = seg_hi - seg_lo
    contig = torch.clamp(seg_c, min=0)
    x, tss = _gather_center(contigs, contig, seg_lo, n, Tmax)
    # constant-window check (host: cur.max() != cur.min())
    big = torch.finfo(torch.float32).max
    valid = torch.arange(Tmax, device=dev)[None, :] < n[:, None]
    wmax = torch.where(valid, x, -big).amax(dim=1)
    wmin = torch.where(valid, x, big).amin(dim=1)
    analyzable = pending & (n >= 2 * al0) & (wmax > wmin)
    n_eff = torch.where(analyzable, n, 2)
    tiers = tier_widths(Tmax)
    in_tier = torch.stack([analyzable & (n_eff <= w)
                           & (n_eff > (tiers[t - 1] if t else 0))
                           for t, w in enumerate(tiers)])
    x = torch.where(analyzable[:, None], x, 0.0)
    tss = torch.where(analyzable, tss, 0.0)
    return {"fsel": fsel, "contig": contig, "seg_lo": seg_lo, "n": n,
            "pending": pending, "analyzable": analyzable, "n_eff": n_eff,
            "x": x, "tss": tss, "cs": _cumsum(x), "in_tier": in_tier,
            "t2": torch.zeros(W, dtype=_F, device=dev),
            "ti": torch.ones(W, dtype=_N, device=dev),
            "tj": torch.full((W,), 2, dtype=_N, device=dev)}


def decide_prep_plain(t2) -> torch.Tensor:
    """Plain version of K14's first step: K11's input b float64."""
    return torch.sqrt(torch.clamp(t2, min=0.0)).double()


def decide_plain(t2, ti, tj, n, analyzable, p1, alpha, n_perm: int,
                 n_min: int) -> dict:
    """Plain version of K14's rules after K11: the level's decision rules
    from the statistic t2 at the split (ti, tj) and K11's p1 float64."""
    ostat1 = torch.sqrt(torch.clamp(t2, min=0.0))
    ostat = 0.99999 * t2
    p1 = p1.float()
    ti, tj = ti.long(), tj.long()
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
    return {"ostat": ostat, "hybrid": hybrid, "needs": needs,
            "trivial": trivial, "nrejc": nrejc}


def tail_decide_plain(lv: dict, alpha, kmax: int, n_grid: int, n_perm: int,
                      n_min: int) -> dict:
    """Plain version of K11 carrying K14, on the level's tensors lv:
    decide_prep_plain, K11's plain version (cbs_stats_cuda.tail_p_plain at
    n_eff) and decide_plain chained; b, p1 and the rules' outputs."""
    b = decide_prep_plain(lv["t2"])
    p1 = cbs_stats_cuda.tail_p_plain(b, lv["n_eff"], kmax, n_grid)
    return {"b": b, "p1": p1, **decide_plain(
        lv["t2"], lv["ti"], lv["tj"], lv["n"], lv["analyzable"], p1, alpha,
        n_perm, n_min)}


def edge_lanes_plain(x, n, i1, i2, test_both, alpha, n_perm: int,
                     Tmax: int) -> dict:
    """The edge tests' lanes before K8, ops/cbs_mega.py's _edge_tests
    before its K8 call.  Lane layout [2W]: edge 1 of rows 0..W-1, then
    edge 2.  Edge 1 tests the split at i1 inside x[0:i2] (n1 = i1); edge 2
    tests the split at i2 inside x[i1:n] (n1 = i2 - i1).  TPermP
    statistics are shift-invariant, so the parent's centred windows serve:
    edge 1 is x masked to i2, edge 2 is x shifted left by i1.  Its float64
    sums are torch's reductions; K15 adds each lane's in its tile order
    (edge_layout's tiles, summed by the lane's last tile in tile order),
    the same result wherever the sums are exact."""
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
    return {"xw": xw, "wn": wn, "m1": m1, "xbar": xbar, "ostat_e": ostat,
            "degen": degen, "quick0": quick0,
            "active": mask & ~degen & ~quick0, "limit": alpha * n_perm}


def edge_setup_plain(x, n, ti, tj, trivial, walked, alpha, n_perm: int,
                     Tmax: int) -> dict:
    """Plain version of K15's first launch: the rows accepted (trivially
    or by their walk, K7's walked), those whose split needs both edges
    tested, and the lanes (edge_lanes_plain)."""
    accepted = trivial | walked
    ti, tj = ti.long(), tj.long()
    at_end = tj >= n          # i2 == n: keep split 1 untested
    at_start = ti <= 0        # i1 == 0: keep split 2 untested
    test_both = accepted & ~at_end & ~at_start
    return {**edge_lanes_plain(x, n, ti, tj, test_both, alpha, n_perm, Tmax),
            "accepted": accepted, "test_both": test_both}


def edge_keep_plain(count, cnt, degen, quick0, test_both, ti, tj, n, alpha,
                    n_perm: int) -> dict:
    """Plain version of K15's keep flags (keep_table's first part), from
    K8's count and cnt int64 [2W]."""
    W = test_both.shape[0]
    p = count.to(torch.float32) / torch.full((), float(n_perm), dtype=_F,
                                             device=count.device)
    keep = torch.where(degen, False, torch.where(quick0, True, p <= alpha))
    at_end, at_start = tj >= n, ti <= 0
    return {"keep1": torch.where(test_both, keep[:W], at_end & ~at_start),
            "keep2": torch.where(test_both, keep[W:], at_start & ~at_end),
            "echunks": cnt.sum()}


def _exclusive_cumsum(v):
    return torch.cumsum(v, dim=0) - v


def _drop_set(table, idx, val):
    """table with table[idx] = val where idx < len(table); writes at
    idx >= len(table) are dropped (they go to an extra slot cut off)."""
    S = table.shape[0]
    ext = torch.cat([table, table[:1]])
    ext[torch.where(idx < S, idx, S)] = val
    return ext[:S]


def arc_pairs(lv: dict) -> torch.Tensor:
    """The level's arc pairs (K16's tally word): n (n + 1) / 2 summed over
    its pending analysable rows."""
    n = lv["n"]
    return torch.where(lv["pending"] & lv["analyzable"], n * (n + 1) // 2,
                       0).sum()


def table_update_plain(tab, pending0, lv: dict, walked, wchunks,
                       max_levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K16 (keep_table's second part): (tab, pending0)
    after the level whose rows are lv's (K13's fsel, contig, seg_lo, n,
    pending, analyzable; K10's ti, tj; K14's needs; K15's accepted, keep1,
    keep2, echunks) and K7's walked and wchunks."""
    S = pending0.shape[0]
    seg_c0, seg_lo0, seg_hi0 = tab[:S], tab[S:2 * S], tab[2 * S:3 * S]
    ctl = tab[3 * S:]
    nseg, overflow, level = ctl[NSEG], ctl[OVERFLOW] != 0, ctl[LEVEL]
    fsel, contig, seg_lo, n = lv["fsel"], lv["contig"], lv["seg_lo"], lv["n"]
    ti, tj = lv["ti"].long(), lv["tj"].long()
    accepted, needs = lv["accepted"], lv["needs"]
    seg_hi = seg_hi0[fsel]
    split1 = accepted & lv["keep1"]
    split2 = accepted & lv["keep2"] & (tj < n)
    # K16's five words; B4's arc terms as they are
    tally = ctl[TALLY:] + torch.stack([(walked & needs).sum(),
                                       (needs & ~walked).sum(),
                                       wchunks.sum(), lv["echunks"],
                                       arc_pairs(lv), torch.zeros_like(nseg)])
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
    pending0[fsel] = lv["pending"] & lv["analyzable"] & has_child
    for idx, lo_cut, hi_cut in ((idx_a, first_cut, second_cut),
                                (idx_b, second_cut, n)):
        seg_c0 = _drop_set(seg_c0, idx, contig)
        seg_lo0 = _drop_set(seg_lo0, idx, seg_lo + lo_cut)
        seg_hi0 = _drop_set(seg_hi0, idx, seg_lo + hi_cut)
        pending0 = _drop_set(pending0, idx, torch.ones_like(lv["pending"]))
    nseg = nseg + extra.sum()
    overflow = overflow | (nseg > S)
    level = level + 1
    live = pending0.any() & ~overflow & (level < max_levels)
    head = torch.stack([nseg, overflow.to(torch.int64), live.to(torch.int64),
                        level])
    return torch.cat([seg_c0, seg_lo0, seg_hi0, head, tally]), pending0


def keep_table_plain(tab, pending0, lv: dict, count, cnt, walked, wchunks,
                     alpha, n_perm: int, max_levels: int):
    """Plain version of keep_table: edge_keep_plain, then
    table_update_plain on lv with its keep flags; (keep1, keep2 and
    echunks, tab, pending0)."""
    keep = edge_keep_plain(count, cnt, lv["degen"], lv["quick0"],
                           lv["test_both"], lv["ti"], lv["tj"], lv["n"],
                           alpha, n_perm)
    return (keep, *table_update_plain(tab, pending0, {**lv, **keep}, walked,
                                      wchunks, max_levels))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _lib():
    return cuda_lib.load("cbs_level", _SIGNATURES)


def _host_live(tab: torch.Tensor, S: int) -> bool:
    return bool(tab[3 * S + LIVE])


def _put(out: dict, res: dict) -> None:
    for k, v in res.items():
        out[k].copy_(v)


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _check_table(tab, pending0) -> int:
    S = pending0.shape[0]
    if S > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} slots, got {S}")
    _check([("tab", tab, _L, (3 * S + CTL,)),
            ("pending0", pending0, _B, (S,))])
    return S


def _check_level(lv: dict, names, W: int, Tmax: int, tiers: int) -> None:
    dtypes = {**_ROWS, **_LANES, **_OTHER, **_SCRATCH}
    _check([(k, lv[k], dtypes[k], _shape(k, W, Tmax, tiers)) for k in names])


_PROLOGUE_OUT = ("fsel", "contig", "seg_lo", "n", "pending", "analyzable",
                 "n_eff", "x", "tss", "cs", "in_tier", "t2", "ti", "tj")


def prologue(contigs, tab, pending0, lv: dict, al0: int) -> None:
    """K13 into the level's tensors lv (level_buffers; W rows, contigs f32
    [C, Tmax], Tmax a power of two >= 1,024)."""
    W, Tmax = lv["x"].shape
    S = pending0.shape[0]
    tiers = len(tier_widths(Tmax))
    if _device(contigs) == "cpu":
        if _host_live(tab, S):
            _put(lv, prologue_plain(contigs, tab, pending0, W, al0))
        return
    S = _check_table(tab, pending0)
    _check([("contigs", contigs, _F, (contigs.shape[0], Tmax)),
            ("tab", tab, _L, (3 * S + CTL,))])
    _check_level(lv, _PROLOGUE_OUT, W, Tmax, tiers)
    if (W > S or Tmax % MIN_TIER or Tmax & (Tmax - 1)
            or prologue_layout(W, Tmax)[1] > MAX_TILES):
        raise ValueError(f"W {W} must be at most S {S}, Tmax {Tmax} a power "
                         f"of two >= {MIN_TIER} of at most {MAX_TILES} "
                         f"tiles")
    status = cuda_lib.launch(
        contigs.device, _lib().cbs_prologue, contigs.data_ptr(),
        tab.data_ptr(), pending0.data_ptr(),
        *(lv[k].data_ptr() for k in _PROLOGUE_OUT), S, W, Tmax, al0, tiers)
    cuda_lib.check(status, "cbs_prologue")
    LAUNCHES["prologue"] += PROLOGUE_LAUNCHES


def tail_decide(tab, S: int, lv: dict, alpha, kmax: int, n_grid: int,
                n_perm: int, n_min: int) -> None:
    """K11 carrying K14, one launch: lv's b (from its t2) and p1, the tail
    probability of b at n_eff bins over n_grid points, then its ostat,
    hybrid, needs, trivial and nrejc from its t2, ti, tj, n, analyzable,
    p1 and alpha (f32 scalar)."""
    if _device(tab) == "cpu":
        if _host_live(tab, S):
            _put(lv, tail_decide_plain(lv, alpha, kmax, n_grid, n_perm,
                                       n_min))
        return
    _check([("tab", tab, _L, (3 * S + CTL,))])
    cbs_stats_cuda.tail_decide_launch(lv, lv["n_eff"], alpha, kmax, n_grid,
                                      n_perm, n_min, tab[3 * S + LIVE])


_SETUP_OUT = ("xw", "wn", "m1", "xbar", "ostat_e", "degen", "quick0",
              "active", "accepted", "test_both", "limit")


def edge_setup(tab, S: int, lv: dict, walked, alpha, n_perm: int) -> None:
    """K15's first launch into lv, from its x, n, ti, tj and trivial and
    K7's walked."""
    W, Tmax = lv["x"].shape
    if _device(tab) == "cpu":
        if _host_live(tab, S):
            _put(lv, edge_setup_plain(lv["x"], lv["n"], lv["ti"], lv["tj"],
                                      lv["trivial"], walked, alpha, n_perm,
                                      Tmax))
        return
    if 2 * W > MAX_SLOTS or edge_layout(W, Tmax)[1] > MAX_TILES:
        raise ValueError(f"at most {MAX_SLOTS // 2} rows of at most "
                         f"{MAX_TILES} tiles, got {W} rows of {Tmax}")
    _check([("tab", tab, _L, (3 * S + CTL,)), ("alpha", alpha, _F, ()),
            ("walked", walked, _B, (W,))])
    _check_level(lv, ("x", "n", "ti", "tj", "trivial") + _SETUP_OUT
                 + tuple(_SCRATCH), W, Tmax, 0)
    status = cuda_lib.launch(
        tab.device, _lib().cbs_edge_setup, tab[3 * S:].data_ptr(),
        *(lv[k].data_ptr() for k in ("x", "n", "ti", "tj", "trivial")),
        walked.data_ptr(), alpha.data_ptr(),
        *(lv[k].data_ptr() for k in _SETUP_OUT + tuple(_SCRATCH)), W, Tmax,
        n_perm)
    cuda_lib.check(status, "cbs_edge_setup")
    LAUNCHES["edge_setup"] += 1


_KEEP_TABLE_IN = ("degen", "quick0", "fsel", "contig", "seg_lo", "n",
                  "pending", "analyzable", "accepted", "test_both", "ti",
                  "tj", "needs")


def keep_table(tab, pending0, lv: dict, count, cnt, walked, wchunks, alpha,
               n_perm: int, max_levels: int) -> None:
    """K15's keep flags and K16, one launch: lv's keep1, keep2 and
    echunks from K8's count and cnt, then tab and pending0 updated in
    place after the level lv, with K7's walked and wchunks."""
    W = lv["ti"].shape[0]
    S = pending0.shape[0]
    if _device(tab) == "cpu":
        if _host_live(tab, S):
            keep, new_tab, new_pending = keep_table_plain(
                tab, pending0, lv, count, cnt, walked, wchunks, alpha,
                n_perm, max_levels)
            _put(lv, keep)
            tab.copy_(new_tab)
            pending0.copy_(new_pending)
        return
    S = _check_table(tab, pending0)
    _check([("tab", tab, _L, (3 * S + CTL,)), ("alpha", alpha, _F, ()),
            ("count", count, _L, (2 * W,)), ("cnt", cnt, _L, (2 * W,)),
            ("walked", walked, _B, (W,)), ("wchunks", wchunks, _L, (W,))])
    _check_level(lv, _KEEP_TABLE_IN + ("keep1", "keep2", "echunks"), W, 0,
                 0)
    if W > S or 2 * W > MAX_SLOTS:
        raise ValueError(f"W {W} must be at most S {S} and "
                         f"{MAX_SLOTS // 2}")
    status = cuda_lib.launch(
        tab.device, _lib().cbs_keep_table, tab.data_ptr(),
        pending0.data_ptr(), count.data_ptr(), cnt.data_ptr(),
        lv["degen"].data_ptr(), lv["quick0"].data_ptr(), alpha.data_ptr(),
        *(lv[k].data_ptr() for k in _KEEP_TABLE_IN[2:]), walked.data_ptr(),
        wchunks.data_ptr(),
        *(lv[k].data_ptr() for k in ("keep1", "keep2", "echunks")), S, W,
        n_perm, max_levels)
    cuda_lib.check(status, "cbs_keep_table")
    LAUNCHES["keep_table"] += 1


def device_layout(rows: int, Tmax: int) -> tuple[int, int]:
    """(tile width, tiles a row) as csrc/cbs_level.cu's tile_width gives
    them for a launch over `rows` rows of Tmax positions (tile_layout is
    its mirror)."""
    out = (ctypes.c_int * 2)()
    cuda_lib.check(_lib().cbs_level_layout(rows, Tmax, out),
                   "cbs_level_layout")
    return out[0], out[1]


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """The kernel, memset and other nodes of a CUDA graph captured with
    keep_graph=True, and its kernel nodes launched cooperatively."""
    out = (ctypes.c_int * 4)()
    cuda_lib.check(_lib().cbs_graph_nodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), out), "cbs_graph_nodes")
    return {"kernels": out[0], "memsets": out[1], "other": out[2],
            "cooperative": out[3]}
