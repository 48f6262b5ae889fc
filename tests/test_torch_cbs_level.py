"""The whole-recursion CBS engine's level body on the CPU: the plain
versions of kernels K13-K16 (ops/cbs_level_cuda.py) against the torch glue
they replaced in ops/cbs_mega.py's level loop, on every level of engine
runs at small sizes from a numpy seed; the table after the run's end, the
table's overflow, and the replay schedule.

The replaced glue is kept here as it was (_old_level), level body and
edge-test set-up, and driven from each recorded table: every value it
computed must equal the plain versions' bit for bit."""

import numpy as np
import pytest
import torch

from canvas_tpu_torch.ops import cbs as _cbs
from canvas_tpu_torch.ops import cbs_level_cuda as cl
from canvas_tpu_torch.ops import cbs_mega as tmega
from canvas_tpu_torch.ops import cbs_mega_cuda
from canvas_tpu_torch.ops.cbs_device import (_cumsum, _gather_center,
                                             _tail_p_batch_dev, tmax_batch)

torch.set_num_threads(1)

N_PERM = 500
AL0, KMAX, N_MIN, N_GRID = 2, 25, 200, 100


def _old_edge_tests(x, n, i1, i2, test_both, key0, seg_c, seg_lo, alpha,
                    n_perm, Tmax):
    """ops/cbs_mega.py's _edge_tests as it was before K15."""
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

    def fsum(v):
        return v.double().sum(dim=-1).float()

    xsum1 = fsum(torch.where(pos < n1[:, None], xw, 0.0))
    xsum = fsum(xw)
    xbar = xsum / torch.clamp(wnf, min=1.0)
    tss = fsum(xw * xw) - wnf * xbar * xbar
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
    lanes = {"xw": xw, "wn": wn, "m1": m1, "xbar": xbar, "ostat_e": ostat,
             "degen": degen, "quick0": quick0, "active": active,
             "limit": limit}
    return keep[:W], keep[W:], cnt.sum(), lanes, (count, cnt)


def _old_level(contigs, seg_c0, seg_lo0, seg_hi0, pending0, nseg, overflow,
               tally, key0, sbdry, alpha, S, W, Tmax):
    """One level of ops/cbs_mega.py's _mega_recurse as it was before
    K13-K16 (its read and the loop left out): every value it computed, and
    the table after it."""
    dev = contigs.device
    tiers = tmega._tiers(Tmax)
    big = torch.finfo(torch.float32).max
    pos = torch.arange(Tmax, device=dev)[None, :]
    fsel = torch.argsort((~pending0).to(torch.int32), stable=True)[:W]
    seg_c, seg_lo, seg_hi = seg_c0[fsel], seg_lo0[fsel], seg_hi0[fsel]
    pending = pending0[fsel]
    n = seg_hi - seg_lo
    contig = torch.clamp(seg_c, min=0)
    x, tss = _gather_center(contigs, contig, seg_lo, n, Tmax)
    valid = pos < n[:, None]
    wmax = torch.where(valid, x, -big).amax(dim=1)
    wmin = torch.where(valid, x, big).amin(dim=1)
    analyzable = pending & (n >= 2 * AL0) & (wmax > wmin)
    n_eff = torch.where(analyzable, n, 2)
    in_tiers = [analyzable & (n_eff <= w) & (n_eff > (tiers[t - 1]
                                                     if t else 0))
                for t, w in enumerate(tiers)]
    x = torch.where(analyzable[:, None], x, 0.0)
    tss = torch.where(analyzable, tss, 0.0)
    cs = _cumsum(x)
    t2 = torch.zeros(W, dtype=torch.float32, device=dev)
    ti = torch.ones(W, dtype=torch.int64, device=dev)
    tj = torch.full((W,), 2, dtype=torch.int64, device=dev)
    for t, w in enumerate(tiers):
        if not bool(in_tiers[t].any()):
            continue
        in_tier = in_tiers[t]
        r0, r1, r2 = tmax_batch(
            torch.where(in_tier[:, None], cs[:, :w], 0.0),
            torch.where(in_tier, n_eff, 2),
            torch.where(in_tier, tss, 0.0), w, AL0)
        t2 = torch.where(in_tier, r0, t2)
        ti = torch.where(in_tier, r1.to(torch.int64), ti)
        tj = torch.where(in_tier, r2.to(torch.int64), tj)
    ostat1 = torch.sqrt(torch.clamp(t2, min=0.0))
    ostat = 0.99999 * t2
    b = ostat1.double()
    p1 = _tail_p_batch_dev(b, n_eff, KMAX, N_GRID).float()
    larc = torch.minimum(tj - ti, n - tj + ti)
    considered = analyzable & (ostat1 > 0.1)
    trivial = considered & (ostat1 >= 7.0) & (larc >= 10)
    hybrid = n > N_MIN
    tail_ok = torch.where(hybrid, p1 <= alpha, True)
    needs = considered & ~trivial & tail_ok
    nrejc = torch.where(
        hybrid, ((alpha - p1) * N_PERM).to(torch.int32),
        (alpha * float(N_PERM)).to(torch.int32)).to(torch.int64)
    walked, wchunks = cbs_mega_cuda.walk(
        x, n_eff, tss, key0, contig, seg_lo, needs, hybrid, ostat, nrejc,
        sbdry, N_PERM, AL0, KMAX, N_MIN)
    accepted = trivial | walked
    at_end = tj >= n
    at_start = ti <= 0
    test_both = accepted & ~at_end & ~at_start
    keep1t, keep2t, echunks, lanes, k8 = _old_edge_tests(
        x, n, ti, tj, test_both, key0, contig, seg_lo, alpha, N_PERM, Tmax)
    keep1 = torch.where(test_both, keep1t, at_end & ~at_start)
    keep2 = torch.where(test_both, keep2t, at_start & ~at_end)
    split1 = accepted & keep1
    split2 = accepted & keep2 & (tj < n)
    # the tally's last two words came after K16 replaced this glue: the
    # arc pairs, added here as K16 adds them, and B4's arc terms, which
    # B4's plain version leaves as they are
    tally = tally + torch.stack([(walked & needs).sum(),
                                 (needs & ~walked).sum(),
                                 wchunks.sum(), echunks,
                                 (torch.where(pending & analyzable,
                                              n * (n + 1), 0) // 2).sum(),
                                 torch.zeros_like(echunks)])
    nsplits = split1.to(torch.int64) + split2.to(torch.int64)
    has_child = nsplits > 0
    first_cut = torch.where(split1, ti, tj)
    second_cut = torch.where(split1 & split2, tj, n)
    extra = torch.where(has_child, 1 + (nsplits == 2).to(torch.int64), 0)
    base = nseg + torch.cumsum(extra, dim=0) - extra
    idx_a = torch.where(extra >= 1, base, S)
    idx_b = torch.where(extra == 2, base + 1, S)
    seg_hi0 = seg_hi0.clone()
    seg_hi0[fsel] = torch.where(has_child, seg_lo + first_cut, seg_hi)
    pending0 = pending0.clone()
    pending0[fsel] = pending & analyzable & has_child
    for idx, lo_cut, hi_cut in ((idx_a, first_cut, second_cut),
                                (idx_b, second_cut, n)):
        seg_c0 = cl._drop_set(seg_c0, idx, seg_c)
        seg_lo0 = cl._drop_set(seg_lo0, idx, seg_lo + lo_cut)
        seg_hi0 = cl._drop_set(seg_hi0, idx, seg_lo + hi_cut)
        pending0 = cl._drop_set(pending0, idx, torch.ones_like(pending))
    nseg = nseg + extra.sum()
    overflow = overflow | (nseg > S)
    return {"K13": {"fsel": fsel, "contig": contig, "seg_lo": seg_lo,
                    "n": n, "pending": pending, "analyzable": analyzable,
                    "n_eff": n_eff, "x": x, "tss": tss, "cs": cs,
                    "in_tier": torch.stack(in_tiers)},
            "tiers": {"t2": t2, "ti": ti, "tj": tj},
            "K14": {"b": b, "ostat": ostat, "hybrid": hybrid,
                    "needs": needs, "trivial": trivial, "nrejc": nrejc},
            "K7": (walked, wchunks),
            "K15": {**lanes, "accepted": accepted, "test_both": test_both},
            "K8": k8,
            "K15 keep": {"keep1": keep1, "keep2": keep2,
                         "echunks": echunks},
            "K16": {"seg_c0": seg_c0, "seg_lo0": seg_lo0,
                    "seg_hi0": seg_hi0, "pending0": pending0, "nseg": nseg,
                    "overflow": overflow, "tally": tally}}


def _new_level(contigs, tab, pending0, key0, sbdry, alpha, S, W, Tmax):
    """The same level through the plain versions of K13-K16 and the
    tier-masked K9, B4 and K10 (CPU tensors): every value, and the table
    after it."""
    lv = cl.prologue_plain(contigs, tab, pending0, W, AL0)
    out = {"K13": dict(lv)}
    t2, ti, tj = lv["t2"].clone(), lv["ti"].clone(), lv["tj"].clone()
    for t, w in enumerate(cl.tier_widths(Tmax)):
        tmax_batch(lv["cs"][:, :w], lv["n_eff"], lv["tss"], w, AL0,
                   mask=lv["in_tier"][t], out=(t2, ti, tj))
    out["tiers"] = {"t2": t2, "ti": ti, "tj": tj}
    b = cl.decide_prep_plain(t2)
    p1 = _tail_p_batch_dev(b, lv["n_eff"], KMAX, N_GRID)
    dec = cl.decide_plain(t2, ti, tj, lv["n"], lv["analyzable"], p1, alpha,
                          N_PERM, N_MIN)
    out["K14"] = {"b": b, **dec}
    out["p1"] = p1
    walked, wchunks = cbs_mega_cuda.walk(
        lv["x"], lv["n_eff"], lv["tss"], key0, lv["contig"], lv["seg_lo"],
        dec["needs"], dec["hybrid"], dec["ostat"], dec["nrejc"], sbdry,
        N_PERM, AL0, KMAX, N_MIN)
    out["K7"] = (walked, wchunks)
    setup = cl.edge_setup_plain(lv["x"], lv["n"], ti, tj, dec["trivial"],
                                walked, alpha, N_PERM, Tmax)
    out["K15"] = setup
    count, cnt = cbs_mega_cuda.edge_counts(
        setup["xw"], setup["wn"], setup["m1"], setup["xbar"],
        setup["ostat_e"], setup["active"], key0, lv["contig"], lv["seg_lo"],
        lv["n"], setup["limit"], N_PERM)
    out["K8"] = (count, cnt)
    keep = cl.edge_keep_plain(count, cnt, setup["degen"], setup["quick0"],
                              setup["test_both"], ti, tj, lv["n"], alpha,
                              N_PERM)
    out["K15 keep"] = keep
    rows = {**lv, "ti": ti, "tj": tj, **dec, **setup, **keep}
    new_tab, new_pending = cl.table_update_plain(tab, pending0, rows, walked,
                                                 wchunks, tmega._MAX_LEVELS)
    ctl = new_tab[3 * S:]
    out["rows"] = {**rows, "p1": p1}
    out["K7 K8"] = (walked, wchunks, count, cnt)
    out["K16"] = {"seg_c0": new_tab[:S], "seg_lo0": new_tab[S:2 * S],
                  "seg_hi0": new_tab[2 * S:3 * S], "pending0": new_pending,
                  "nseg": ctl[cl.NSEG], "overflow": ctl[cl.OVERFLOW] != 0,
                  "tally": ctl[cl.TALLY:]}
    out["ctl"] = ctl
    out["inputs"] = (contigs, tab, pending0)
    return out


def _bits(a, b) -> bool:
    if torch.is_tensor(a) and a.dtype in (torch.float32, torch.float64):
        w = torch.int32 if a.dtype == torch.float32 else torch.int64
        return b.dtype == a.dtype and torch.equal(a.view(w), b.view(w))
    return torch.equal(torch.as_tensor(a).long(), torch.as_tensor(b).long())


def _coverage(which: str) -> dict:
    rng = np.random.default_rng(21 if which == "steps" else 22)
    if which == "steps":
        # three contigs at Tmax 2,048: strong, weak and interior steps
        cov = {}
        for c, (n, events) in enumerate((
                (1800, ((300, 700, 3.0), (1200, 1260, -4.0))),
                (1400, ((500, 560, 0.7),)),
                (1000, ((350, 650, 0.35), (900, 1000, 2.5))))):
            r = rng.normal(0, 1, n)
            for s, e, d in events:
                r[s:e] += d
            cov[f"chr{c}"] = r
        return cov
    # two short contigs and a flat one (never analysed)
    cov = {"a": rng.normal(0, 1, 700), "b": rng.normal(0, 1, 300),
           "flat": np.full(500, 2.0)}
    cov["a"][100:400] += 2.0
    cov["b"][150:160] -= 6.0
    return cov


@pytest.fixture(scope="module", params=["steps", "short"])
def levels(request):
    """Each level of an engine run on CPU tensors: its table before and
    after, from K13's and keep_table's wrappers (K15's keep flags and
    K16); and the run's inputs."""
    cov = _coverage(request.param)
    recs, tables = [], []
    orig_pro, orig_tab = cl.prologue, cl.keep_table

    def prologue(contigs, tab, pending0, lv, al0):
        recs.append((contigs.clone(), tab.clone(), pending0.clone()))
        return orig_pro(contigs, tab, pending0, lv, al0)

    def keep_table(tab, pending0, *args):
        orig_tab(tab, pending0, *args)
        tables.append((tab.clone(), pending0.clone()))

    cl.prologue, cl.keep_table = prologue, keep_table
    key0 = torch.tensor([0, 0])
    try:
        counts: dict = {}
        tmega.run_cbs_mega(cov, n_perm=N_PERM, device="cpu", counts=counts)
    finally:
        cl.prologue, cl.keep_table = orig_pro, orig_tab
    sbdry = torch.as_tensor(np.asarray(_cbs.compute_boundary(
        N_PERM, _cbs.DEFAULT_ALPHA, _cbs.DEFAULT_ETA), np.int64))
    alpha = torch.tensor(_cbs.DEFAULT_ALPHA, dtype=torch.float32)
    assert len(recs) == len(tables) == counts["levels"] >= 2
    out = []
    for (contigs, tab, pending0), after in zip(recs, tables):
        S = pending0.shape[0]
        Tmax = contigs.shape[1]
        W = min(S, max(32, S // 2))
        ctl = tab[3 * S:]
        old = _old_level(contigs, tab[:S], tab[S:2 * S], tab[2 * S:3 * S],
                         pending0, ctl[cl.NSEG], ctl[cl.OVERFLOW] != 0,
                         ctl[cl.TALLY:], key0, sbdry, alpha, S, W, Tmax)
        new = _new_level(contigs, tab, pending0, key0, sbdry, alpha, S, W,
                         Tmax)
        out.append((old, new, after, S))
    return out


@pytest.mark.parametrize("part", ["K13", "tiers", "K14", "K7", "K15", "K8",
                                  "K15 keep", "K16"])
def test_plain_versions_equal_replaced_glue(levels, part):
    """Each plain version (and the tier-masked K9, B4, K10; K7 and K8 on
    their inputs) computes what the replaced glue computed, bit for bit,
    on every level of the run."""
    for old, new, _after, _S in levels:
        o, n = old[part], new[part]
        if isinstance(o, dict):
            for k, v in o.items():
                assert _bits(v, n[k]), (part, k)
        else:
            for a, b in zip(o, n):
                assert _bits(a, b), part


def test_engine_tables_follow_the_glue(levels):
    """The engine's table after each level is the replaced glue's, with
    the level count and live: the next level's, or 0 after the last."""
    for i, (old, new, (tab, pending0), S) in enumerate(levels):
        assert torch.equal(tab, torch.cat([new["K16"]["seg_c0"],
                                           new["K16"]["seg_lo0"],
                                           new["K16"]["seg_hi0"],
                                           new["ctl"]]))
        assert torch.equal(pending0, old["K16"]["pending0"])
        assert int(tab[3 * S + cl.LEVEL]) == i + 1
        last = i == len(levels) - 1
        assert int(tab[3 * S + cl.LIVE]) == (0 if last else 1)
    assert not bool(levels[-1][2][1].any())     # the last level: no pending


def _level_tensors(new, zero):
    """The level's tensors (level_buffers on the CPU) holding a level's
    rows as the chained plain versions left them, those named in `zero`
    (a fused wrapper's outputs) zeroed; the table before the level."""
    contigs, tab, pending0 = new["inputs"]
    W, Tmax = new["K13"]["x"].shape
    lv = cl.level_buffers(W, Tmax, len(cl.tier_widths(Tmax)),
                          torch.device("cpu"))
    for k, v in {**new["rows"], **new["tiers"]}.items():
        if k in lv:
            lv[k].copy_(v)
    for k in zero:
        lv[k].zero_()
    return lv, tab.clone(), pending0.clone()


_K14_OUT = ("b", "p1", "ostat", "hybrid", "needs", "trivial", "nrejc")


@pytest.mark.parametrize("live", [1, 0])
def test_tail_decide_equals_the_chain(levels, live):
    """tail_decide (K11 carrying K14) on CPU tensors gives what the three
    calls it replaced gave (decide_prep_plain, the tail probability,
    decide_plain) bit for bit on every level of the run; where live is 0
    it writes nothing."""
    alpha = torch.tensor(_cbs.DEFAULT_ALPHA, dtype=torch.float32)
    for _old, new, _after, S in levels:
        lv, tab, _pending0 = _level_tensors(new, _K14_OUT)
        tab[3 * S + cl.LIVE] = live
        before = {k: v.clone() for k, v in lv.items()}
        cl.tail_decide(tab, S, lv, alpha, KMAX, N_GRID, N_PERM, N_MIN)
        want = {**new["K14"], "p1": new["p1"]} if live else before
        for k in _K14_OUT:
            assert _bits(lv[k], want[k]), (k, live)
        for k, v in lv.items():
            if k not in _K14_OUT:
                assert _bits(v, before[k]), k


@pytest.mark.parametrize("live", [1, 0])
def test_keep_table_equals_the_chain(levels, live):
    """keep_table (K15's keep flags and K16) on CPU tensors gives what
    edge_keep_plain and table_update_plain gave, keep1, keep2, echunks,
    the table, its control words and the pending flags, bit for bit on
    every level of the run, and the engine's table after the level; where
    live is 0 it writes nothing."""
    alpha = torch.tensor(_cbs.DEFAULT_ALPHA, dtype=torch.float32)
    for _old, new, (tab_after, pend_after), S in levels:
        lv, tab, pending0 = _level_tensors(new, ("keep1", "keep2",
                                                 "echunks"))
        tab[3 * S + cl.LIVE] = live
        tab0, pending00 = tab.clone(), pending0.clone()
        lv0 = {k: v.clone() for k, v in lv.items()}
        walked, wchunks, count, cnt = new["K7 K8"]
        cl.keep_table(tab, pending0, lv, count, cnt, walked, wchunks, alpha,
                      N_PERM, tmega._MAX_LEVELS)
        if not live:
            assert torch.equal(tab, tab0) and torch.equal(pending0, pending00)
            for k, v in lv.items():
                assert _bits(v, lv0[k]), k
            continue
        for k, v in new["K15 keep"].items():
            assert _bits(lv[k], v), k
        assert torch.equal(tab, torch.cat([new["K16"]["seg_c0"],
                                           new["K16"]["seg_lo0"],
                                           new["K16"]["seg_hi0"],
                                           new["ctl"]]))
        assert torch.equal(pending0, new["K16"]["pending0"])
        assert torch.equal(tab, tab_after)
        assert torch.equal(pending0, pend_after)


def test_level_after_the_end_changes_nothing():
    """After a run live is 0: another level (every plain version behind
    its wrapper) leaves the table, its control words and the pending
    flags as they are."""
    counts: dict = {}
    tmega.run_cbs_mega(_coverage("short"), n_perm=N_PERM, device="cpu",
                       counts=counts)
    eng = next(reversed(tmega._ENGINES.values()))
    tab, pend = eng.tab.clone(), eng.pending0.clone()
    assert int(tab[3 * eng.S + cl.LIVE]) == 0
    assert int(tab[3 * eng.S + cl.LEVEL]) == counts["levels"]
    eng.level()
    assert torch.equal(eng.tab, tab) and torch.equal(eng.pending0, pend)


def test_one_engine_a_device():
    """A device keeps one engine: a run at the same shape reuses it (its
    buffers and, on the card, its graph), a run at another shape (here
    another Tmax) replaces it, and the segments stay the same."""
    cpu = torch.device("cpu")
    first = tmega.run_cbs_mega(_coverage("short"), n_perm=N_PERM,
                               device="cpu")
    eng = tmega._ENGINES[cpu]
    tmega.run_cbs_mega(_coverage("short"), n_perm=N_PERM, device="cpu")
    assert tmega._ENGINES[cpu] is eng
    tmega.run_cbs_mega(_coverage("steps"), n_perm=N_PERM, device="cpu")
    assert list(tmega._ENGINES) == [cpu]
    assert tmega._ENGINES[cpu] is not eng
    assert tmega._ENGINES[cpu].Tmax == 2048 and eng.Tmax == 1024
    again = tmega.run_cbs_mega(_coverage("short"), n_perm=N_PERM,
                               device="cpu")
    assert tmega._ENGINES[cpu].Tmax == 1024
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])


def test_table_overflow_drops_appends_and_ends_the_run():
    """K16's plain version: children past the table's S slots are
    dropped, nseg counts them all, overflow is set and live cleared."""
    S, W = 8, 4
    tab = torch.zeros(3 * S + cl.CTL, dtype=torch.int64)
    tab[:S] = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1])
    tab[2 * S:3 * S] = torch.tensor([100] * 7 + [0])
    ctl = tab[3 * S:]
    ctl[cl.NSEG], ctl[cl.LIVE] = 7, 1
    pending0 = torch.tensor([True] * 4 + [False] * 4)
    lv = {"fsel": torch.arange(W), "contig": torch.arange(W),
          "seg_lo": torch.zeros(W, dtype=torch.int64),
          "n": torch.full((W,), 100), "pending": torch.ones(W, dtype=bool),
          "analyzable": torch.ones(W, dtype=bool),
          "accepted": torch.tensor([True, True, False, True]),
          "keep1": torch.ones(W, dtype=bool),
          "keep2": torch.ones(W, dtype=bool),
          "ti": torch.full((W,), 30, dtype=torch.int32),
          "tj": torch.full((W,), 60, dtype=torch.int32),
          "needs": torch.zeros(W, dtype=bool),
          "echunks": torch.tensor(0)}
    new_tab, new_pending = cl.table_update_plain(
        tab, pending0, lv, torch.zeros(W, dtype=bool),
        torch.zeros(W, dtype=torch.int64), 128)
    c = new_tab[3 * S:]
    assert int(c[cl.NSEG]) == 7 + 6 and int(c[cl.OVERFLOW]) == 1
    assert int(c[cl.LIVE]) == 0 and int(c[cl.LEVEL]) == 1
    assert int(new_tab[7]) == 0 and int(new_tab[2 * S + 7]) == 60
    assert new_pending.tolist() == [True, True, False, True, False, False,
                                    False, True]
    assert new_tab[2 * S:2 * S + 4].tolist() == [30, 30, 100, 30]


@pytest.mark.parametrize("max_levels,want", [
    (128, [4, 8, 16, 32, 64, 4]), (1, [1]), (20, [4, 8, 8])])
def test_replay_batches(max_levels, want):
    assert list(tmega._batches(max_levels)) == want


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tmega.run_cbs_mega({"chr1": np.zeros(100)}, device="cuda")


# --- K13's and K15's tile order (csrc/cbs_level.cu), emulated in float64 ---

_WARPS = cl.TILE_THREADS // 32


def _butterfly(v):
    """A warp's butterfly sum over the last axis (32 lanes: lane l adds
    lane l ^ 16, then l ^ 8, ...), lane 0's value."""
    for h in (16, 8, 4, 2, 1):
        v = v[..., :h] + v[..., h:2 * h]
    return v[..., 0]


def _in_order(v):
    """((v[0] + v[1]) + v[2]) + ... over the last axis."""
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s


def _tile_sums(v, tile):
    """A kernel block's float64 sum of each tile of v [R, Tmax] float64:
    thread t adds its positions t, t + 128, ... of the tile in order from
    0.0, then each warp's butterfly, then the warps in order: [R, tiles]."""
    R, T = v.shape
    per = tile // cl.TILE_THREADS
    v = v.reshape(R, T // tile, per, cl.TILE_THREADS)
    s = torch.zeros(v.shape[:2] + (cl.TILE_THREADS,), dtype=torch.float64)
    for i in range(per):
        s = s + v[:, :, i, :]
    return _in_order(_butterfly(s.reshape(R, T // tile, _WARPS, 32)))


def _running(v):
    """[r_1, ..., r_n] with r_1 = v[0], r_i = r_(i-1) + v[i - 1] over the
    last axis: each index's in-order sum of the entries before it (r_0,
    where there is none, left 0)."""
    out = torch.zeros_like(v)
    for i in range(1, v.shape[-1]):
        out[..., i] = v[..., 0] if i == 1 else out[..., i - 1] + v[..., i - 1]
    return out


def _runs(u, tile):
    """K13's tile kernel on u [R, Tmax] float64 at tile width `tile`:
    thread t a run of per consecutive positions of each tile, [R, tiles,
    warps, 32, per]; the runs' running sums (a list over the run), the
    warps' Hillis-Steele scans of the run sums, and each tile's centred
    sum (the warps' scan totals in order) and sum of squares (each run's
    in order, the warp's butterfly, the warps in order), [R, tiles]
    each."""
    R, T = u.shape
    tiles, per = T // tile, tile // cl.TILE_THREADS
    runs = u.reshape(R, tiles, _WARPS, 32, per)
    acc = [runs[..., 0]]
    sq = runs[..., 0] * runs[..., 0]
    for i in range(1, per):
        acc.append(acc[-1] + runs[..., i])
        sq = sq + runs[..., i] * runs[..., i]
    inc = acc[-1]
    for o in (1, 2, 4, 8, 16):
        nxt = inc.clone()
        nxt[..., o:] = inc[..., o:] + inc[..., :-o]
        inc = nxt
    return acc, inc, _in_order(inc[..., 31]), _in_order(_butterfly(sq))


def _tile_cumsum(u, tile):
    """K13's cumsum of u [R, Tmax] float64 at tile width `tile`: a run's
    running sum after what comes before the run, the carry into tile k
    (the earlier tiles' centred sums in order), then the earlier warps'
    scan totals in order, then the earlier lanes' scan, each term only
    where there is one; f32 [R, Tmax]."""
    R, T = u.shape
    tiles = T // tile
    acc, inc, carry_sums, _sq = _runs(u, tile)
    k = torch.arange(tiles)[None, :, None, None]
    w = torch.arange(_WARPS)[None, None, :, None]
    lane = torch.arange(32)[None, None, None, :]
    pre = _running(carry_sums)[:, :, None, None]
    has = k > 0
    wo = _running(inc[..., 31])[..., None]
    pre = torch.where(w > 0, torch.where(has, pre + wo, wo), pre)
    has = has | (w > 0)
    ex = torch.nn.functional.pad(inc, (1, 0))[..., :32]
    pre = torch.where(lane > 0, torch.where(has, pre + ex, ex), pre)
    has = has | (lane > 0)
    out = torch.stack([torch.where(has, pre + a, a) for a in acc], dim=-1)
    return out.float().reshape(R, T)


def _k13_tiled(contigs, tab, pending0, W, al0):
    """K13's x, tss, cs, analyzable, n_eff and tier flags in its tile
    order at prologue_layout's width: the gathered values' tile sums added
    in tile order for the mean, analyzable from their extrema, the centred
    values' runs, the row's tss from its tiles' sums of squares in tile
    order, the cumsum."""
    S = pending0.shape[0]
    Tmax = contigs.shape[1]
    tile, _tiles = cl.prologue_layout(W, Tmax)
    fsel = torch.argsort((~pending0).to(torch.int32), stable=True)[:W]
    lo, n = tab[S:2 * S][fsel], tab[2 * S:3 * S][fsel] - tab[S:2 * S][fsel]
    contig = torch.clamp(tab[:S][fsel], min=0)
    pend = pending0[fsel]
    pos = torch.arange(Tmax)[None, :]
    valid = pos < torch.clamp(n, 0, Tmax)[:, None]
    ext = torch.nn.functional.pad(contigs, (0, Tmax))
    raw = torch.where(valid, ext[contig[:, None], lo[:, None] + pos], 0.0)
    mean = (_in_order(_tile_sums(raw.double(), tile))
            / torch.clamp(n, min=1)).float()
    u = torch.where(valid, raw - mean[:, None], 0.0)
    sq = _runs(u.double(), tile)[3]
    # analyzable from the gathered values' extrema: the centred
    # extrema are fl(max - mean) and fl(min - mean); a NaN or an infinity
    # makes the row not analyzable
    big = torch.finfo(torch.float32).max
    bad = (~torch.isfinite(raw) & valid).any(dim=1)
    fin = valid & torch.isfinite(raw)
    rmax = torch.where(fin, raw, -big).amax(dim=1)
    rmin = torch.where(fin, raw, big).amin(dim=1)
    an = pend & (n >= 2 * al0) & ~bad & (
        torch.clamp(rmax - mean, min=-big) > torch.clamp(rmin - mean, max=big))
    n_eff = torch.where(an, n, 2)
    tiers = cl.tier_widths(Tmax)
    in_tier = torch.stack([an & (n_eff <= w) & (n_eff > (tiers[t - 1]
                                                          if t else 0))
                           for t, w in enumerate(tiers)])
    x = torch.where(an[:, None], u, 0.0)
    cs = torch.where(an[:, None], _tile_cumsum(u.double(), tile), 0.0)
    tss = torch.where(an, _in_order(sq).float(), 0.0)
    return {"x": x, "tss": tss, "cs": cs, "analyzable": an, "n_eff": n_eff,
            "in_tier": in_tier}


def _edge_stats(wn, n1, xsum1, xsum, q):
    """edge_lanes_plain's statistics from the lanes' f32 sums."""
    n2 = wn - n1
    wnf = wn.to(torch.float32)
    xbar = xsum / torch.clamp(wnf, min=1.0)
    tss = q - wnf * xbar * xbar
    m1 = torch.minimum(n1, n2)
    m1f = torch.clamp(m1, min=1).to(torch.float32)
    mean_small = torch.where(n1 <= n2, xsum1 / torch.clamp(n1, min=1),
                             (xsum - xsum1) / torch.clamp(n2, min=1))
    ostat = 0.99999 * (mean_small - xbar).abs()
    tstat = ostat * ostat * m1f * wnf / torch.clamp(wnf - m1f, min=1.0)
    tstat = tstat / (torch.clamp(tss - tstat, min=1e-30)
                     / torch.clamp(wnf - 2.0, min=1.0))
    degen = (n1 <= 1) | (n2 <= 1)
    return {"xbar": xbar, "ostat_e": ostat, "degen": degen,
            "quick0": (tstat > 25.0) & (m1 >= 10), "m1": m1}


def _k15_tiled(x, n, ti, tj, order):
    """K15's lanes in its tile order at edge_layout's width: each (lane,
    tile) block's sums s1, s and q of the f32 squares, stored with an
    arrival count; the block that finds the lane's count at tiles - 1
    adds the lane's tile sums in tile order and leaves the count zero.
    Blocks arrive in `order` (a permutation of the tiles)."""
    W, Tmax = x.shape
    tile, tiles = cl.edge_layout(W, Tmax)
    ti, tj = ti.long(), tj.long()
    wn = torch.cat([tj, n - ti])
    n1 = torch.cat([ti, tj - ti])
    off = torch.cat([torch.zeros_like(ti), torch.clamp(ti, 0, Tmax)])
    pos = torch.arange(Tmax)[None, :]
    xx = torch.cat([x, x])
    at = off[:, None] + pos
    xw = torch.where((pos < wn[:, None]) & (at < Tmax),
                     xx.gather(1, torch.clamp(at, max=Tmax - 1)), 0.0)
    d = xw.double()
    parts = torch.stack([
        _tile_sums(torch.where(pos < n1[:, None], d, 0.0), tile),
        _tile_sums(d, tile), _tile_sums((xw * xw).double(), tile)])
    L = 2 * W
    count = torch.zeros(L, dtype=torch.int64)
    done = torch.zeros(L, dtype=torch.bool)
    store = torch.full((3, L, tiles), float("nan"), dtype=torch.float64)
    sums = torch.zeros(3, L, dtype=torch.float64)
    for k in order:
        store[:, :, k] = parts[:, :, k]
        last = count == tiles - 1
        count = torch.where(last, 0, count + 1)
        if bool(last.any()):
            sums[:, last] = _in_order(store[:, last, :])
            done |= last
    assert bool(done.all()) and not bool(count.any())
    f = sums.float()
    return {"xw": xw, "wn": wn, **_edge_stats(wn, n1, f[0], f[1], f[2])}


def _bits_dict(got: dict, want: dict, what):
    for k, v in got.items():
        assert _bits(v, want[k]), (what, k)


def test_k13_tile_order_equals_plain_on_levels(levels):
    """K13's tile order, emulated in float64 at prologue_layout's tiles,
    gives prologue_plain's x, tss, cs, analyzable, n_eff and tier flags
    bit for bit on every level of the run."""
    for _old, new, _after, _S in levels:
        W = new["K13"]["x"].shape[0]
        contigs, tab, pending0 = new["inputs"]
        _bits_dict(_k13_tiled(contigs, tab, pending0, W, AL0), new["K13"],
                   "K13")


@pytest.mark.parametrize("Tmax,W", [(4096, 32), (2048, 64), (1024, 32)])
def test_k13_tile_order_equals_plain_at_tile_edges(Tmax, W):
    """The same on seeded rows whose length sits at a tile edge, one above
    and one below it, one of them with an infinity, beside constant, NaN,
    short and non-pending rows."""
    tile, tiles = cl.prologue_layout(W, Tmax)
    rng = np.random.default_rng(Tmax + W)
    lens = []
    for k in range(1, tiles + 1):
        lens += [k * tile - 1, k * tile, k * tile + 1]
    lens = [m for m in lens if 2 * AL0 <= m <= Tmax][:W - 4]
    S = 2 * W
    C = len(lens) + 4
    contigs = rng.normal(0, 1, (C, Tmax)).astype(np.float32)
    n = lens + [900, 600, 2 * AL0 - 1, 700]    # constant, NaN, short, -
    lo = [int(rng.integers(0, Tmax - m + 1)) for m in n]
    contigs[-4, :] = 2.5                       # constant
    contigs[-3, lo[-3] + 5] = np.nan           # a NaN in the window
    contigs[0, lo[0] + 3] = np.inf             # an infinity
    tab = torch.zeros(3 * S + cl.CTL, dtype=torch.int64)
    pending0 = torch.zeros(S, dtype=torch.bool)
    for s, (m, start) in enumerate(zip(n, lo)):
        tab[s], tab[S + s], tab[2 * S + s] = s, start, start + m
        pending0[s] = s != len(n) - 1          # the last slot not pending
    tab[len(n):S] = -1
    c = torch.as_tensor(contigs)
    got = _k13_tiled(c, tab, pending0, W, AL0)
    _bits_dict(got, cl.prologue_plain(c, tab, pending0, W, AL0), (Tmax, W))
    assert int(got["analyzable"].sum()) == len(lens) - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k15_tile_order_equals_plain_on_levels(levels, seed):
    """K15's tile split and last-tile merge, emulated in float64 at
    edge_layout's tiles with the tiles arriving in seeded orders (the
    first in tile order, then reversed, then shuffled), gives
    edge_setup_plain's windows and statistics bit for bit on every level
    of the run, and leaves every arrival counter zero."""
    rng = np.random.default_rng(seed)
    for _old, new, _after, _S in levels:
        lv = new["K13"]
        W, Tmax = lv["x"].shape
        tiles = cl.edge_layout(W, Tmax)[1]
        order = [list(range(tiles)), list(reversed(range(tiles))),
                 list(rng.permutation(tiles))][seed]
        ti, tj = new["tiers"]["ti"], new["tiers"]["tj"]
        got = _k15_tiled(lv["x"], lv["n"], ti, tj, order)
        _bits_dict(got, new["K15"], order)


@pytest.mark.parametrize("Tmax", [1024 << k for k in range(7)])
def test_tile_layouts_cover_rows_and_fill_the_card(Tmax):
    """prologue_layout and edge_layout at every W from 1 to 512: powers
    of two from 128 to min(4,096, Tmax) whose tiles cover each row once,
    at most 16 a row (a thread block cluster), and a grid of at least the
    H100's 132 SMs wherever the level has that many tiles at the
    narrowest such width; the widest such tile short of twice that
    grid."""
    narrowest = max(128, Tmax // cl.MAX_TILES)
    for W in range(1, 513):
        for rows, (tile, tiles) in ((W, cl.prologue_layout(W, Tmax)),
                                    (2 * W, cl.edge_layout(W, Tmax))):
            assert tile & (tile - 1) == 0
            assert narrowest <= tile <= min(4096, Tmax)
            assert tiles * tile == Tmax and tiles <= cl.MAX_TILES
            covered = (np.arange(tiles)[:, None] * tile
                       + np.arange(tile)[None, :]).ravel()
            assert np.array_equal(np.sort(covered), np.arange(Tmax))
            if rows * (Tmax // narrowest) >= 132:
                assert rows * tiles >= 132, (rows, Tmax)
            if tile > narrowest:
                assert rows * tiles >= cl.TARGET_BLOCKS
            if 2 * tile <= min(4096, Tmax):
                assert rows * (tiles // 2) < cl.TARGET_BLOCKS
