"""The plain reference of CanvasPartition's CBS: DNAcopy's circular binary
segmentation as the whole-recursion engine defines it, in plain torch.

This is the yardstick that decides `correct`.  It is a frozen copy of the
engine's arithmetic, written against nothing of the program: the same
statistics (f32 values, sums and cumulative sums accumulated in float64
and rounded once to f32, the OU tail probability in float64), the same
threefry streams (`fold_in` chains on each segment's contig, start and
length, then the chunk counter; the edge tests under 7777 and 7778), the
same sequential stopping boundary (its own copy, boundary.py), and the
same rules for ties.  Each segment's test depends only on its own values
and keys, so the recursion here runs level by level over every pending
segment, grouped by tier width, and returns the engine's leaves whatever
order the engine takes them in.

Per pending segment of n bins at tier width w (the smallest power of two
>= 1,024 that holds n):
  * the window gathered and centred; a constant window, or n < 4, is a
    leaf;
  * the max-t statistic over circular arcs (ChangePoint's TMaxO): the
    extrema seed, a branch-and-bound over blocks of 512 lags in 32-lag
    sub-blocks, the winning (i, j) inside the last sub-block that raised
    the best (smallest lag a position, then the first position);
  * the OU tail probability over 100 grid points (hybrid segments,
    n > 200), the trivial rule (t >= 7 and an arc of >= 10), the walk
    limit;
  * the sequential-stopping permutation walk, chunks of 512 permutations
    at the tier width, hybrid (lags 2..25 with wrap arcs) or full;
  * the split-location edge tests (TPermP): m1-subsets as the m1 smallest
    of iid 32-bit keys, stopped once the count passes alpha * n_perm;
  * the split into up to three pieces.

`Precision` sets the arithmetic: `acc`, the dtype the sums, the
cumulative sums and the tail probability accumulate in (float64, the
engine's), and `store`, the dtype the centred values and the cumulative
sums are held in between the steps (float32, the engine's).  CONTROL
holds them in bfloat16, the step below the engine's float32: the
benchmark's check must reject it.  F32_SUMS accumulates in float32 (on a
CUDA device, where torch's float32 sums and cumulative sums accumulate in
float32; on the CPU they accumulate in float64 whatever the dtype).

segment() returns None where the engine's segment table (max(64, 4 C)
slots rounded up to a power of two) could not hold the leaves: the engine
then hands the input to its frontier engine, which this reference does
not model.
"""

from __future__ import annotations

import numpy as np
import torch

from cnvbench.reference import threefry
from cnvbench.reference.boundary import compute_boundary

ALPHA = 0.01            # CBSRunner.cs:11
N_PERM = 10000
ETA = 0.05
KMAX = 25
N_MIN = 200
MIN_WIDTH = 2
N_GRID = 100
SEED = 0                # the run's master seed: key (0, 0)

P_CHUNK = 512           # permutations a chunk
MIN_TIER = 1024
MAX_BINS = 65536
MAX_CONTIGS = 192
MIN_SLOTS = 64
PBLK, PTBL = 512, 32    # lags a pruning block, a sub-block
BCHUNK = 256            # positions a chunk of the block bound
EDGE_TAG = 7777
PERM_ELEMS = 1 << 25    # permuted values a batch
NU_SERIES_TERMS, NU_SERIES_CHUNK = 8192, 2048
NU_TAIL_PANELS, NU_TAIL_SLOTS = 128, 256
MAX_GRID = 128
NU_BATCH = 4096

_BOUNDARY: dict = {}


def boundary(n_perm: int = N_PERM, alpha: float = ALPHA) -> np.ndarray:
    """The stopping boundary, computed once a process."""
    key = (n_perm, alpha)
    if key not in _BOUNDARY:
        _BOUNDARY[key] = compute_boundary(n_perm, alpha, ETA)
    return _BOUNDARY[key]


def _pow2(v: int, floor: int) -> int:
    return max(floor, 1 << (int(v) - 1).bit_length())


def tier_width(n: int) -> int:
    return max(MIN_TIER, 1 << (int(n) - 1).bit_length())


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-dim tensor: dividing by it is IEEE division on every
    device (a division by a Python scalar on the card multiplies by the
    reciprocal)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


class Precision:
    """The dtype sums accumulate in and the dtype values and cumulative
    sums are held in; the statistics are computed in f32 from them."""

    def __init__(self, acc: torch.dtype = torch.float64,
                 store: torch.dtype = torch.float32):
        self.acc, self.store = acc, store

    def held(self, x):
        return x.to(self.store).float()

    def fsum(self, v):
        return v.to(self.acc).sum(dim=-1).float()

    def cumsum(self, x):
        return torch.cumsum(x.to(self.acc), dim=-1).to(self.store).float()


ENGINE = Precision()
CONTROL = Precision(store=torch.bfloat16)
F32_SUMS = Precision(acc=torch.float32)


# ---------------------------------------------------------------------------
# The max-t statistic over circular arcs
# ---------------------------------------------------------------------------

def _gather_center(contigs, cidx, lo, n, npad, prec: Precision):
    dev = contigs.device
    ext = torch.nn.functional.pad(contigs, (0, npad))
    j = torch.arange(npad, device=dev)
    x = ext[cidx[:, None], lo[:, None] + j[None, :]]
    valid = j[None, :] < n[:, None]
    x = torch.where(valid, x, 0.0)
    mean = (x.to(prec.acc).sum(dim=1) / torch.clamp(n, min=1)).float()
    x = prec.held(torch.where(valid, x - mean[:, None], 0.0))
    tss = x.to(prec.acc).square().sum(dim=1).float()
    return x, tss


def _block_d2_bound(cs, psdiff, npad, sblk):
    """[B, nblk] bound on d^2 over the pairs whose lag lies in each block:
    chunk extrema at the chunk distances the block's lags reach."""
    B = cs.shape[0]
    dev = cs.device
    nblk = max(npad // sblk, 1)
    C = min(BCHUNK, npad)
    nchunk = npad // C
    csr = cs.reshape(B, nchunk, C)
    M = csr.amax(dim=2)
    m = csr.amin(dim=2)
    a = torch.arange(nchunk, device=dev)
    dist = (a[None, :] - a[:, None]).abs().reshape(1, -1).expand(B, -1)
    pair = (M[:, None, :] - m[:, :, None]).reshape(B, -1)
    by_db = torch.full((B, nchunk), -torch.inf, dtype=cs.dtype, device=dev)
    by_db = by_db.scatter_reduce(1, dist, pair, reduce="amax")
    k = torch.arange(nblk, device=dev)[:, None]
    db_lo = torch.clamp(k * sblk // C - 1, min=0)
    db_hi = torch.clamp((k * sblk + sblk - 1) // C + 1, max=nchunk - 1)
    reach = (a[None, :] >= db_lo) & (a[None, :] <= db_hi)
    bnd = torch.where(reach[None], by_db[:, None, :], -torch.inf).amax(dim=2)
    d = torch.minimum(psdiff[:, None], bnd)
    return (d * d).to(torch.float32)


def _arc_inputs(cs, n, npad, al0):
    """(seed, lag_hi, psd2, ti0, tj0): the extrema pair's score and
    split, the largest lag, the per-block bound."""
    blk = min(PBLK, npad)
    big = torch.finfo(torch.float32).max
    valid = torch.arange(npad, device=cs.device)[None, :] < n[:, None]
    imin = torch.argmin(torch.where(valid, cs, big), dim=1)
    imax = torch.argmax(torch.where(valid, cs, -big), dim=1)
    cmin = cs.gather(1, imin[:, None])[:, 0]
    cmax = cs.gather(1, imax[:, None])[:, 0]
    psdiff = cmax - cmin
    nf = n.to(torch.float32)
    rjs = torch.clamp((imax - imin).abs(), min=1).to(torch.float32)
    seed = torch.where(psdiff > 0, nf / (rjs * (nf - rjs)) * psdiff * psdiff,
                       0.0)
    lag_hi = torch.minimum(n - al0, n - 1).to(torch.int32)
    psd2 = _block_d2_bound(cs, psdiff, npad, blk)
    ti0 = (torch.minimum(imin, imax) + 1).to(torch.int32)
    tj0 = (torch.maximum(imin, imax) + 1).to(torch.int32)
    return seed, lag_hi, psd2, ti0, tj0


def _w_of(L, n):
    hi = torch.clamp(n - 1, min=1)
    Lf = torch.minimum(torch.clamp(L, min=1), hi).to(torch.float32)
    nf = n.to(torch.float32)
    return nf / (Lf * (nf - Lf))


def _arc_scan(cs, n, lag_hi, seed, psd2, al0):
    """(best, bl0): the best term w * (d * d) over the lags and positions
    a row admits, blocks in lag order, a block skipped where its bound
    cannot beat the running best; bl0 the first lag of the last
    sub-block that raised it (-1: the seed was never beaten)."""
    B, npad = cs.shape
    blk = min(PBLK, npad)
    sub = min(PTBL, blk)
    nblk, nsub = max((npad + blk - 1) // blk, 1), blk // sub
    dev = cs.device
    cs2 = torch.cat([cs, torch.zeros_like(cs)], dim=1)
    pos = torch.arange(npad, device=dev)
    t_off = torch.arange(sub, device=dev)
    best = seed.clone()
    bl0 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for k in range(nblk):
        l0 = k * blk
        in_range = (l0 <= lag_hi) & (l0 + blk - 1 >= al0)
        lo = torch.full_like(n, max(l0, al0))
        hi = torch.clamp(lag_hi, max=l0 + blk - 1)
        gate = torch.maximum(_w_of(lo, n), _w_of(hi, n)) * psd2[:, k]
        go = in_range & (gate > best)
        if not bool(go.any()):
            continue
        rows = torch.nonzero(go)[:, 0]
        g = rows.shape[0]
        win = cs2[rows].unfold(1, npad, 1)
        cs_g, n_g, lag_hi_g = cs[rows], n[rows], lag_hi[rows]
        for q in range(nsub):
            L0 = k * blk + q * sub
            lags = L0 + t_off
            d = win[:, L0:L0 + sub, :] - cs_g[:, None, :]
            live = (lags[None] >= al0) & (lags[None] <= lag_hi_g[:, None])
            wv = torch.where(live, _w_of(lags[None].expand(g, sub),
                                         n_g[:, None]), -1.0)
            ok = pos[None, None, :] <= (n_g[:, None, None] - 1
                                        - lags[None, :, None])
            vals = torch.where(ok, wv[:, :, None] * (d * d), -1.0)
            m = vals.amax(dim=(1, 2))
            upd = m > best[rows]
            best[rows] = torch.where(upd, m, best[rows])
            bl0[rows] = torch.where(upd, L0, bl0[rows])
    return best, bl0


def _refine(cs, n, tss, lag_hi, best, bl0, ti0, tj0, npad, al0):
    """(t2, ti, tj): the split inside the winning sub-block and t^2."""
    B = cs.shape[0]
    dev = cs.device
    sub = min(PTBL, PBLK, npad)
    pos = torch.arange(npad, device=dev)
    nf = n.to(torch.float32)
    hit = bl0 >= 0
    b0c = torch.clamp(bl0, min=0).to(torch.int64)
    cs2 = torch.cat([cs, torch.zeros_like(cs)], dim=1)
    base = cs2.gather(
        1, b0c[:, None] + torch.arange(npad + sub, device=dev)[None, :])
    val = torch.full((B, npad), -1.0, dtype=torch.float32, device=dev)
    lagk = torch.zeros((B, npad), dtype=torch.int64, device=dev)
    for k in range(sub):
        lag = b0c + k
        lag_ok = (lag >= al0) & (lag <= lag_hi)
        d = base[:, k:k + npad] - cs
        ok = lag_ok[:, None] & (pos[None, :] + lag[:, None]
                                <= n[:, None] - 1)
        lf = torch.clamp(lag, min=1).to(torch.float32)
        w = (nf / (lf * (nf - lf)))[:, None]
        v = torch.where(ok, w * d * d, -1.0)
        upd = v > val
        val = torch.where(upd, v, val)
        lagk = torch.where(upd, k, lagk)
    flat_i = torch.argmax(val, dim=1)
    sel_lag = b0c + lagk.gather(1, flat_i[:, None])[:, 0]
    ti = torch.where(hit, flat_i + 1, ti0).to(torch.int32)
    tj = torch.where(hit, flat_i + sel_lag + 1, tj0).to(torch.int32)
    tssv = torch.where(tss <= best + 1e-4, best + 1.0, tss)
    t2 = best / ((tssv - best) / torch.clamp(nf - 2.0, min=1.0))
    return t2, ti, tj


def tmax(cs, n, tss, npad, al0):
    """(t2 f32, ti, tj int32) of the rows of the cumsum cs [B, npad]."""
    seed, lag_hi, psd2, ti0, tj0 = _arc_inputs(cs, n, npad, al0)
    best, bl0 = _arc_scan(cs, n.to(torch.int32), lag_hi, seed, psd2, al0)
    return _refine(cs, n, tss, lag_hi, best, bl0, ti0, tj0, npad, al0)


# ---------------------------------------------------------------------------
# The OU tail probability (TailProbability.TailP)
# ---------------------------------------------------------------------------

def _tree_sum(v, slots: int):
    """The sum over the last axis as an adjacent-pair tree over `slots`
    slots, zero past the values."""
    v = torch.nn.functional.pad(v, (0, slots - v.shape[-1]))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _nu(x):
    """TailProbability.Nu: 8,192 series terms in four chunks, each summed
    as a tree, then an Euler-Maclaurin tail by Simpson's rule."""
    dev, dt = x.device, x.dtype
    K = NU_SERIES_CHUNK
    two, sqrt2 = _const(2.0, x), _const(float(np.sqrt(2.0)), x)
    series = torch.empty_like(x)
    for s0 in range(0, x.shape[0], NU_BATCH):
        xs = x[s0:s0 + NU_BATCH, None]
        acc = None
        for c in range(NU_SERIES_TERMS // K):
            k = (c * K + torch.arange(1, K + 1, device=dev)).to(dt)
            z = xs * torch.sqrt(k)[None, :] / two / sqrt2
            t = torch.special.erfc(z) * 0.5 * (two / k)[None, :]
            s = _tree_sum(t, K)
            acc = s if acc is None else acc + s
        series[s0:s0 + NU_BATCH] = acc
    v0c = torch.clamp(x * float(np.sqrt(NU_SERIES_TERMS + 0.5)) / two,
                      max=9.0)
    h = (9.0 - v0c) / _const(NU_TAIL_PANELS, x)
    j = torch.arange(NU_TAIL_PANELS + 1, device=dev)
    u = v0c[:, None] + h[:, None] * j.to(dt)[None, :]
    f = 0.5 * torch.special.erfc(u / sqrt2) / torch.clamp(u, min=1e-12)
    simp = torch.where((j == 0) | (j == NU_TAIL_PANELS), 1.0,
                       torch.where(j % 2 == 1, 4.0, 2.0)).to(dt)
    tail = 4.0 * (h / _const(3.0, x)) * _tree_sum(f * simp[None, :],
                                                  NU_TAIL_SLOTS)
    lnu = float(np.log(2.0)) - 2.0 * torch.log(torch.clamp(x, min=1e-12)) \
        - series - tail
    return torch.where(x <= 0.01, torch.exp(-0.583 * x), torch.exp(lnu))


def _integral_inv_t1t_sq(tl, a):
    def f(y):
        return (8.0 * y / (1.0 - 4.0 * y * y)
                + 2.0 * torch.log((1 + 2 * y) / (1 - 2 * y)))
    return f(tl + a - 0.5) - f(tl - 0.5)


def tail_p(b, n, kmax: int, n_grid: int):
    """The OU tail probability of b at n bins, delta = (kmax + 1) / n,
    in the dtype of b; the grid points' terms summed as a tree."""
    dt = b.dtype
    nf = n.to(dt)
    delta = torch.clamp(_const(kmax + 1.0, b) / nf, 0.0, 0.45)
    dincr = (0.5 - delta) / _const(n_grid, b)
    i = torch.arange(n_grid, device=b.device).to(dt)[None, :]
    tls = 0.5 + i * dincr[:, None]
    ts = 0.5 + (i + 0.5) * dincr[:, None]
    bsqrtm = b / torch.sqrt(nf)
    xg = bsqrtm[:, None] / torch.sqrt(ts * (1 - ts))
    nus = _nu(xg.reshape(-1)).reshape(xg.shape)
    integ = _integral_inv_t1t_sq(tls, dincr[:, None])
    out = _tree_sum(nus * nus * integ, MAX_GRID)
    return 2.0 * 9.973557e-2 * (b * b * b) \
        * torch.exp(-b * b / _const(2.0, b)) * out


# ---------------------------------------------------------------------------
# The permutation walk (ChangePoint.cs:206-246)
# ---------------------------------------------------------------------------

def _seg_keys(key0, seg_c, seg_lo, n):
    k = threefry.fold_in(key0, seg_c)
    k = threefry.fold_in(k, seg_lo)
    return threefry.fold_in(k, n)


def _device_perms(keys, xr, nn, npad, P):
    """[S, P, npad]: each row's values permuted by a stable sort of its
    uniforms, padding drawing 2.0 and sorting last."""
    S = xr.shape[0]
    u = threefry.uniform(keys, (P, npad))
    live = torch.arange(npad, device=xr.device)[None, None, :] \
        < nn[:, None, None]
    u = torch.where(live, u, 2.0)
    order = torch.sort(u, dim=2, stable=True).indices
    return torch.gather(xr[:, None, :].expand(S, P, npad), 2, order)


def _htmax_core(cs, nn, tss, npad, al0, kmax):
    """Short-arc max-t (HTMaxP): lags al0..kmax with wrap arcs."""
    R = cs.shape[0]
    dev = cs.device
    nf = nn.to(cs.dtype)
    idx = torch.arange(npad, device=dev)
    best = torch.zeros(R, dtype=cs.dtype, device=dev)
    for L in range(al0, min(kmax, npad - 1) + 1):
        d_lin = (cs[:, L:] - cs[:, :-L]).abs()
        lin_ok = idx[None, :npad - L] + L <= nn[:, None] - 1
        d1 = torch.where(lin_ok, d_lin, 0.0).amax(dim=1)
        start = torch.clamp(nn - L, min=0, max=npad - L).to(torch.int64)
        tail = cs.gather(1, start[:, None] + idx[None, :L])
        wrap_ok = (nn[:, None] - L + idx[None, :L] >= 0) \
            & (idx[None, :L] < nn[:, None])
        d2 = torch.where(wrap_ok, (tail - cs[:, :L]).abs(), 0.0).amax(dim=1)
        d = torch.maximum(d1, d2)
        w = nf / (L * (nf - L))
        best = torch.where(L <= nn - 1, torch.maximum(best, w * d * d), best)
    tssv = torch.where(tss <= best + 1e-4, best + 1.0, tss)
    return best / ((tssv - best) / (nf - 2.0))


def _tmax_full_core(cs, nn, tss, npad, al0, max_lag):
    """Full-arc max-t (TMaxP): lags al0..n-al0, no wrap."""
    R = cs.shape[0]
    dev = cs.device
    nf = nn.to(cs.dtype)
    idx = torch.arange(npad, device=dev)
    lag_hi = torch.minimum(nn - al0, nn - 1)
    cs2 = torch.cat([cs, torch.zeros_like(cs)], dim=1)
    best = torch.zeros(R, dtype=cs.dtype, device=dev)
    for L in range(al0, max_lag + 1):
        d = (cs2[:, L:L + npad] - cs).abs()
        ok = idx[None, :] + L <= nn[:, None] - 1
        dmax = torch.where(ok, d, 0.0).amax(dim=1)
        w = nf / (L * (nf - L))
        live = L <= lag_hi
        best = torch.where(live, torch.maximum(best, w * dmax * dmax), best)
    tssv = torch.where(tss <= best + 1e-4, best + 1.0, tss)
    return best / ((tssv - best) / (nf - 2.0))


def _perm_stats(x, nn, tss, keys, npad, P, al0, kmax, full, max_len,
                prec: Precision):
    S = x.shape[0]
    out = torch.empty((S, P), dtype=torch.float32, device=x.device)
    per = max(1, PERM_ELEMS // (P * npad))
    top = min(max_len, npad)
    for s0 in range(0, S, per):
        s1 = min(S, s0 + per)
        px = _device_perms(keys[s0:s1], x[s0:s1], nn[s0:s1], npad, P)
        pcs = prec.cumsum(px).reshape(-1, npad)
        nn_r = nn[s0:s1].repeat_interleave(P)
        tss_r = tss[s0:s1].repeat_interleave(P)
        if full:
            st = _tmax_full_core(pcs[:, :top].contiguous(), nn_r, tss_r, top,
                                 al0, min(top - al0, top - 1))
        else:
            st = _htmax_core(pcs, nn_r, tss_r, npad, al0, kmax)
        out[s0:s1] = st.reshape(s1 - s0, P)
    return out


def _walk_update(ostat, nrejc, np0, nrej0, k0, walking, pstats, sbdry,
                 n_perm):
    """One chunk through the boundary walk: (accept_now, walking', np',
    nrej', k'); a reject at the same permutation as an accept wins."""
    S, P = pstats.shape
    dev = pstats.device
    csum = torch.cumsum((ostat[:, None] <= pstats).to(torch.int64), dim=1)
    nrej_j = nrej0[:, None] + csum
    k_j = k0[:, None] + csum
    np_j = np0[:, None] + torch.arange(1, P + 1, device=dev)[None, :]
    rej = nrej_j > nrejc[:, None]
    sb = sbdry[torch.clamp(k_j - 1, 0, sbdry.shape[0] - 1)]
    acc = (np_j >= sb) | (np_j >= n_perm)
    first_rej = torch.where(rej.any(dim=1),
                            torch.argmax(rej.to(torch.int32), dim=1), P)
    first_acc = torch.where(acc.any(dim=1),
                            torch.argmax(acc.to(torch.int32), dim=1), P)
    decided = walking & ((first_rej < P) | (first_acc < P))
    accept_now = decided & (first_acc < first_rej)
    np1 = torch.where(walking, np0 + P, np0)
    nrej1 = torch.where(walking, nrej0 + csum[:, -1], nrej0)
    k1 = torch.where(walking, k0 + csum[:, -1], k0)
    exhausted = walking & ~decided & (np1 >= n_perm)
    accept_now = accept_now | exhausted
    walking1 = walking & ~decided & ~exhausted
    return accept_now, walking1, np1, nrej1, k1


def walk(x, n, tss, key0, seg_c, seg_lo, walking, hybrid, ostat, nrejc,
         sbdry, n_perm, al0, kmax, n_min, prec: Precision):
    """Each walking row's chunks until it is decided: (accepted bool)."""
    W = x.shape[0]
    dev = x.device
    keys = _seg_keys(key0, seg_c, seg_lo, n)
    accepted = torch.zeros(W, dtype=torch.bool, device=dev)
    for r in range(W):
        if not bool(walking[r]):
            continue
        w = tier_width(int(n[r]))
        rr = slice(r, r + 1)
        live = walking[rr]
        np0 = torch.zeros(1, dtype=torch.int64, device=dev)
        nrej0 = torch.zeros_like(np0)
        k0 = nrejc[rr] * (nrejc[rr] + 1) // 2 + 1
        c = 0
        while bool(live):
            ps = _perm_stats(x[rr, :w], n[rr], tss[rr],
                             threefry.fold_in(keys[rr], c), w, P_CHUNK, al0,
                             kmax, not bool(hybrid[r]), n_min, prec)
            acc, live, np0, nrej0, k0 = _walk_update(
                ostat[rr], nrejc[rr], np0, nrej0, k0, live, ps, sbdry,
                n_perm)
            accepted[r] = accepted[r] | acc[0]
            c += 1
    return accepted


# ---------------------------------------------------------------------------
# The split-location edge tests (ChangePoint.cs:359-398, TPermP)
# ---------------------------------------------------------------------------

def _edge_lanes(x, n, i1, i2, test_both, alpha, n_perm, npad, prec: Precision):
    """Lanes [2R]: edge 1 (the split at i1 inside x[0:i2]) of every row,
    then edge 2 (the split at i2 inside x[i1:n])."""
    dev = x.device
    wn = torch.cat([i2, n - i1])
    n1 = torch.cat([i1, i2 - i1])
    mask = torch.cat([test_both, test_both])
    pos = torch.arange(npad, device=dev)[None, :]
    x2 = torch.nn.functional.pad(x, (0, npad))
    xe2 = x2.gather(1, torch.clamp(i1, 0, npad)[:, None] + pos)
    xw = torch.where(pos < wn[:, None], torch.cat([x, xe2]), 0.0)
    n2 = wn - n1
    wnf = wn.to(torch.float32)
    xsum1 = prec.fsum(torch.where(pos < n1[:, None], xw, 0.0))
    xsum = prec.fsum(xw)
    xbar = xsum / torch.clamp(wnf, min=1.0)
    tss = prec.fsum(xw * xw) - wnf * xbar * xbar
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
    return {"xw": xw, "wn": wn, "m1": m1, "xbar": xbar, "ostat": ostat,
            "degen": degen, "quick0": quick0,
            "active": mask & ~degen & ~quick0, "limit": alpha * n_perm}


def _subset_sums(xr, nn, mm, mm_host, keys, npad, cols, prec: Precision):
    """[R, P_CHUNK] sums over the m-subsets whose keys are the m smallest
    of the [P_CHUNK, npad] uint32 draws (ties by index; padding draws
    0xFFFFFFFF)."""
    R = xr.shape[0]
    dev = xr.device
    out = torch.empty((R, P_CHUNK), dtype=torch.float32, device=dev)
    per = max(1, PERM_ELEMS // (P_CHUNK * cols))
    real = torch.arange(cols, device=dev)[None, None, :]
    for s0 in range(0, R, per):
        s1 = min(R, s0 + per)
        u = threefry.random_bits(keys[s0:s1], (P_CHUNK, npad), cols)
        u = torch.where(real < nn[s0:s1, None, None], u, 0xFFFFFFFF)
        tau = torch.stack([torch.kthvalue(u[i], mm_host[s0 + i]).values
                           for i in range(s1 - s0)])
        less = u < tau[..., None]
        k_t = mm[s0:s1, None] - less.sum(dim=2)
        tie = u == tau[..., None]
        cum = torch.cumsum(tie.to(torch.int64), dim=2)
        pick = less | (tie & (cum <= k_t[..., None]))
        out[s0:s1] = prec.fsum(torch.where(pick, xr[s0:s1, None, :cols],
                                           0.0))
    return out


def edge_counts(lanes, key0, seg_c, seg_lo, seg_n, n_perm, prec: Precision):
    """Each active lane's chunks until its count passes the limit or
    n_perm permutations are done: count int64 [2R]."""
    xw, wn, m1 = lanes["xw"], lanes["wn"], lanes["m1"]
    xbar, ostat, active = lanes["xbar"], lanes["ostat"], lanes["active"]
    limit = lanes["limit"]
    L = xw.shape[0]
    dev = xw.device
    k = _seg_keys(key0, seg_c, seg_lo, seg_n)
    ekeys = torch.cat([threefry.fold_in(k, EDGE_TAG + e)
                       for e in range(L // seg_c.shape[0])])
    count = torch.zeros(L, dtype=torch.int64, device=dev)
    m1f = torch.clamp(m1, min=1).to(torch.float32)
    lane = torch.arange(P_CHUNK, device=dev)
    for r in range(L):
        if not bool(active[r]):
            continue
        w, mm = int(wn[r]), int(m1[r])
        rr = slice(r, r + 1)
        live, done, c = active[r], 0, 0
        while bool(live):
            s = _subset_sums(xw[rr], wn[rr], m1[rr], [mm],
                             threefry.fold_in(ekeys[rr], c), tier_width(w),
                             w, prec)[0]
            take = min(n_perm - done, P_CHUNK)
            pstat = (s / m1f[r] - xbar[r]).abs()
            count[r] += ((ostat[r] <= pstat) & (lane < take)).sum()
            done += take
            c += 1
            live = (count[r].to(torch.float32) <= limit) & (done < n_perm)
    return count


# ---------------------------------------------------------------------------
# One level over a group of segments at one tier width
# ---------------------------------------------------------------------------

def _split_group(contigs, cidx, lo, n, w, key0, alpha, sbdry, prec: Precision,
                 n_perm, al0, kmax, n_min, n_grid):
    """Each segment's cuts at this level: (first_cut, second_cut, children)
    int lists, children 0 for a leaf."""
    dev = contigs.device
    x, tss = _gather_center(contigs, cidx, lo, n, w, prec)
    big = torch.finfo(torch.float32).max
    valid = torch.arange(w, device=dev)[None, :] < n[:, None]
    wmax = torch.where(valid, x, -big).amax(dim=1)
    wmin = torch.where(valid, x, big).amin(dim=1)
    analyzable = (n >= 2 * al0) & (wmax > wmin)
    x = torch.where(analyzable[:, None], x, 0.0)
    tss = torch.where(analyzable, tss, 0.0)
    cs = prec.cumsum(x)
    B = n.shape[0]
    t2 = torch.zeros(B, dtype=torch.float32, device=dev)
    ti = torch.ones(B, dtype=torch.int32, device=dev)
    tj = torch.full((B,), 2, dtype=torch.int32, device=dev)
    ra = torch.nonzero(analyzable)[:, 0]
    if len(ra):
        t2[ra], ti[ra], tj[ra] = tmax(cs[ra], n[ra], tss[ra], w, al0)
    n_eff = torch.where(analyzable, n, 2)
    # the tail probability and the decision rules
    b = torch.sqrt(torch.clamp(t2, min=0.0)).to(prec.acc)
    p1 = tail_p(b, n_eff, kmax, n_grid).float()
    ostat1 = torch.sqrt(torch.clamp(t2, min=0.0))
    ostat = 0.99999 * t2
    til, tjl = ti.long(), tj.long()
    larc = torch.minimum(tjl - til, n - tjl + til)
    considered = analyzable & (ostat1 > 0.1)
    trivial = considered & (ostat1 >= 7.0) & (larc >= 10)
    hybrid = n > n_min
    tail_ok = torch.where(hybrid, p1 <= alpha, True)
    needs = considered & ~trivial & tail_ok
    nrejc = torch.where(
        hybrid, ((alpha - p1) * n_perm).to(torch.int32),
        (alpha * float(n_perm)).to(torch.int32)).to(torch.int64)
    walked = walk(x, n_eff, tss, key0, cidx, lo, needs, hybrid, ostat, nrejc,
                  sbdry, n_perm, al0, kmax, n_min, prec)
    # the edge tests of the accepted splits
    accepted = trivial | walked
    at_end, at_start = tjl >= n, til <= 0
    test_both = accepted & ~at_end & ~at_start
    lanes = _edge_lanes(x, n, til, tjl, test_both, alpha, n_perm, w, prec)
    count = edge_counts(lanes, key0, cidx, lo, n, n_perm, prec)
    p = count.to(torch.float32) / torch.full((), float(n_perm),
                                             dtype=torch.float32, device=dev)
    keep = torch.where(lanes["degen"], False,
                       torch.where(lanes["quick0"], True, p <= alpha))
    keep1 = torch.where(test_both, keep[:B], at_end & ~at_start)
    keep2 = torch.where(test_both, keep[B:], at_start & ~at_end)
    split1 = accepted & keep1
    split2 = accepted & keep2 & (tjl < n)
    first_cut = torch.where(split1, til, tjl)
    second_cut = torch.where(split1 & split2, tjl, n)
    children = split1.to(torch.int64) + split2.to(torch.int64)
    return first_cut.tolist(), second_cut.tolist(), children.tolist()


def segment(coverage: dict, device, prec: Precision = ENGINE,
            alpha: float = ALPHA, n_perm: int = N_PERM, seed: int = SEED,
            al0: int = MIN_WIDTH, kmax: int = KMAX, n_min: int = N_MIN,
            n_grid: int = N_GRID) -> dict | None:
    """contig -> segment lengths (int64), as the whole-recursion engine
    returns them for coverage (contig -> bins); None where its table
    would overflow.  prec=CONTROL runs the control."""
    device = torch.device(device)
    names = list(coverage)
    rows = [np.asarray(coverage[k], np.float64) for k in names]
    nonempty = [c for c, r in enumerate(rows) if len(r)]
    if not nonempty:
        return {}
    max_len = max(len(rows[c]) for c in nonempty)
    C = len(nonempty)
    if max_len > MAX_BINS or C > MAX_CONTIGS:
        return None
    Tmax = _pow2(max_len, MIN_TIER)
    S = _pow2(max(MIN_SLOTS, 4 * C), 8)
    mat = np.zeros((C, Tmax), np.float32)
    for i, c in enumerate(nonempty):
        mat[i, : len(rows[c])] = rows[c]
    contigs = torch.as_tensor(mat, device=device)
    key0 = torch.as_tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                           dtype=torch.int64, device=device)
    alpha_t = torch.full((), alpha, dtype=torch.float32, device=device)
    sbdry = torch.as_tensor(boundary(n_perm, alpha).astype(np.int64),
                            device=device)
    pending = [(i, 0, len(rows[c])) for i, c in enumerate(nonempty)]
    leaves: list[tuple[int, int, int]] = []
    nseg = C
    while pending:
        nxt = []
        groups: dict[int, list] = {}
        for seg in pending:
            groups.setdefault(tier_width(seg[2]), []).append(seg)
        for w, segs in sorted(groups.items()):
            t = torch.as_tensor(segs, dtype=torch.int64, device=device)
            cuts = _split_group(contigs, t[:, 0], t[:, 1], t[:, 2], w, key0,
                                alpha_t, sbdry, prec, n_perm, al0, kmax,
                                n_min, n_grid)
            for (c, lo, n), a, b, k in zip(segs, *cuts):
                if k == 0:
                    leaves.append((c, lo, lo + n))
                    continue
                nxt.append((c, lo, a))
                nxt.append((c, lo + a, b - a))
                if k == 2:
                    nxt.append((c, lo + b, n - b))
                nseg += k
        if nseg > S:
            return None
        pending = nxt
    out: dict = {}
    for i, c in enumerate(nonempty):
        his = sorted(hi for cc, _lo, hi in leaves if cc == i)
        out[names[c]] = np.diff(np.asarray([0] + his, np.int64))
    for name in names:
        out.setdefault(name, np.asarray([0], np.int64))
    return out
