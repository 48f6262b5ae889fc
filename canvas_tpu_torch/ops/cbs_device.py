"""The frontier CBS engine: the recursive DNAcopy segmentation with every
hot statistic evaluated on the run's torch device.

Reference semantics: ``CanvasPartition/{ChangePoint,CBSTStatistic,
GetBoundary,TailProbability}.cs`` — the same algorithm the host path in
``ops/cbs.py`` implements (that file stays the exact parity oracle).

Design:
  * Contig coverage uploads ONCE per group as a padded [C, Tmax] f32
    matrix; every recursion level ships only (contig, start, length)
    index triples, never the data.
  * The recursion runs as a BREADTH-FIRST FRONTIER: the pending segments
    of a level evaluate together (window gather + centring + max-t arc
    scan + Ornstein-Uhlenbeck tail probability + speculative permutation
    chunk), bucketed by power-of-two padded length.  Each bucket's result
    stays on the device until its [Bp, 6 + P] level output is copied back
    once.
  * The arc scan is kernel B4 (ops/arc_scan_cuda.py): a branch-and-bound
    over 512-lag blocks pruned by a per-block bound on d^2, for every
    bucket size.
  * Permutation null statistics draw their permutations on the device from
    threefry keys derived per (contig, segment, chunk) on the host
    (ops/threefry.py, equal bit for bit to the JAX package's draws); only
    the [B, P] stat matrix returns to the host, where the reference's
    sequential-stopping boundary walk replays exactly.
  * Sums and cumulative sums accumulate in float64 and round once to f32,
    and the tail probability runs in float64, so a CUDA run and a CPU run
    of this engine see the same statistics.

Documented deviations from the host/reference path (all Monte-Carlo-level;
the host path stays the engine on the CPU device and is the parity gate):
  * permutations come from threefry, not the numpy Generator stream;
  * statistics evaluate in f32 (comparisons carry the reference's own 1e-5
    slack factor 0.99999);
  * exact float ties in the arc scan resolve to the first (lag block,
    position) instead of the host's lag scan order (cf. the tie note on
    ops/cbs.py:tmax_o);
  * the OU tail-probability ``nu`` series evaluates 8192 exact terms plus a
    closed-form Euler–Maclaurin integral tail instead of the reference's
    doubling-block truncation (TailProbability.cs ``Nu``); the device value
    is the more accurate one (~1e-8 vs ~1e-6 relative error).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from canvas_tpu_torch.ops import arc_scan_cuda, threefry
from canvas_tpu_torch.ops import cbs as _cbs

P_CHUNK = 512          # permutations per continuation chunk (= cbs.PERM_CHUNK)
_NU_SERIES_TERMS = 8192
_NU_TAIL_PANELS = 128
_NU_BATCH = 4096       # x values per [batch, 2048] series block
_BCHUNK = 256          # position-chunk width for the per-block d^2 bound
_PERM_ELEMS = 1 << 25  # permuted values per batch of segments (memory bound)


# ---------------------------------------------------------------------------
# One frontier level: gather + centre + arc max-t + OU tail + perm chunk 0
# ---------------------------------------------------------------------------

def _gather_center(contigs, cidx, lo, n, npad):
    """[Bp, npad] f32 centred windows (zero beyond each segment's length)
    and their f32 total sums of squares [Bp]."""
    dev = contigs.device
    ext = torch.nn.functional.pad(contigs, (0, npad))
    j = torch.arange(npad, device=dev)
    x = ext[cidx[:, None], lo[:, None] + j[None, :]]
    valid = j[None, :] < n[:, None]
    x = torch.where(valid, x, 0.0)
    mean = (x.double().sum(dim=1) / torch.clamp(n, min=1)).float()
    x = torch.where(valid, x - mean[:, None], 0.0)
    tss = x.double().square().sum(dim=1).float()
    return x, tss


def _cumsum(x):
    """f32 cumulative sum along the last axis, accumulated in float64."""
    return torch.cumsum(x.double(), dim=-1).float()


def _block_d2_bound(cs, psdiff, npad, sblk):
    """[B, nblk] upper bound on d^2 = (cs[j] - cs[i])^2 over pairs with
    lag j - i inside each sblk-lag block.

    Chunk the position axis at _BCHUNK; with M/m the per-chunk max/min of
    the cumsum, any pair at chunk distance db satisfies
    |d| <= max(M[a+db] - m[a], M[a] - m[a+db]).  A lag block only reaches
    chunk distances around lag/_BCHUNK, so its bound is the max over that
    small db range — far tighter than the global cumsum range for noise
    (local range ~ sqrt(lag) vs sqrt(n)), which is what lets the arc scan
    skip the mid-lag blocks the psdiff bound always over-admits.
    Pad positions enter the chunk extrema unmasked: extra values only
    widen M - m, so the bound stays valid."""
    B = cs.shape[0]
    dev = cs.device
    nblk = max(npad // sblk, 1)
    C = min(_BCHUNK, npad)
    nchunk = npad // C
    csr = cs.reshape(B, nchunk, C)
    M = csr.amax(dim=2)
    m = csr.amin(dim=2)
    # the max of M[c] - m[a] over chunk pairs at each distance |c - a|
    a = torch.arange(nchunk, device=dev)
    dist = (a[None, :] - a[:, None]).abs().reshape(1, -1).expand(B, -1)
    pair = (M[:, None, :] - m[:, :, None]).reshape(B, -1)
    by_db = torch.full((B, nchunk), -torch.inf, dtype=cs.dtype, device=dev)
    by_db = by_db.scatter_reduce(1, dist, pair, reduce="amax")
    # each block takes the max over its reachable chunk distances
    reach = np.zeros((nblk, nchunk), dtype=bool)
    for k in range(nblk):
        lo_lag, hi_lag = k * sblk, k * sblk + sblk - 1
        db_lo = max(0, lo_lag // C - 1)
        db_hi = min(nchunk - 1, hi_lag // C + 1)
        reach[k, db_lo:db_hi + 1] = True
    reach_t = torch.as_tensor(reach, device=dev)
    bnd = torch.where(reach_t[None], by_db[:, None, :], -torch.inf).amax(dim=2)
    d = torch.minimum(psdiff[:, None], bnd)
    return (d * d).to(torch.float32)


def arc_scan_inputs(cs, n, npad, al0):
    """What B4 takes besides cs, per row of the cumsum cs f32 [B, npad]:
    (seed, lag_hi, psd2), plus the 1-based split (ti0, tj0) of the
    extrema pair that the seed scores."""
    blk = arc_scan_cuda.geometry(npad)[0]
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


def tmax_batch(cs, n, tss, npad, al0):
    """Batched TMaxO: (t^2 f32, ti, tj int32) per row of the cumsum
    cs f32 [B, npad].  Vectorised extrema seeds, the B4 arc scan for the
    max, then one refine pass over the winning 32-lag sub-block.  Only
    exact float ties can pick another (ti, tj) than the host's
    cbs.tmax_o."""
    B = cs.shape[0]
    dev = cs.device
    sub = arc_scan_cuda.geometry(npad)[1]
    pos = torch.arange(npad, device=dev)
    nf = n.to(torch.float32)
    seed, lag_hi, psd2, ti0, tj0 = arc_scan_inputs(cs, n, npad, al0)
    best, bl0 = arc_scan_cuda.arc_scan(cs, n.to(torch.int32), lag_hi, seed,
                                       psd2, al0)
    ti, tj = ti0, tj0
    hit = bl0 >= 0
    # no row beat its extrema seed: the seed locations are already exact
    if bool(hit.any()):
        # Recover (ti, tj) inside each winner's sub-block: the running max
        # over its lags keeps the SMALLEST lag per position, and the
        # per-row argmax takes the first max position.
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


def _ndtr(z):
    return 0.5 * torch.special.erfc(-z / np.sqrt(2.0))


def _nu_dev(x):
    """TailProbability.Nu over a flat vector: 8192 exact series terms in
    4 chunks + Euler–Maclaurin integral tail (see module note), in the
    dtype of x."""
    K = 2048
    n_chunks = _NU_SERIES_TERMS // K
    dev, dt = x.device, x.dtype
    series = torch.zeros_like(x)
    for s0 in range(0, x.shape[0], _NU_BATCH):
        xs = x[s0:s0 + _NU_BATCH]
        acc = torch.zeros_like(xs)
        for c in range(n_chunks):
            dk = (c * K + torch.arange(1, K + 1, device=dev)).to(dt)
            t = _ndtr(-xs[:, None] * torch.sqrt(dk)[None, :] / 2.0) \
                * (2.0 / dk)
            acc = acc + t.sum(dim=1)
        series[s0:s0 + _NU_BATCH] = acc
    # tail: sum_{t>D} 2*ndtr(-x*sqrt(t)/2)/t ~= int_{D+1/2}^inf (midpoint EM)
    #     = 4 * int_{x*sqrt(D+0.5)/2}^inf ndtr(-u)/u du   (u = x*sqrt(t)/2)
    v0 = x * np.sqrt(_NU_SERIES_TERMS + 0.5) / 2.0
    hi = 9.0
    v0c = torch.clamp(v0, max=hi)
    h = (hi - v0c) / _NU_TAIL_PANELS
    u = v0c[:, None] + h[:, None] * torch.arange(
        _NU_TAIL_PANELS + 1, device=dev).to(dt)[None, :]
    f = _ndtr(-u) / torch.clamp(u, min=1e-12)
    simp = np.ones(_NU_TAIL_PANELS + 1)
    simp[1:-1:2] = 4.0
    simp[2:-1:2] = 2.0
    tail = 4.0 * (h / 3.0) * (f * torch.as_tensor(simp, dtype=dt,
                                                  device=dev)[None, :]).sum(1)
    lnu = np.log(2.0) - 2.0 * torch.log(torch.clamp(x, min=1e-12)) \
        - series - tail
    return torch.where(x <= 0.01, torch.exp(-0.583 * x), torch.exp(lnu))


def _integral_inv_t1t_sq_dev(tl, a):
    def f(y):
        return (8.0 * y / (1.0 - 4.0 * y * y)
                + 2.0 * torch.log((1 + 2 * y) / (1 - 2 * y)))
    return f(tl + a - 0.5) - f(tl - 0.5)


def _tail_p_batch_dev(b, n, kmax, n_grid):
    """TailProbability.TailP for a [Bp] batch (hybrid delta = (kmax+1)/n),
    in the dtype of b."""
    nf = n.to(b.dtype)
    delta = torch.clamp((kmax + 1.0) / nf, 0.0, 0.45)
    dincr = (0.5 - delta) / n_grid                          # [Bp]
    i = torch.arange(n_grid, device=b.device).to(b.dtype)[None, :]
    tls = 0.5 + i * dincr[:, None]
    ts = 0.5 + (i + 0.5) * dincr[:, None]
    bsqrtm = b / torch.sqrt(nf)
    xg = bsqrtm[:, None] / torch.sqrt(ts * (1 - ts))        # [Bp, n_grid]
    nus = _nu_dev(xg.reshape(-1)).reshape(xg.shape)
    integ = _integral_inv_t1t_sq_dev(tls, dincr[:, None])
    out = (nus * nus * integ).sum(dim=1)
    return 2.0 * 9.973557e-2 * b ** 3 * torch.exp(-b * b / 2) * out


def _level(contigs, cidx, lo, n, keys, alpha, npad, P, al0, kmax, n_min,
           n_grid, full):
    """One frontier bucket, ONE float64 output [Bp, 6 + P] on the device:
    ``[t2, ti, tj, p1, tss, perm_flag, pstats...]`` per segment.

    Besides the statistic and its tail probability this evaluates
    permutation chunk 0 for exactly the segments whose decision needs it
    (ostat in the undecided band and, for hybrid segments, tail p <=
    alpha), selected by a boolean mask per branch, so the usual extra perm
    round-trip disappears.  ``full`` includes the small-segment all-arc
    statistic (only possible when the bucket can hold n <= n_min).  The
    flags use the same float64 arithmetic as the host's decode, so a flag
    is set exactly when the host walks that segment."""
    x, tss = _gather_center(contigs, cidx, lo, n, npad)
    cs = _cumsum(x)
    t2, ti, tj = tmax_batch(cs, n, tss, npad, al0)
    ostat1 = torch.sqrt(torch.clamp(t2.double(), min=0.0))
    p1 = _tail_p_batch_dev(ostat1, n, kmax, n_grid)
    l = torch.minimum(tj - ti, n - tj + ti)
    trivial = (ostat1 >= 7.0) & (l >= 10)
    hybrid = n > n_min
    tail_ok = torch.where(hybrid, p1 <= alpha, True)
    needs = (ostat1 > 0.1) & ~trivial & tail_ok
    pstats = torch.zeros((x.shape[0], P), dtype=torch.float64,
                         device=x.device)
    for is_full in ((False, True) if full else (False,)):
        rows = torch.nonzero(needs & (~hybrid if is_full else hybrid))[:, 0]
        if len(rows):
            pstats[rows] = _perm_stats(x[rows], n[rows], tss[rows],
                                       keys[rows], npad, P, al0, kmax,
                                       is_full).double()
    head = torch.stack([t2.double(), ti.double(), tj.double(), p1,
                        tss.double(), needs.double()], dim=1)
    return torch.cat([head, pstats], dim=1)


# ---------------------------------------------------------------------------
# Permutation null statistics (on-device permutation generation)
# ---------------------------------------------------------------------------

def _device_perms(keys, xr, nn, npad, P):
    """[S, P, npad] random permutations of each row of xr [S, npad] (the
    first nn[s] values real, the rest zero) from its threefry key.

    Padded positions draw key 2.0 > any uniform, so a stable sort sends
    them to the tail; the first nn slots hold a uniform permutation of the
    nn real values.  (f32 sort keys can collide at n ~ 2^12+; a collision
    resolves by index — an immeasurably small non-uniformity.)"""
    S = xr.shape[0]
    u = threefry.uniform(keys, (P, npad))
    live = torch.arange(npad, device=xr.device)[None, None, :] \
        < nn[:, None, None]
    u = torch.where(live, u, 2.0)
    order = torch.sort(u, dim=2, stable=True).indices
    return torch.gather(xr[:, None, :].expand(S, P, npad), 2, order)


def _htmax_core(cs, nn, tss, npad, al0, kmax):
    """Hybrid short-arc max-t (CBSTStatistic.HTMaxP): linear + wrap arcs of
    length al0..kmax over a [R, npad] cumsum batch, real length nn [R]."""
    R = cs.shape[0]
    dev = cs.device
    nf = nn.to(cs.dtype)
    idx = torch.arange(npad, device=dev)
    best = torch.zeros(R, dtype=cs.dtype, device=dev)
    # lags L >= npad are impossible for any real length nn <= npad
    for L in range(al0, min(kmax, npad - 1) + 1):
        d_lin = (cs[:, L:] - cs[:, :-L]).abs()
        lin_ok = idx[None, :npad - L] + L <= nn[:, None] - 1
        d1 = torch.where(lin_ok, d_lin, 0.0).amax(dim=1)
        # wrap arcs pair cs[nn-L+j] with cs[j]: a contiguous window whose
        # start is clamped into the row (valid whenever nn > L)
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
    """Full-arc max-t (CBSTStatistic.TMaxP): all lags al0..n-al0, no wrap,
    for small (non-hybrid) segments; max_lag bounds every row's lag_hi."""
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
        Lf = torch.tensor(float(L), dtype=cs.dtype, device=dev)
        w = nf / (Lf * (nf - Lf))
        live = L <= lag_hi
        best = torch.where(live, torch.maximum(best, w * dmax * dmax), best)
    tssv = torch.where(tss <= best + 1e-4, best + 1.0, tss)
    return best / ((tssv - best) / (nf - 2.0))


def _perm_stats(x, nn, tss, keys, npad, P, al0, kmax, full):
    """[S, P] f32 permutation max-t stats of the rows of x [S, npad], their
    permutations drawn on the device; segments go in batches of at most
    _PERM_ELEMS permuted values."""
    S = x.shape[0]
    out = torch.empty((S, P), dtype=torch.float32, device=x.device)
    per = max(1, _PERM_ELEMS // (P * npad))
    nn_host = nn.cpu().numpy() if full else None
    for s0 in range(0, S, per):
        s1 = min(S, s0 + per)
        px = _device_perms(keys[s0:s1], x[s0:s1], nn[s0:s1], npad, P)
        pcs = _cumsum(px).reshape(-1, npad)
        nn_r = nn[s0:s1].repeat_interleave(P)
        tss_r = tss[s0:s1].repeat_interleave(P)
        if full:
            max_lag = int(max(min(v - al0, v - 1) for v in nn_host[s0:s1]))
            st = _tmax_full_core(pcs, nn_r, tss_r, npad, al0, max_lag)
        else:
            st = _htmax_core(pcs, nn_r, tss_r, npad, al0, kmax)
        out[s0:s1] = st.reshape(s1 - s0, P)
    return out


# ---------------------------------------------------------------------------
# Host frontier loop
# ---------------------------------------------------------------------------

class _Seg(NamedTuple):
    contig: int          # GLOBAL contig index (RNG key derivation)
    lo: int
    hi: int
    row: int = 0         # row in the owning group's device matrix (gather)


def _pow2(v: int, floor: int = 8) -> int:
    return max(floor, 1 << (int(v) - 1).bit_length())


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — a host-side bijective mixer (public domain,
    Steele et al.)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1E4B7B97)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D9B149FB1AA02)
    return x ^ (x >> np.uint64(31))


def _seg_keys_np(seed: int, contig, lo, n, chunk) -> np.ndarray:
    """[B, 2] uint32 threefry KEYS for (contig, segment, chunk) derived on
    the host with SplitMix64.  A threefry key is just 64 key bits; any
    deterministic injective derivation gives an independent stream, so
    the mixer replaces a per-segment fold-in chain on the device."""
    contig = np.asarray(contig, np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFF) * np.uint64(3)
                        + np.uint64(0x5EED))
        h = _splitmix64(h ^ (contig << np.uint64(40))
                        ^ (np.asarray(lo, np.uint64) << np.uint64(20))
                        ^ np.asarray(n, np.uint64))
        h = _splitmix64(h + np.asarray(chunk, np.uint64))
    out = np.empty(h.shape + (2,), np.uint32)
    out[..., 0] = (h >> np.uint64(32)).astype(np.uint32)
    out[..., 1] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def _keys_tensor(keys: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(keys.astype(np.int64), device=device)


def _edge_rng(seed: int, contig: int, lo: int, n: int, side: int):
    ss = np.random.SeedSequence([seed & 0x7FFFFFFF, contig, lo, n, side])
    return np.random.default_rng(ss)


class _PermWalk:
    """Replays ChangePoint's sequential-stopping boundary walk on the host
    from device stat chunks (identical accept/reject decisions given the
    stat sequence)."""

    def __init__(self, ostat: float, nrejc: int, n_perm: int,
                 sbdry: np.ndarray):
        self.ostat = ostat
        self.nrejc = nrejc
        self.n_perm = n_perm
        self.sbdry = sbdry
        self.k = nrejc * (nrejc + 1) // 2 + 1
        self.nrej = 0
        self.np_i = 0
        self.accepted: bool | None = None   # None = still walking

    def feed(self, pstats: np.ndarray) -> None:
        for p in pstats:
            self.np_i += 1
            if self.ostat <= p:
                self.nrej += 1
                self.k += 1
            if self.nrej > self.nrejc:
                self.accepted = False
                return
            if self.np_i >= self.sbdry[self.k - 1]:
                self.accepted = True
                return
            if self.np_i >= self.n_perm:
                self.accepted = True
                return


def _locate(seg: _Seg, x: np.ndarray, i1: int, i2: int, n_perm: int,
            alpha: float, seed: int) -> list[int]:
    """Split-location edge tests (ChangePoint.cs:359-398) on host numpy."""
    n = len(x)
    if i2 == n:
        return [i1]
    if i1 == 0:
        return [i2]
    out = []
    rng = _edge_rng(seed, seg.contig, seg.lo, n, 0)
    if _cbs.t_perm_p(i1, i2 - i1, x, n_perm, rng, alpha=alpha) <= alpha:
        out.append(i1)
    rng = _edge_rng(seed, seg.contig, seg.lo, n, 1)
    if _cbs.t_perm_p(i2 - i1, n - i2, x[i1:], n_perm, rng,
                     alpha=alpha) <= alpha:
        out.append(i2)
    return out


def run_cbs_device(
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
    device: str | torch.device = "cpu",
    levels: list | None = None,
) -> dict[str, np.ndarray]:
    """CBSRunner.Run with the frontier engine on `device` (see module
    docstring).  Same contract as ops.cbs.run_cbs: contig -> segment
    lengths.  With `levels` given, one record per frontier level is
    appended to it: buckets, segments, seconds (after a device sync) and
    B4 launches."""
    device = torch.device(device)
    names = list(coverage_by_contig)
    rows = [np.asarray(coverage_by_contig[k], np.float64) for k in names]
    if sum(len(r) for r in rows) == 0:
        return {}
    sbdry = _cbs.compute_boundary(n_perm, alpha, _cbs.DEFAULT_ETA)
    finite = {k: np.asarray(v, np.float64)[np.isfinite(v)]
              for k, v in coverage_by_contig.items()}
    tsd = float(np.sqrt(_cbs.trimmed_variance(finite))) \
        if any(len(v) for v in finite.values()) else 0.0

    # Contigs split round-robin (by descending length, for balance) into
    # independent GROUPS, each with its own device matrix and frontier; a
    # group's continuation permutation batches pad to its own longest
    # pending segment, so the grouping is part of the draws.  Per-segment
    # results are otherwise independent and RNG keys derive from GLOBAL
    # contig ids.
    nonempty = [c for c, r in enumerate(rows) if len(r)]
    order = sorted(nonempty, key=lambda c: -len(rows[c]))
    G = max(1, min(4, len(nonempty)))
    cps: dict[int, list[int]] = {c: [] for c in range(len(rows))}

    class _Group:
        __slots__ = ("dev", "frontier", "local")

    groups: list[_Group] = []
    for gi in range(G):
        members = order[gi::G]
        if not members:
            continue
        g = _Group()
        g.local = {c: i for i, c in enumerate(members)}
        tmax_len = max(len(rows[c]) for c in members)
        g.dev = torch.as_tensor(np.stack(
            [np.pad(rows[c], (0, tmax_len - len(rows[c])))
             for c in members]).astype(np.float32), device=device)
        g.frontier = [_Seg(c, 0, len(rows[c]), g.local[c]) for c in members]
        groups.append(g)

    def _dispatch(g: _Group):
        """The level's buckets for a group, ONE evaluation per pow2 padding
        bucket (over-padding a 2k child to a 16k level ceiling makes its
        speculative permutation sort ~8x more expensive).  None when the
        frontier has nothing analyzable (group finished)."""
        buckets: dict[int, list[_Seg]] = {}
        for seg in g.frontier:
            cur = rows[seg.contig][seg.lo: seg.hi]
            if len(cur) >= 2 * min_width and cur.max() != cur.min():
                buckets.setdefault(_pow2(seg.hi - seg.lo), []).append(seg)
        if not buckets:
            return None
        parts = []
        for npad, segs in sorted(buckets.items()):
            Bp = _pow2(len(segs), floor=1)
            cidx = np.zeros(Bp, np.int64)
            gci = np.zeros(Bp, np.int64)
            lo = np.zeros(Bp, np.int64)
            nn = np.full(Bp, 2 * min_width, np.int64)
            for i, s in enumerate(segs):
                cidx[i], gci[i], lo[i], nn[i] = s.row, s.contig, s.lo, \
                    s.hi - s.lo
            keys = _seg_keys_np(seed, gci, lo, nn, 0)
            full = (p_method != "hybrid"
                    or any((s.hi - s.lo) <= n_min for s in segs))
            # bigger speculative chunk on small-padded levels: most walks
            # then terminate without a continuation chunk
            p0 = 768 if npad <= 8192 else P_CHUNK
            out = _level(
                g.dev, torch.as_tensor(cidx, device=device),
                torch.as_tensor(lo, device=device),
                torch.as_tensor(nn, device=device),
                _keys_tensor(keys, device), alpha, npad, p0, min_width,
                kmax, n_min if p_method == "hybrid" else (1 << 30),
                100, full)
            parts.append((segs, out.cpu().numpy()))
        return parts

    def _process(g: _Group, parts):
        """Decode the fetched level parts; returns the group's next
        frontier (perm walks run inline, with their own chunks)."""
        next_frontier: list[_Seg] = []
        pending: list[tuple[_Seg, int, int, float, int, bool]] = []
        fused: dict[int, np.ndarray] = {}
        for segs, out in parts:
            _decode(segs, out, next_frontier, pending, fused)
        _walk_pending(pending, rows, sbdry, n_perm, alpha, seed,
                      min_width, kmax, cps, next_frontier, fused, device)
        return next_frontier

    def _decode(segs, out, next_frontier, pending, fused):
        for i, seg in enumerate(segs):
            n = seg.hi - seg.lo
            t2, i1, i2 = float(out[i, 0]), int(out[i, 1]), int(out[i, 2])
            ostat1 = float(np.sqrt(max(t2, 0.0)))
            if ostat1 <= 0.1:
                continue
            ostat = 0.99999 * t2
            l = min(i2 - i1, n - i2 + i1)
            if ostat1 >= 7.0 and l >= 10:
                _accept(seg, rows, i1, i2, n_perm, alpha, seed, cps,
                        next_frontier, min_width)
                continue
            hybrid = p_method == "hybrid" and n_min < n
            if hybrid:
                p1 = float(out[i, 3])
                if p1 > alpha:
                    continue
                nrejc = int((alpha - p1) * n_perm)
            else:
                nrejc = int(alpha * n_perm)
            if out[i, 5] > 0.5:            # the level pre-ran perm chunk 0
                fused[id(seg)] = out[i, 6:]
            pending.append((seg, i1, i2, ostat, nrejc, hybrid))

    level = 0
    while any(g.frontier for g in groups):
        t0 = time.perf_counter()
        launches0 = arc_scan_cuda.LAUNCHES["arc_scan"]
        n_buckets = n_segs = 0
        for g in groups:
            if not g.frontier:
                continue
            parts = _dispatch(g)
            if parts is None:
                g.frontier = []
                continue
            n_buckets += len(parts)
            n_segs += sum(len(segs) for segs, _ in parts)
            g.frontier = _process(g, parts)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if levels is not None and n_buckets:
            levels.append({
                "level": level, "buckets": n_buckets, "segments": n_segs,
                "seconds": time.perf_counter() - t0,
                "arc_scan_launches":
                    arc_scan_cuda.LAUNCHES["arc_scan"] - launches0})
        level += 1

    out = {}
    for c, name in enumerate(names):
        n = len(rows[c])
        ends = np.asarray(sorted(set(cps[c])) + [n]) if n else np.asarray([0])
        lengths = np.diff(np.concatenate([[0], ends])).astype(np.int64)
        lengths = lengths[lengths > 0] if n else lengths
        if len(lengths) > 1 and undo_method == "prune":
            lengths = _cbs._prune(rows[c], lengths, undo_prune)
        elif len(lengths) > 1 and undo_method == "sdundo":
            lengths = _cbs._sd_undo(rows[c], lengths, tsd, undo_sd)
        out[name] = np.asarray(lengths, np.int64)
    return out


def _accept(seg, rows, i1, i2, n_perm, alpha, seed, cps, next_frontier,
            min_width):
    cur = rows[seg.contig][seg.lo: seg.hi]
    x = cur - cur.mean()
    found = _locate(seg, x, i1, i2, n_perm, alpha, seed)
    if not found:
        return
    bounds = [0] + found + [len(cur)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b > a:
            next_frontier.append(
                _Seg(seg.contig, seg.lo + a, seg.lo + b, seg.row))
    for c in found:
        cps[seg.contig].append(seg.lo + c)


def _walk_pending(pending, rows, sbdry, n_perm, alpha,
                  seed, min_width, kmax, cps, next_frontier,
                  fused=None, device="cpu"):
    """Permutation tests for segments that need them: the level's fused
    chunk-0 stats feed each walk first; walks that don't terminate within
    a chunk get continuation chunks from _perm_stats (same key sequence,
    chunk index folded in) until every walk terminates."""
    fused = fused or {}
    walks = []
    for seg, i1, i2, ostat, nrejc, hybrid in pending:
        walk = _PermWalk(ostat, nrejc, n_perm, sbdry)
        chunk0 = fused.get(id(seg))
        if chunk0 is not None:
            walk.feed(chunk0[: min(len(chunk0), n_perm)])
            if walk.accepted is None and walk.np_i >= n_perm:
                walk.accepted = True
            next_chunk = 1
        else:
            next_chunk = 0
        walks.append([walk, seg, i1, i2, hybrid, next_chunk])
    while True:
        live = [w for w in walks if w[0].accepted is None]
        if not live:
            break
        for full in (False, True):
            group = [w for w in live if (not w[4]) == full]
            if not group:
                continue
            npad = max(_pow2(w[1].hi - w[1].lo) for w in group)
            Bp = _pow2(len(group), floor=1)
            xs = np.zeros((Bp, npad), np.float32)
            nn = np.full(Bp, 2 * min_width, np.int64)
            tss = np.ones(Bp, np.float32)
            cidx = np.zeros(Bp, np.int64)
            los = np.zeros(Bp, np.int64)
            chunks = np.zeros(Bp, np.int64)
            for i, rec in enumerate(group):
                walk, seg = rec[0], rec[1]
                cur = rows[seg.contig][seg.lo: seg.hi]
                x = (cur - cur.mean()).astype(np.float32)
                xs[i, : len(x)] = x
                nn[i] = len(x)
                tss[i] = float(np.sum(x.astype(np.float64) ** 2))
                cidx[i], los[i], chunks[i] = seg.contig, seg.lo, rec[5]
            keys = _seg_keys_np(seed, cidx, los, nn, chunks)
            stats = _perm_stats(
                torch.as_tensor(xs, device=device),
                torch.as_tensor(nn, device=device),
                torch.as_tensor(tss, device=device),
                _keys_tensor(keys, device), npad, P_CHUNK, min_width, kmax,
                full).cpu().numpy().astype(np.float64)
            for i, rec in enumerate(group):
                walk = rec[0]
                take = min(P_CHUNK, n_perm - walk.np_i)
                walk.feed(stats[i, :take])
                rec[5] += 1
                if walk.accepted is None and walk.np_i >= n_perm:
                    walk.accepted = True
    for walk, seg, i1, i2, _hybrid, _c in walks:
        if walk.accepted:
            _accept(seg, rows, i1, i2, n_perm, alpha, seed, cps,
                    next_frontier, min_width)


def _debug_perm_stats(x: np.ndarray, n: int, tss: float, key, npad: int,
                      P: int, al0: int, kmax: int, full: bool):
    """Test hook: returns (permuted value rows [P, npad], stats [P]) so the
    host numpy oracle can score the SAME permutations."""
    xr = torch.as_tensor(np.pad(np.asarray(x, np.float32),
                                (0, npad - len(x))))[None]
    nn = torch.as_tensor([n])
    keys = torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64))[None]
    px = _device_perms(keys, xr, nn, npad, P)
    pcs = _cumsum(px)[0]
    nn_r = nn.repeat(P)
    ts = torch.full((P,), tss, dtype=torch.float32)
    if full:
        st = _tmax_full_core(pcs, nn_r, ts, npad, al0,
                             min(n - al0, n - 1))
    else:
        st = _htmax_core(pcs, nn_r, ts, npad, al0, kmax)
    return px[0].numpy(), st.numpy()
