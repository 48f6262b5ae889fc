"""Circular binary segmentation (CanvasPartition CBS mode; DNAcopy port).

Reference structure (ChangePoint.cs, CBSTStatistic.cs, GetBoundary.cs,
TailProbability.cs):
  * recursive ternary splitting of each chromosome, driven from the host
    (ChangePoint.ChangePoints, :44-153);
  * the split statistic is the max over circular arcs of
    bss(L, d) = n/(L(n-L)) * d^2 (d = partial-sum difference), converted to
    a t^2 via bss / ((TSS - bss)/(n-2)) (TMaxO, CBSTStatistic.cs:19-340);
  * p-values by permutation with sequential early stopping boundaries
    (GetBoundary hypergeometric construction) and, in hybrid mode, an
    Ornstein-Uhlenbeck tail bound (TailProbability.TailP) plus a
    small-arc-only permutation max (HTMaxP, arcs of length al0..kMax
    including wrap-around);
  * edge changepoints validated by a two-sample mean permutation test
    (TPermP, :~650-720);
  * optional SD-undo / prune split-undo passes (:155-271).

This file is the float64 host path and the parity oracle: the reference
evaluates permutations one at a time with early stopping; here each chunk
of permutation statistics evaluates as one vectorized numpy pass ([P, n]
cumsum + per-arc-length shifted-diff maxima), and the sequential stopping
rule is replayed exactly from the stat vector — identical accept/reject
decisions.  On a CUDA device run_cbs takes the frontier engine
(ops/cbs_device.py) instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import stats as sps

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.ops import stats

DEFAULT_ALPHA = 0.01      # CBSRunner.cs:11
DEFAULT_NPERM = 10000
DEFAULT_KMAX = 25
DEFAULT_NMIN = 200
DEFAULT_ETA = 0.05
DEFAULT_TRIM = 0.025
DEFAULT_MIN_WIDTH = 2

# Which engine produced the most recent run_cbs result: "mega" (the
# whole-recursion device engine), "frontier" (the per-level device engine)
# or "host" (numpy parity oracle); for the host engine, how many processes
# ran its contigs (1 when serial), and for a device engine, how many
# levels it ran.  Recorded so workflow profiles
# attribute their times to the engine that actually ran.
_LAST_ENGINE: dict[str, str | int | None] = {
    "engine": None, "host_workers": None, "levels": None}


def last_engine() -> str | None:
    """Engine name of the most recent run_cbs call in this process."""
    return _LAST_ENGINE["engine"]


# ---------------------------------------------------------------------------
# Genome-wide trimmed variance (ChangePoint.TrimmedVariance, :423-474)
# ---------------------------------------------------------------------------

def inflation_factor(trim: float) -> float:
    a = sps.norm.ppf(1 - trim)
    step = 2 * a / 10000
    x = np.linspace(-a + step / 2, a - step / 2, 10000)
    ex2 = np.sum(x * x * sps.norm.pdf(x)) * step / (1 - 2 * trim)
    return 1.0 / ex2


def trimmed_variance(coverage_by_contig: dict[str, np.ndarray],
                     trim: float = DEFAULT_TRIM) -> float:
    """Variance of trimmed |diffs| across the concatenated genome (including
    cross-chromosome boundary diffs, as the reference does)."""
    concat = np.concatenate([np.asarray(v, np.float64)
                             for v in coverage_by_contig.values() if len(v)])
    diffs = np.abs(np.diff(concat))
    n = len(concat)
    n_keep = int(np.round((1 - 2 * trim) * (n - 1)))
    d = np.sort(diffs)[:n_keep]
    return inflation_factor(trim) * np.sum(d * d) / (2 * n_keep)


# ---------------------------------------------------------------------------
# Sequential stopping boundary (GetBoundary.cs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _hyper_cdf_matrix(n_perm: int, n1s: int) -> np.ndarray:
    """cdf[k, i-1] = phyper(k; n1s, n_perm-n1s, i) for k < n1s, i = 1..n_perm.

    The reference probes this CDF one scalar at a time inside the eta
    bisection (GetBoundary.EtaBoundary); the matrix is eta-independent, so
    build it once per (n_perm, n1s) from a vectorized gammaln grid and let
    every bisection step reduce to a thresholding scan."""
    from scipy.special import gammaln

    def binomln(n, k):
        return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)

    dn = n_perm - n1s
    i = np.arange(1, n_perm + 1, dtype=np.float64)
    j = np.arange(0, n1s, dtype=np.float64)
    ij = i[None, :] - j[:, None]                       # draws from the dn pool
    valid = (ij >= 0) & (ij <= dn)
    logpmf = (binomln(float(n1s), j)[:, None]
              + binomln(float(dn), np.where(valid, ij, 0.0))
              - binomln(float(n_perm), i)[None, :])
    pmf = np.where(valid, np.exp(logpmf), 0.0)
    return np.minimum(np.cumsum(pmf, axis=0), 1.0)


def _eta_boundary(n_perm: int, eta0: float, n1s: int) -> np.ndarray:
    """First n1s boundary values: smallest i with phyper(k; n1s, n-n1s, i)
    <= eta0 for k = 0..n1s-1 (GetBoundary.EtaBoundary).  The reference scans
    i = 1..n_perm once, advancing k at each crossing — equivalent to the
    per-k first-crossing index made strictly increasing in k."""
    cdf = _hyper_cdf_matrix(n_perm, n1s)
    hit = cdf <= eta0                                  # decreasing cdf in i
    first = np.argmax(hit, axis=1) + 1                 # 1-based first i
    first[~hit.any(axis=1)] = 0
    out = np.zeros(n1s, dtype=np.uint32)
    prev = 0
    for k in range(n1s):
        if first[k] == 0:
            break
        v = max(int(first[k]), prev + 1)
        if v > n_perm:
            break
        out[k] = v
        prev = v
    return out


def _p_exceed(n_perm: int, n1s: int, bdry: np.ndarray) -> float:
    """Crossing probability of the boundary (GetBoundary.PExceed)."""
    from scipy.special import gammaln

    def binomln(n, k):
        if k < 0 or k > n:
            return -np.inf
        return (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1))

    n, k = n_perm, n1s
    dlcnk = binomln(n, k)
    n1 = n_perm - int(bdry[0])
    p = np.exp(binomln(n1, k) - dlcnk)
    if n1s >= 2:
        n1 = int(bdry[0])
        nn = n_perm - int(bdry[1])
        p += np.exp(np.log(n1) + binomln(nn, n1s - 1) - dlcnk)
    if n1s >= 3:
        n1, n2 = int(bdry[0]), int(bdry[1])
        nn = n_perm - int(bdry[2])
        kk = n1s - 2
        p += np.exp(np.log(n1) + np.log(n1 - 1.0) - np.log(2.0)
                    + binomln(nn, kk) - dlcnk)
        p += np.exp(np.log(n1) + np.log(n2 - n1) + binomln(nn, kk) - dlcnk)
    if n1s > 3:
        for i in range(4, n1s + 1):
            n1 = int(bdry[i - 4])
            n2 = int(bdry[i - 3])
            n3 = int(bdry[i - 2])
            nn = n_perm - int(bdry[i - 1])
            kk = n1s - i + 1
            p += np.exp(binomln(n1, i - 1) + binomln(nn, kk) - dlcnk)
            p += np.exp(binomln(n1, i - 2) + np.log(n3 - n1)
                        + binomln(nn, kk) - dlcnk)
            p += np.exp(binomln(n1, i - 3) + np.log(n2 - n1) + np.log(n3 - n2)
                        + binomln(nn, kk) - dlcnk)
            p += np.exp(binomln(n1, i - 3) + np.log(n2 - n1) - np.log(2.0)
                        + np.log(n2 - n1 - 1.0) + binomln(nn, kk) - dlcnk)
    return float(p)


@functools.lru_cache(maxsize=8)
def compute_boundary(n_perm: int = DEFAULT_NPERM, alpha: float = DEFAULT_ALPHA,
                     eta: float = DEFAULT_ETA, tol: float = 1e-2) -> np.ndarray:
    """Sequential boundary array, concatenated triangles for j = 1..maxOnes
    (GetBoundary.ComputeBoundary).  Cached: the boundary depends only on
    (n_perm, alpha, eta), which are run-level constants."""
    max_ones = int(np.floor(n_perm * alpha) + 1)
    sbdry = np.zeros(max_ones * (max_ones + 1) // 2, dtype=np.uint32)
    sbdry[0] = n_perm - int(n_perm * eta)
    eta0 = eta
    offset = 1
    for j in range(2, max_ones + 1):
        eta_hi = eta0 * 1.1
        b = _eta_boundary(n_perm, eta_hi, j)
        p_hi = _p_exceed(n_perm, j, b)
        eta_lo = eta0 * 0.25
        b = _eta_boundary(n_perm, eta_lo, j)
        p_lo = _p_exceed(n_perm, j, b)
        while (eta_hi - eta_lo) / eta_lo > tol:
            eta0 = eta_lo + (eta_hi - eta_lo) * (eta - p_lo) / (p_hi - p_lo)
            b = _eta_boundary(n_perm, eta0, j)
            p = _p_exceed(n_perm, j, b)
            if p > eta:
                eta_hi, p_hi = eta0, p
            else:
                eta_lo, p_lo = eta0, p
        sbdry[offset:offset + j] = b
        offset += j
    return sbdry


# ---------------------------------------------------------------------------
# OU tail probability (TailProbability.cs)
# ---------------------------------------------------------------------------

def _nu(x: float, tol: float) -> float:
    """TailProbability.Nu.  The series needs O((1/x)^2) terms for small x
    (~10^5 at genome-scale m); each doubling block is evaluated as one
    vectorized ndtr call instead of the reference's scalar loop — same
    term order, same doubling/termination schedule."""
    from scipy.special import ndtr

    def block(start: int, count: int) -> float:
        dks = np.arange(start + 1, start + count + 1, dtype=np.float64)
        return float(np.sum(2.0 * ndtr(-x * np.sqrt(dks) / 2.0) / dks))

    if x > 0.01:
        lnu1 = np.log(2.0) - 2 * np.log(x)
        lnu0 = lnu1
        k = 2
        dk_done = 0
        lnu1 -= block(dk_done, k)           # first k terms, unconditional
        dk_done += k
        while abs((lnu1 - lnu0) / lnu1) > tol:
            lnu0 = lnu1
            lnu1 -= block(dk_done, k)
            dk_done += k
            k *= 2
    else:
        lnu1 = -0.583 * x
    return float(np.exp(lnu1))


def _integral_inv_t1t_sq(x: float, a: float) -> float:
    y = x + a - 0.5
    out = 8.0 * y / (1.0 - 4.0 * y * y) + 2.0 * np.log((1 + 2 * y) / (1 - 2 * y))
    y = x - 0.5
    out -= 8.0 * y / (1.0 - 4.0 * y * y) + 2.0 * np.log((1 + 2 * y) / (1 - 2 * y))
    return float(out)


_NU_SQRT_NEG_HALF = np.empty(0)   # -sqrt(dk)/2 for dk = 1.. (grown on demand)
_NU_TWO_OVER_DK = np.empty(0)     # 2/dk


def _nu_schedule(upto: int) -> None:
    """Grow the cached term-schedule arrays (deterministic across calls:
    dk is always 1, 2, 3, ... so sqrt/reciprocal are computed once per
    process, not once per block)."""
    global _NU_SQRT_NEG_HALF, _NU_TWO_OVER_DK
    if len(_NU_SQRT_NEG_HALF) < upto:
        dks = np.arange(1, max(upto, 2 * len(_NU_SQRT_NEG_HALF)) + 1,
                        dtype=np.float64)
        _NU_SQRT_NEG_HALF = -np.sqrt(dks) / 2.0
        _NU_TWO_OVER_DK = 2.0 / dks


def _nu_batch(xs: np.ndarray, tol: float) -> np.ndarray:
    """_nu over a vector of x values with a shared doubling schedule: each
    x consumes exactly the blocks the scalar version would (same term
    order, same per-x termination), but every block is ONE ndtr call over
    all still-active xs — removes the Python-loop overhead that dominates
    tail_p at genome-scale m."""
    from scipy.special import ndtr

    xs = np.asarray(xs, dtype=np.float64)
    out = np.empty_like(xs)
    small = xs <= 0.01
    out[small] = np.exp(-0.583 * xs[small])
    live_idx = np.flatnonzero(~small)
    if len(live_idx) == 0:
        return out
    x = xs[live_idx]
    lnu1 = np.log(2.0) - 2 * np.log(x)
    lnu0 = lnu1.copy()
    k = 2
    dk_done = 0

    def block(xv, start, count):
        _nu_schedule(start + count)
        return np.sum(ndtr(xv[:, None]
                           * _NU_SQRT_NEG_HALF[start: start + count][None])
                      * _NU_TWO_OVER_DK[start: start + count][None], axis=1)

    lnu1 -= block(x, dk_done, k)            # first k terms, unconditional
    dk_done += k
    active = np.ones(len(x), dtype=bool)
    while True:
        with np.errstate(divide="ignore", invalid="ignore"):
            active &= np.abs((lnu1 - lnu0) / lnu1) > tol
        if not active.any():
            break
        lnu0[active] = lnu1[active]
        lnu1[active] -= block(x[active], dk_done, k)
        dk_done += k
        k *= 2
    out[live_idx] = np.exp(lnu1)
    return out


def tail_p(b: float, delta: float, m: int, n_grid: int = 100,
           tol: float = 1e-6) -> float:
    dincr = (0.5 - delta) / n_grid
    bsqrtm = b / np.sqrt(m)
    # iterative accumulation (not i*dincr) to keep the scalar loop's exact
    # float rounding
    tls = np.empty(n_grid)
    ts = np.empty(n_grid)
    tl = 0.5 - dincr
    t = 0.5 - 0.5 * dincr
    for i in range(n_grid):
        tl += dincr
        t += dincr
        tls[i] = tl
        ts[i] = t
    x = bsqrtm / np.sqrt(ts * (1 - ts))
    nus = _nu_batch(x, tol)
    integ = np.array([_integral_inv_t1t_sq(float(v), dincr) for v in tls])
    out = 0.0
    for i in range(n_grid):   # sequential sum, same order as the reference
        out += nus[i] ** 2 * integ[i]
    out = 9.973557e-2 * b ** 3 * np.exp(-b * b / 2) * out
    return float(2.0 * out)


# ---------------------------------------------------------------------------
# Max-t statistics
# ---------------------------------------------------------------------------

def _bss_to_t2(bss: float, tss: float, n: int) -> float:
    if tss <= bss + 0.0001:
        tss = bss + 1.0
    return bss / ((tss - bss) / (n - 2.0))


def tmax_o(x: np.ndarray, tss: float, al0: int) -> tuple[float, int, int]:
    """Max t^2 over circular splits of centered data x, with split location.

    Returns (ostat, i, j): segment boundaries as 1-based partial-sum indices
    (the arc is x[i..j-1] in 0-based terms).  Semantics match
    CBSTStatistic.TMaxO: the global partial-sum extrema pair seeds the max
    regardless of arc length; refinement scans lengths in [al0, n-al0].
    """
    n = len(x)
    cs = np.cumsum(x, dtype=np.float64)            # cs[k] = sx[k+1] 1-based
    imin, imax = int(np.argmin(cs)) + 1, int(np.argmax(cs)) + 1
    psdiff = cs[imax - 1] - cs[imin - 1]
    if psdiff <= 0:
        return 0.0, min(imin, imax), max(imin, imax)
    rj = abs(imax - imin)
    best = n / (rj * (n - rj)) * psdiff ** 2
    ti, tj = min(imin, imax), max(imin, imax)
    # Branch-and-bound over arc lengths: |cs[i+L] - cs[i]| <= psdiff (the
    # global cumsum range) for EVERY lag, so bss(L) <= w(L) * psdiff^2 with
    # w(L) = n/(L(n-L)).  Scanning lags in decreasing-w order (outside-in
    # by min(L, n-L)) lets us stop as soon as the bound cannot beat the
    # running best — same result as the reference's full O(n^2) scan
    # (CBSTStatistic.TMaxO), usually at a tiny fraction of the work.
    nal0 = min(n - al0, n - 1)
    lo, hi = al0, nal0
    # Lags are consumed in CHUNKS of consecutive L from whichever side
    # currently has the higher weight.  Three exact bounds prune chunks:
    #   (a) |cs[i+L] - cs[i]| <= psdiff (global cumsum range), the scalar
    #       loop's bound, monotone along the scan order -> full stop;
    #   (b) direct: the arc sum is a window sum of x, so
    #       |cs[i+L] - cs[i]| <= max windowed |x|-sum at lag L, which is
    #       NONdecreasing in L -> one O(n) scan at the chunk's largest lag
    #       bounds every lag in the chunk (prunes SHORT arcs);
    #   (c) complement: arc = total - complement and the complement's
    #       |x|-sum is total_abs_sum minus the arc's own window |x|-sum,
    #       so |cs[i+L] - cs[i]| <= |total| + sum|x| - min windowed
    #       |x|-sum at lag L, NONincreasing in L -> one O(n) scan at the
    #       chunk's smallest lag bounds the chunk (prunes LONG arcs).
    # Noise segments (small arc sums, large psdiff) prune at ~1/CHUNK of
    # the scalar loop's work.  Skipping is exact: a pruned lag has
    # bss <= bound <= best and the update test is strict, so it can never
    # change the result.
    CHUNK = 32
    win = np.lib.stride_tricks.sliding_window_view
    csabs = np.cumsum(np.abs(x), dtype=np.float64)
    total_abs = abs(float(cs[-1]))
    csabs_total = float(csabs[-1])
    jj = np.arange(CHUNK - 1)
    while lo <= hi:
        # pick the side whose NEXT lag has the higher weight (same order
        # the scalar loop used), then take a consecutive run from it
        from_hi = min(lo, n - lo) >= min(hi, n - hi)
        L_first = hi if from_hi else lo
        w_first = n / (L_first * (n - L_first))
        if w_first * psdiff ** 2 <= best:
            break  # no remaining lag on either side can beat best
        c = min(CHUNK, hi - lo + 1)
        if from_hi:                                # scan order: descending L
            l0, hi = hi - c + 1, hi - c
        else:                                      # scan order: ascending L
            l0, lo = lo, lo + c
        lmax = l0 + c - 1
        direct = float((csabs[lmax:] - csabs[:-lmax]).max()) \
            if lmax < n else csabs_total
        compl = total_abs + csabs_total \
            - float((csabs[l0:] - csabs[:-l0]).min())
        # w is minimized at n/2: a chunk crossing it peaks at an endpoint
        w_chunk = max(n / (l0 * (n - l0)), n / (lmax * (n - lmax)))
        if w_chunk * min(psdiff, direct, compl) ** 2 <= best:
            continue                               # whole chunk pruned
        width = n - lmax                           # pairs valid for ALL lags
        rowlag = np.arange(l0, lmax + 1)           # row r <-> lag l0+r
        rows = win(cs, width)[l0: lmax + 1]        # rows: cs[L : L+width]
        dmax_rows = np.abs(rows - cs[:width]).max(axis=1)
        if c > 1:
            # tail pairs (i, i+L) with i >= width, vectorized as one
            # [c, c-1] gather: T[r, j] = cs[width+L+j] - cs[width+j],
            # valid while j < lmax - L
            j = jj[: c - 1]
            idx = np.minimum(width + rowlag[:, None] + j[None, :], n - 1)
            t = np.abs(cs[idx] - cs[width: width + c - 1][None, :])
            t[j[None, :] >= (lmax - rowlag)[:, None]] = 0.0
            np.maximum(dmax_rows, t.max(axis=1), out=dmax_rows)
        wvec = n / (rowlag * (n - rowlag)).astype(np.float64)
        bssv = wvec * dmax_rows ** 2
        bmax = float(bssv.max())
        # Tie caveat: within a chunk, ties resolve to the first lag in scan
        # order (below); across chunks, an exact float bss tie between a lag
        # consumed in an earlier chunk of one side and a lag the scalar
        # interleave would have visited earlier on the other side keeps the
        # earlier-chunk winner.  400-case fuzzing found no such tie; the
        # difference needs bit-identical bss at two different lags.
        if bmax > best:                            # ties: first in SCAN order
            best = bmax
            cand = np.flatnonzero(bssv == bmax)
            ridx = int(cand.max() if from_hi else cand.min())
            L = int(rowlag[ridx])
            d = np.abs(cs[L:] - cs[:-L])
            k = int(np.argmax(d))
            ti, tj = k + 1, k + 1 + L
    return _bss_to_t2(best, tss, n), ti, tj


def htmax_p_batch_np(perms: np.ndarray, tss: float, al0: int,
                     kmax: int) -> np.ndarray:
    """Hybrid max-t over short arcs for each permutation [P, n] — float64
    numpy oracle (~kmax passes over a [P, n] cumsum).  The per-lag diff,
    abs, and row-max run in a reused buffer: at genome-scale (P=512,
    n=16k) each lag otherwise allocates and faults two fresh 64 MB
    temporaries."""
    P, n = perms.shape
    cs = np.cumsum(perms, axis=1)
    best = np.zeros(P, dtype=np.float64)
    buf = np.empty_like(cs)
    wrap = np.empty((P, max(min(kmax, n - 1), 1)), dtype=np.float64)
    for L in range(al0, min(kmax, n - 1) + 1):
        b = buf[:, : n - L]
        np.subtract(cs[:, L:], cs[:, :-L], out=b)
        np.abs(b, out=b)
        d = b.max(axis=1)
        wb = wrap[:, :L]
        np.subtract(cs[:, n - L:], cs[:, :L], out=wb)
        np.abs(wb, out=wb)
        np.maximum(d, wb.max(axis=1), out=d)
        w = n / (L * (n - L))
        np.maximum(best, w * d * d, out=best)
    tssv = np.where(tss <= best + 0.0001, best + 1.0, tss)
    return best / ((tssv - best) / (n - 2.0))


def htmax_p_batch(perms: np.ndarray, tss: float, al0: int,
                  kmax: int) -> np.ndarray:
    """HTMaxP over a permutation batch (the float64 numpy path)."""
    return htmax_p_batch_np(perms, tss, al0, kmax)


def tmax_p_batch(perms: np.ndarray, tss: float, al0: int) -> np.ndarray:
    """Full max-t for each permutation (TMaxP semantics)."""
    P, n = perms.shape
    cs = np.cumsum(perms, axis=1)
    best = np.zeros(P)
    buf = np.empty_like(cs)
    for L in range(al0, n - al0 + 1):
        if L >= n:
            break
        b = buf[:, : n - L]
        np.subtract(cs[:, L:], cs[:, :-L], out=b)
        np.abs(b, out=b)
        d = b.max(axis=1)
        w = n / (L * (n - L))
        np.maximum(best, w * d * d, out=best)
    tssv = np.where(tss <= best + 0.0001, best + 1.0, tss)
    return best / ((tssv - best) / (n - 2.0))


PERM_CHUNK = 512  # permutations evaluated per batch before early-exit checks


def t_perm_p(n1: int, n2: int, x: np.ndarray, n_perm: int,
             rng: np.random.Generator,
             alpha: float | None = None) -> float:
    """Two-sample mean permutation p-value (CBSTStatistic.TPermP).

    Permutations run in PERM_CHUNK batches; with `alpha` given, stops as
    soon as the rejection count can no longer come back under
    alpha * n_perm (the only consumer compares p <= alpha, so the early
    value — already > alpha — yields the identical decision)."""
    n = n1 + n2
    if n1 == 1 or n2 == 1:
        return 1.0
    xsum1 = float(np.sum(x[:n1]))
    xsum2 = float(np.sum(x[n1:n]))
    tss = float(np.sum(x[:n] ** 2))
    xbar = (xsum1 + xsum2) / n
    tss -= n * xbar ** 2
    if n1 <= n2:
        m1, rm1 = n1, float(n1)
        ostat = 0.99999 * abs(xsum1 / n1 - xbar)
        tstat = ostat ** 2 * n1 * n / n2
    else:
        m1, rm1 = n2, float(n2)
        ostat = 0.99999 * abs(xsum2 / n2 - xbar)
        tstat = ostat ** 2 * n2 * n / n1
    tstat = tstat / ((tss - tstat) / (n - 2.0))
    if tstat > 25 and m1 >= 10:
        return 0.0
    limit = alpha * n_perm if alpha is not None else np.inf
    count = 0
    done_ = 0
    xn = x[:n]
    while done_ < n_perm:
        m = min(PERM_CHUNK, n_perm - done_)
        # sampling without replacement: the m1 smallest random keys are the
        # same SET argsort[:, :m1] picks, and only the subset sum matters
        r = rng.random((m, n))
        picks = np.argpartition(r, m1 - 1, axis=1)[:, :m1]
        sums = np.sum(xn[picks], axis=1)
        pstat = np.abs(sums / rm1 - xbar)
        count += int(np.count_nonzero(ostat <= pstat))
        done_ += m
        if count > limit:
            break
    return count / n_perm


# ---------------------------------------------------------------------------
# Change-point search (ChangePoint.FindChangePoints / ChangePoints)
# ---------------------------------------------------------------------------

def find_change_points(
    x: np.ndarray, tss: float, n_perm: int, alpha: float, sbdry: np.ndarray,
    hybrid: bool, min_width: int, kmax: int, delta: float,
    rng: np.random.Generator, n_grid: int = 100, tol: float = 1e-6,
) -> list[int]:
    """Returns 0, 1 or 2 change points (indices into x)."""
    n = len(x)
    ostat, i1, i2 = tmax_o(x, tss, min_width)
    ostat1 = np.sqrt(ostat)
    ostat *= 0.99999
    if ostat1 <= 0.1:
        return []
    l = min(i2 - i1, n - i2 + i1)
    if not (ostat1 >= 7.0 and l >= 10):
        # permutation p-value with sequential stopping.  Permutations are
        # generated and evaluated in PERM_CHUNK batches (vectorized), and
        # generation STOPS when the sequential boundary walk terminates —
        # the reference's per-permutation loop usually stops after a few
        # hundred of the 10,000, so batching all of them up front costs
        # ~20-40x the useful work at n ~ 10^4.
        if hybrid:
            p1 = tail_p(ostat1, delta, n, n_grid, tol)
            if p1 > alpha:
                return []
            nrejc = int((alpha - p1) * n_perm)
        else:
            nrejc = int(alpha * n_perm)
        k = nrejc * (nrejc + 1) // 2 + 1
        nrej = 0
        accepted = True
        np_i = 0
        walking = True
        # doubling chunk schedule (64 -> PERM_CHUNK): the sequential
        # boundary walk usually terminates within the first couple of
        # hundred permutations, so a fixed 512-permutation first batch
        # computes 2-4x more max-t stats than the walk consumes.  Chunk
        # size does not change the permutation sequence: Generator.random
        # fills row-major from one bitstream, so consecutive smaller draws
        # yield the exact rows one large draw would.
        chunk = PERM_CHUNK // 8
        while walking and np_i < n_perm:
            m = min(chunk, n_perm - np_i)
            chunk = min(chunk * 2, PERM_CHUNK)
            perms = _permute_batch(x, m, rng)
            if hybrid:
                pstats = htmax_p_batch(perms, tss, min_width, kmax)
            else:
                pstats = tmax_p_batch(perms, tss, min_width)
            for j in range(m):
                np_i += 1
                if ostat <= pstats[j]:
                    nrej += 1
                    k += 1
                if nrej > nrejc:
                    accepted = False
                    walking = False
                    break
                if np_i >= sbdry[k - 1]:
                    walking = False
                    break
        if not accepted:
            return []
    # split location tests (ChangePoint.cs:359-398)
    if i2 == n:
        return [i1]
    if i1 == 0:
        return [i2]
    out = []
    p = t_perm_p(i1, i2 - i1, x, n_perm, rng, alpha=alpha)
    if p <= alpha:
        out.append(i1)
    p = t_perm_p(i2 - i1, n - i2, x[i1:], n_perm, rng, alpha=alpha)
    if p <= alpha:
        out.append(i2)
    return out


def _permute_batch(x: np.ndarray, n_perm: int,
                   rng: np.random.Generator) -> np.ndarray:
    idx = np.argsort(rng.random((n_perm, len(x))), axis=1)
    return x[idx]


def change_points(
    data: np.ndarray,
    sbdry: np.ndarray,
    rng: np.random.Generator,
    alpha: float = DEFAULT_ALPHA,
    n_perm: int = DEFAULT_NPERM,
    p_method: str = "hybrid",
    min_width: int = DEFAULT_MIN_WIDTH,
    kmax: int = DEFAULT_KMAX,
    n_min: int = DEFAULT_NMIN,
    trimmed_sd: float = -1.0,
    undo_splits: str = "none",
    undo_prune: float = 0.05,
    undo_sd: float = 3.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Recursive search (ChangePoint.ChangePoints).
    Returns (segment lengths, segment means)."""
    data = np.asarray(data, dtype=np.float64)
    if trimmed_sd <= 0:
        trimmed_sd = stats.mad(np.diff(data)) / np.sqrt(2)
    seg_end = [0, len(data)]
    change_locations: list[int] = []
    while len(seg_end) > 1:
        lo, hi = seg_end[-2], seg_end[-1]
        current = data[lo:hi]
        n = len(current)
        cps: list[int] = []
        if n >= 2 * min_width and current.max() != current.min():
            hybrid = p_method == "hybrid" and n_min < n
            delta = (kmax + 1.0) / n if hybrid else 0.0
            centered = current - current.mean()
            tss = float(np.sum(centered ** 2))
            cps = find_change_points(
                centered, tss, n_perm, alpha, sbdry, hybrid, min_width,
                kmax, delta, rng)
            cps = [c + lo for c in cps]
        if not cps:
            change_locations.append(hi)
            seg_end.pop()
        else:
            seg_end[-1:-1] = cps
    change_locations.reverse()
    seg_ends = [0] + change_locations
    length_seg = np.diff(np.asarray(seg_ends))
    if len(change_locations) > 1:
        if undo_splits == "prune":
            length_seg = _prune(data, length_seg, undo_prune)
        elif undo_splits == "sdundo":
            length_seg = _sd_undo(data, length_seg, trimmed_sd, undo_sd)
    means = np.empty(len(length_seg))
    ll = 0
    for i, L in enumerate(length_seg):
        means[i] = data[ll:ll + L].mean()
        ll += L
    return np.asarray(length_seg, dtype=np.int64), means


def _sd_undo(data: np.ndarray, length_seg: np.ndarray, trimmed_sd: float,
             change_sd: float) -> np.ndarray:
    """ChangePointsSDUndo (:155-196): repeatedly remove the changepoint with
    the smallest |median difference| below change_sd * trimmedSD."""
    cut = change_sd * trimmed_sd
    ends = list(np.cumsum(length_seg))
    while len(ends) > 1:
        starts = [0] + ends[:-1]
        medians = [stats.median(data[s:e]) for s, e in zip(starts, ends)]
        absdiff = np.abs(np.diff(medians))
        i_min = int(np.argmin(absdiff))
        if absdiff[i_min] < cut:
            ends.pop(i_min)
        else:
            break
    return np.diff(np.asarray([0] + ends))


def _prune(data: np.ndarray, length_seg: np.ndarray,
           change_cutoff: float) -> np.ndarray:
    """ChangePointsPrune (:205-271): smallest changepoint subset whose
    weighted SS stays within (1+cutoff) of the full model."""
    from itertools import combinations

    ncp = len(length_seg) - 1
    seg_sums = np.array([data[s:e].sum() for s, e in zip(
        np.concatenate([[0], np.cumsum(length_seg)[:-1]]),
        np.cumsum(length_seg))])
    ssq = float(np.sum(data ** 2))
    lengths = np.asarray(length_seg)

    def ess(loc: tuple[int, ...]) -> float:
        # error SS given changepoints at 1-based segment-boundary ids
        bounds = [0] + [sum(lengths[:i]) for i in loc] + [int(lengths.sum())]
        out = 0.0
        for s, e in zip(bounds[:-1], bounds[1:]):
            seg = data[s:e]
            out += seg.sum() ** 2 / len(seg)
        return out

    full = tuple(range(1, ncp + 1))
    wssqk = ssq - ess(full)
    kept = full
    for j in range(ncp - 1, 0, -1):
        best_w, best_loc = np.inf, None
        for loc in combinations(range(1, ncp + 1), j):
            w = ssq - ess(loc)
            if w <= best_w:
                best_w, best_loc = w, loc
        if best_w / wssqk > 1 + change_cutoff:
            break
        kept = best_loc
    cum = np.cumsum(lengths)
    pts = [0] + [int(cum[i - 1]) for i in kept] + [int(lengths.sum())]
    return np.diff(np.asarray(sorted(set(pts))))


def run_cbs(
    coverage_by_contig: dict[str, np.ndarray],
    alpha: float = DEFAULT_ALPHA,
    n_perm: int = DEFAULT_NPERM,
    undo_method: str = "none",
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """CBSRunner.Run equivalent: per-contig change points with deterministic
    per-contig RNG streams.  Returns contig -> segment lengths (in finite-bin
    index space).

    The engine follows the device, explicitly.  On a CUDA device, when
    every contig has at most 2^16 bins, the whole-recursion engine
    (ops/cbs_mega.py) runs there, as in the JAX package: same algorithm,
    permutations and statistics on the device with threefry streams (a
    documented Monte-Carlo-level deviation from the host path).  Where its
    segment table cannot hold the input it returns None and the frontier
    engine (ops/cbs_device.py) runs instead.  On the CPU, or for a longer
    contig (the device arc scan is O(n^2) before pruning; the host
    branch-and-bound prunes harder), the host path runs.  A device
    failure raises; nothing falls back, and asking for a missing card
    raises."""
    device = resolve_device(device)
    if (device.type == "cuda" and coverage_by_contig
            and max(len(np.asarray(v)) for v in coverage_by_contig.values())
            <= 65536):
        from canvas_tpu_torch.ops import cbs_device, cbs_mega

        counts: dict = {}
        out = cbs_mega.run_cbs_mega(
            coverage_by_contig, alpha=alpha, n_perm=n_perm,
            undo_method=undo_method, seed=seed, device=device,
            counts=counts)
        if out is not None:
            _LAST_ENGINE.update(engine="mega", host_workers=None,
                                levels=counts.get("levels", 0))
            return out
        levels: list[dict] = []
        out = cbs_device.run_cbs_device(
            coverage_by_contig, alpha=alpha, n_perm=n_perm,
            undo_method=undo_method, seed=seed, device=device,
            levels=levels)
        _LAST_ENGINE.update(engine="frontier", host_workers=None,
                            levels=len(levels))
        return out
    _LAST_ENGINE.update(engine="host", host_workers=None, levels=None)
    return _run_cbs_host(coverage_by_contig, alpha, n_perm, undo_method,
                         seed)


def _run_cbs_host(coverage_by_contig, alpha, n_perm, undo_method, seed):
    """The host (parity-oracle) CBS path of run_cbs."""
    sbdry = compute_boundary(n_perm, alpha, DEFAULT_ETA)
    finite = {k: np.asarray(v, np.float64)[np.isfinite(v)]
              for k, v in coverage_by_contig.items()}
    if sum(len(v) for v in finite.values()) == 0:
        return {}
    tsd = float(np.sqrt(trimmed_variance(finite)))
    # deterministic per-contig RNG streams drawn from a master seed
    # (CBSRunner.cs:107-112).  Per-contig seeds are drawn serially BEFORE
    # any fan-out so parallel and serial runs see identical streams.
    seed_gen = np.random.default_rng(seed)
    items = [(name, cov, int(seed_gen.integers(0, 2 ** 31 - 1)))
             for name, cov in coverage_by_contig.items()]
    workers = _host_cbs_workers(len(items))
    if workers > 1:
        # The reference runs CBS per-chromosome over all cores
        # (CBSRunner.cs:62-147, MaxDegreeOfParallelism).  Threads HURT here
        # (GIL-bound tail-p/boundary walks: 2.5s serial vs 4.9s threaded on
        # 8x16k bins, round-2 measurement), so fan out with forked
        # PROCESSES: fork after the boundary/schedule caches are warm, so
        # children inherit them copy-on-write and run pure numpy/scipy.
        #
        # The process may already hold torch's thread pools and a CUDA
        # context (the children never touch CUDA), and fork-with-threads
        # can (rarely) wedge a child on a lock held at fork time.  spawn/forkserver are NOT safe alternatives here:
        # their bootstrap re-imports __main__ by path, which breaks (and
        # loops respawning workers) under stdin/embedded entrypoints.
        # Instead, exploit that a fork deadlock manifests AT CHILD START:
        # run a trivial canary task first with a short timeout — a wedged
        # pool fails the canary in seconds, the context manager terminates
        # it, and the bit-identical serial path below takes over.  Real
        # work then runs with no timeout, so long contigs are never
        # misclassified as deadlocks.  Per-contig seeds are drawn before
        # fan-out, so parallel and serial results are bit-identical.
        import multiprocessing as mp
        import warnings

        args = [(cov, s, alpha, n_perm, tsd, undo_method, sbdry)
                for _name, cov, s in items]
        total_bins = sum(len(np.asarray(cov)) for _n, cov, _s in items)
        try:
            with warnings.catch_warnings():
                # Python 3.12 DeprecationWarning for fork-with-threads;
                # the canary below is the actual mitigation.
                warnings.filterwarnings(
                    "ignore", category=DeprecationWarning,
                    message=".*fork.*")
                with mp.get_context("fork").Pool(
                        workers, initializer=_mark_pool_worker) as pool:
                    pool.map_async(_host_cbs_canary, range(workers)).get(
                        timeout=_HOST_CBS_CANARY_TIMEOUT_S)
                    # end-to-end watchdog: the canary only catches a child
                    # wedged AT FORK; a lock acquired between canary and
                    # work can still deadlock mid-map, so the real work
                    # runs under a generous size-scaled timeout — expiry
                    # terminates the pool (context manager) and the
                    # bit-identical serial path below takes over.
                    results = pool.starmap_async(_host_cbs_one, args).get(
                        timeout=_host_cbs_pool_timeout(total_bins))
            _LAST_ENGINE["host_workers"] = workers
            return {name: lengths
                    for (name, _c, _s), lengths in zip(items, results)}
        except Exception:   # fork/pickle/canary/watchdog -> serial path
            pass
    _LAST_ENGINE["host_workers"] = 1
    return {name: _host_cbs_one(cov, s, alpha, n_perm, tsd, undo_method,
                                sbdry)
            for name, cov, s in items}


# Deadlock guard for the host CBS pool: every worker must answer a trivial
# canary task within this window before real work is dispatched.  A child
# wedged by fork-with-threads hangs at startup, so the canary catches it
# in seconds; the caller then recomputes serially (identical results).
_HOST_CBS_CANARY_TIMEOUT_S = 30.0


def _host_cbs_canary(i: int) -> int:
    """Trivial liveness probe run by every pool worker before real work."""
    return i


# True only inside forked pool workers (set by the pool initializer);
# lets the fault-injection hook below hang CHILDREN without hanging the
# serial fallback that runs in the parent.
_IN_POOL_WORKER = False


def _mark_pool_worker() -> None:
    global _IN_POOL_WORKER
    _IN_POOL_WORKER = True


def _host_cbs_pool_timeout(total_bins: int) -> float:
    """Watchdog for the pool's real work: generous (2 ms/bin, >= 300 s —
    the host path does ~50k-1M bins/s, so a healthy run finishes at
    >= 25x margin), overridable via CANVAS_TPU_CBS_POOL_TIMEOUT_S."""
    import os

    v = os.environ.get("CANVAS_TPU_CBS_POOL_TIMEOUT_S")
    if v is not None:
        try:
            return max(0.1, float(v))
        except ValueError:
            pass
    return max(300.0, 2e-3 * total_bins)


def _host_cbs_workers(n_contigs: int) -> int:
    """Process fan-out for the host path: min(cores, contigs), opt-out via
    CANVAS_TPU_CBS_PROCS=1 (serial) or =N; 1 when fork is unavailable."""
    import os

    if not hasattr(os, "fork"):
        return 1
    v = os.environ.get("CANVAS_TPU_CBS_PROCS", "auto")
    if v != "auto":
        try:
            return max(1, int(v))
        except ValueError:
            return 1
    return max(1, min(os.cpu_count() or 1, n_contigs))


def _host_cbs_one(cov, contig_seed: int, alpha: float, n_perm: int,
                  tsd: float, undo_method: str,
                  sbdry: np.ndarray) -> np.ndarray:
    import os

    hang = os.environ.get("CANVAS_TPU_TEST_CBS_CHILD_HANG_S")
    if hang and _IN_POOL_WORKER:
        # deterministic fault injection: simulate a child deadlocked
        # MID-WORK (after the canary passed); only pool workers hang, so
        # the serial fallback in the parent stays healthy
        import time

        time.sleep(float(hang))
    rng = np.random.default_rng(contig_seed)
    lengths, _ = change_points(
        cov, sbdry, rng, alpha=alpha, n_perm=n_perm,
        trimmed_sd=tsd, undo_splits=undo_method)
    return lengths
