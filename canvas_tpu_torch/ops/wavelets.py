"""Unbalanced Haar wavelet segmentation (CanvasPartition Wavelets mode).

Implements Fryzlewicz 2007 top-down unbalanced Haar decomposition with the
reference's specific conventions (WaveletSegmentation.cs):

  * inner product at split m (1-based) of a length-n segment equals
    sqrt(m*(n-m)/n) * (mean(left) - mean(right)); computed here from prefix
    sums in float64 (the reference uses an equivalent sequential recurrence,
    :19-48);
  * each coefficient is normalized by max(0.5, segmentMean/200) (:282-283);
  * argmax of |inner product|, first index on ties (:54-67);
  * hard thresholding at 2*sigma*t*sqrt(2*ln(n)) with germline per-node
    weights t in (0.8, 1.0] assigned through the reference's
    sorted-indices permutation (:72-115);
  * reconstruction + breakpoint extraction (:138-185);
  * healing of poorly-supported splits using factor-of-three CMAD cutoffs
    (:194-232) and germline breakpoint refinement by local median search
    (:237-258).

The decomposition is a data-dependent binary recursion — host-driven, with
vectorized prefix-sum inner products per node (the per-node work is what the
reference does sequentially).
"""

from __future__ import annotations

import functools

import numpy as np

from canvas_tpu_torch.ops import stats

MEAN_SCALE = 200.0
DEFAULT_MAD_FACTOR = 5.0  # WaveletsRunner.cs:14


def inner_products(x: np.ndarray) -> tuple[np.ndarray, float]:
    """All n-1 unbalanced Haar inner products of x; returns (ip, mean)."""
    n = len(x)
    cs = np.cumsum(x, dtype=np.float64)
    total = cs[-1]
    m = np.arange(1, n, dtype=np.float64)
    left = cs[:-1]
    right = total - left
    # sqrt(1/m - 1/n)*left - (1/sqrt(n^2/m - n))*right
    ip = np.sqrt(1.0 / m - 1.0 / n) * left - right / np.sqrt(n * n / m - n)
    return ip, total / n


def _best_split(x: np.ndarray) -> tuple[int, float, float]:
    """(1-based split index, raw coefficient, normalized coefficient)."""
    ip, mean = inner_products(x)
    absip = np.abs(ip)
    ind = int(np.flatnonzero(absip == absip.max())[0]) + 1
    coeff = ip[ind - 1] / max(0.5, mean / MEAN_SCALE)
    return ind, ip[ind - 1], coeff


@functools.lru_cache(maxsize=64)
def _bucket_consts(Lb: int):
    """(iota int64 [Lb], m float64 [1, Lb-1], 1/m [1, Lb-1]) per bucket."""
    iota = np.arange(Lb, dtype=np.int64)
    m = np.arange(1, Lb, dtype=np.float64)[None, :]
    return iota, m, 1.0 / m


def _best_splits_batch(x_pad: np.ndarray, lo: np.ndarray,
                       lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized _best_split over many spans of x at once.

    Spans are bucketed by next-power-of-two length and padded to 2-D
    rectangles so each row's cumsum runs in the SAME sequential order as
    np.cumsum over the 1-D slice — results are bit-identical to calling
    _best_split per span, but without the per-node Python dispatch (the
    tree has ~n nodes; per-node calls cost ~14s at 500k bins).

    x_pad must extend at least max-bucket elements past the data (see
    decompose), so row gathers need no bounds clamp; per-bucket index
    vectors are lru-cached — fresh aranges cost ~2.5s per 1M-bin genome.

    lo: 0-based span starts; lens >= 2.  Returns (ind 1-based, coeff)."""
    k = len(lo)
    ind = np.empty(k, dtype=np.int64)
    coeff = np.empty(k, dtype=np.float64)
    if k == 0:
        return ind, coeff
    buck = np.maximum(np.ceil(np.log2(lens)).astype(np.int64), 1)
    for b in np.unique(buck):
        sel = np.flatnonzero(buck == b)
        Lb = 1 << int(b)
        iota, mcol, inv_m = _bucket_consts(Lb)
        ls = lens[sel]
        rows = lo[sel][:, None] + iota[None, :]
        in_span = iota[None, :] < ls[:, None]
        X = np.where(in_span, x_pad[rows], 0.0)
        cs = np.cumsum(X, axis=1)
        nn = ls.astype(np.float64)[:, None]
        ksel = np.arange(len(sel))
        total = cs[ksel, ls - 1][:, None]
        left = cs[:, :-1]
        right = total - left
        with np.errstate(invalid="ignore", divide="ignore"):
            # inv_m is bitwise 1.0/m (same np division); nn*nn/mcol must
            # stay a division — (n^2)*(1/m) rounds differently
            ip = (np.sqrt(inv_m - 1.0 / nn) * left
                  - right / np.sqrt(nn * nn / mcol - nn))
        absip = np.where(mcol < nn, np.abs(ip), -np.inf)
        a = np.argmax(absip, axis=1)            # first max, like flatnonzero
        ind[sel] = a + 1
        mean = total[:, 0] / nn[:, 0]
        coeff[sel] = ip[ksel, a] / np.maximum(0.5, mean / MEAN_SCALE)
    return ind, coeff


def decompose(x: np.ndarray) -> tuple[list[np.ndarray], float]:
    """Top-down decomposition.  Returns (tree, smooth).

    tree[j] is a [K_j, 5] float array of nodes (index, coeff, start, split,
    end) with the reference's 1-based inclusive conventions: the node covers
    x[start-1 .. end-1]; `split` is the last point of the left child.
    Each level's best splits are computed in one batched pass.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    # pad so bucket-rectangle row gathers never need a bounds clamp: the
    # largest bucket is the next power of two >= n
    max_bucket = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    x_pad = np.concatenate([x, np.zeros(max_bucket, np.float64)])
    # Exact-zero spans (no observed coverage, e.g. homozygous deletions)
    # have all-zero inner products, so the argmax splits at index 1 every
    # time and the subtree degenerates into a one-node-per-level comb of
    # zero coefficients, `span length` levels deep.  Those chains are
    # deterministic, so they are injected level-by-level without batch
    # evaluation — the level structure (and hence the germline threshold
    # ramp) is preserved bit-for-bit, but a 5k-bin deletion no longer
    # costs 5k batched-evaluation rounds.
    nz_prefix = np.concatenate([[0], np.cumsum(x != 0.0)])

    def is_zero_span(s: np.ndarray, e: np.ndarray) -> np.ndarray:
        # s, e: 1-based inclusive bounds
        return nz_prefix[e.astype(np.int64)] - \
            nz_prefix[s.astype(np.int64) - 1] == 0

    pending: dict[int, list[np.ndarray]] = {}

    def inject_chain(level0: int, s: float, e: float) -> None:
        """Nodes ([s..e], [s+1..e], ..., [e-1..e]) at levels level0+0.."""
        L = int(e - s)                        # produces L nodes
        for k in range(L):
            pending.setdefault(level0 + k, []).append(
                np.array([0.0, 0.0, s + k, s + k, e]))

    ind, _, coeff = _best_split(x)
    tree: list[np.ndarray] = [np.array([[1.0, coeff, 1.0, ind, n]])]
    frontier = tree[0]
    if is_zero_span(np.array([1.0]), np.array([float(n)]))[0]:
        # whole contig zero: root splits at 1, chain covers the rest
        inject_chain(1, 2.0, float(n))
        frontier = frontier[:0]
    j = 0
    while True:
        idxs, starts = frontier[:, 0], frontier[:, 2]
        splits, ends = frontier[:, 3], frontier[:, 4]
        # node ids double per level exactly like the reference
        # (WaveletSegmentation.cs:318,350); on very deep trees they
        # saturate to inf in float64 there too — the id column is
        # never consumed, so silence the benign overflow warning.
        with np.errstate(over="ignore"):
            lid, rid = 2 * idxs - 1, 2 * idxs
        pl = np.flatnonzero(splits - starts >= 1)   # left child >= 2 points
        pr = np.flatnonzero(ends - splits >= 2)     # right child >= 2 points
        # per-parent (left, right) order like the sequential construction
        order = np.argsort(np.concatenate([pl * 2, pr * 2 + 1]),
                           kind="stable")
        c_id = np.concatenate([lid[pl], rid[pr]])[order]
        c_start = np.concatenate([starts[pl], splits[pr] + 1])[order]
        c_end = np.concatenate([splits[pl], ends[pr]])[order]
        zero = is_zero_span(c_start, c_end)
        for s, e in zip(c_start[zero], c_end[zero]):
            inject_chain(j + 1, s, e)
        c_id, c_start, c_end = c_id[~zero], c_start[~zero], c_end[~zero]
        lo = (c_start - 1).astype(np.int64)
        lens = (c_end - c_start + 1).astype(np.int64)
        ci, cc = _best_splits_batch(x_pad, lo, lens)
        frontier = np.stack(
            [c_id, cc, c_start, ci + c_start - 1, c_end], axis=1) \
            if len(c_id) else np.zeros((0, 5))
        j += 1
        injected = pending.pop(j, None)
        level = (np.concatenate([frontier, np.stack(injected)])
                 if injected else frontier)
        if len(level) == 0:
            break
        tree.append(level)
        # expansion continues only for batch children; injected chain
        # nodes already carry their full subtrees in `pending`
        if len(frontier) == 0:
            # only chain levels remain — they are contiguous; drain them
            for lev in sorted(pending):
                assert lev == j + 1, "chain levels must be contiguous"
                tree.append(np.stack(pending[lev]))
                j += 1
            break
        # done when every remaining node's children are single points and
        # nothing is pending
        if not pending and \
                np.sum(frontier[:, 4] - frontier[:, 2] - 1.0) == 0:
            break
    smooth = float(np.sum(x) / np.sqrt(n))
    return tree, smooth


def hard_threshold(tree: list[np.ndarray], sigma: float,
                   is_germline: bool) -> None:
    """Zero coefficients below 2*sigma*t*sqrt(2 ln n) in place
    (WaveletSegmentation.cs:72-115)."""
    tree_size = len(tree)
    if is_germline:
        counts = np.array([t.shape[0] for t in tree])
        order = np.argsort(-counts, kind="stable")  # node ids by count desc
        ramp = (np.arange(1, tree_size + 1) * (1.0 - 0.8)) / tree_size + 0.8
        thr = ramp[order]   # thresholds[indices[nodeIndex]] in the reference
    else:
        thr = np.ones(tree_size)
    n = tree[0][0, 4]
    lim = np.sqrt(2 * np.log(n))
    for j in range(tree_size):
        cut = 2 * sigma * thr[j] * lim
        coeffs = tree[j][:, 1]
        coeffs[np.abs(coeffs) <= cut] = 0.0


def reconstruct(tree: list[np.ndarray], smooth: float) -> np.ndarray:
    """GetReconstructedVector (:138-168)."""
    n = int(tree[0][0, 4])
    rec = np.full(n, smooth / np.sqrt(n))
    for level in tree:
        for idx, coeff, start, split, end in level:
            if coeff == 0.0:
                continue
            nn = end - start + 1
            mm = split - start + 1
            val1 = np.sqrt(1 / mm - 1 / nn)
            val2 = -1.0 / np.sqrt(nn * nn / mm - nn)
            s, sp, e = int(start) - 1, int(split), int(end)
            rec[s:sp] += val1 * coeff
            rec[sp:e] += val2 * coeff
    return rec


def breakpoints_from_reconstruction(rec: np.ndarray) -> list[int]:
    bps = [0]
    bps.extend(int(i) for i in (np.flatnonzero(np.diff(rec) != 0) + 1))
    return bps


def heal_bad_splits(prelim: list[int], ratio: np.ndarray,
                    factor_of_three_cmads: list[float]) -> list[int]:
    """Greedy removal of breakpoints whose flanking medians are too close
    (:194-232)."""
    n = len(ratio)
    out = [prelim[0]]
    for i in range(1, len(prelim)):
        left_start = out[-1]
        right_start = prelim[i]
        right_end = prelim[i + 1] if i < len(prelim) - 1 else n
        left_med = stats.median(ratio[left_start:right_start])
        right_med = stats.median(ratio[right_start:right_end])
        ll = right_start - left_start
        rl = right_end - right_start
        weighted = (ll * left_med + rl * right_med) / (right_end - left_start)
        smaller = min(ll, rl)
        scale = min(len(factor_of_three_cmads) - 1,
                    int(np.ceil(np.log(smaller) / np.log(3))))
        cutoff = factor_of_three_cmads[scale]
        if abs(left_med - right_med) > cutoff * 4 * max(weighted, 50.0):
            out.append(right_start)
    return out


def refine_segments(breakpoints: list[int], coverage: np.ndarray) -> list[int]:
    """Germline: nudge each interior breakpoint to maximize the deviation of
    the left segment's median from the chromosome median (:237-258)."""
    half_window = 5
    total_median = stats.median(coverage)
    bps = list(breakpoints)
    for i in range(1, len(bps) - 1):
        left = min(half_window, (bps[i] - bps[i - 1]) // 2)
        right = min(half_window, (bps[i + 1] - bps[i]) // 2)
        best_diff = abs(stats.median(coverage[bps[i - 1]:bps[i]]) - total_median)
        best = bps[i]
        for j in range(bps[i] - left, bps[i] + right):
            diff = abs(stats.median(coverage[bps[i - 1]:j]) - total_median)
            if diff > best_diff:
                best_diff, best = diff, j
        bps[i] = best
    return bps


def haar_wavelets(
    ratio: np.ndarray,
    threshold_lower: float,
    threshold_upper: float,
    is_germline: bool,
    mad_factor: float,
    coeff_variability: float | None,
    factor_of_three_cmads: list[float],
) -> list[int]:
    """HaarWavelets entry (:385-426).  Returns breakpoint bin indices."""
    ratio = np.asarray(ratio, dtype=np.float64)
    tree, smooth = decompose(ratio)
    median = stats.median(ratio)
    variability = (median * coeff_variability if coeff_variability is not None
                   else stats.mad(ratio))
    threshold = mad_factor * variability
    threshold = max(threshold, threshold_lower)
    threshold = min(threshold, threshold_upper)
    hard_threshold(tree, threshold, is_germline)
    prelim = breakpoints_from_reconstruction(reconstruct(tree, smooth))
    bps = heal_bad_splits(prelim, ratio, factor_of_three_cmads)
    if is_germline:
        bps = refine_segments(bps, ratio)
    return bps


def segment_coverage(
    coverage_by_contig: dict[str, np.ndarray],
    is_germline: bool,
    coeff_variability: float | None,
    factor_of_three_cmads: list[float],
    mad_factor: float = DEFAULT_MAD_FACTOR,
    threshold_lower: float = 0.05,   # thresholdLowerMaf quirk, WaveletsRunner.cs:35
    threshold_upper: float = 80.0,
    min_size: int = 10,
) -> dict[str, list[int]]:
    """LaunchWavelets over all contigs (WaveletsRunner.cs:83-139).

    Note the reference passes thresholdLowerMaf (0.05) as ThresholdLower
    for coverage too (WaveletsRunnerParams ctor, :35) — reproduced.
    Contigs run on a thread pool (the reference's Parallel.ForEach,
    WaveletsRunner.cs:89-135); the numpy inner loops release the GIL.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    def one(cov) -> list[int]:
        cov = np.asarray(cov, dtype=np.float64)
        if max(len(cov), 1) > min_size:
            return haar_wavelets(
                cov, threshold_lower, threshold_upper, is_germline,
                mad_factor, coeff_variability, factor_of_three_cmads)
        return []

    names = list(coverage_by_contig)
    with ThreadPoolExecutor(max_workers=min(len(names) or 1,
                                            os.cpu_count() or 1)) as ex:
        results = ex.map(one, (coverage_by_contig[n] for n in names))
    return dict(zip(names, results))
