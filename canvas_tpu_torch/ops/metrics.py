"""Coverage-quality metrics used by segmentation and the somatic caller.

  * Evenness score (Oexle 2010 formula over windows of coverage bins,
    Segmentation.cs:260-297) — written to EvennessMetric.txt and used to
    pick coverage-vs-MAF weighting in the somatic caller;
  * Coverage variability (windowed MAD/median quasi-CV, :299-347);
  * Factor-of-three CMADs — triplet-median pyramid of (c-a)/2/b per scale
    (:349-429) — the scale-dependent significance cutoffs used by wavelet
    split healing.
"""

from __future__ import annotations

import numpy as np

from canvas_tpu_torch.ops import stats


def _window_evenness(window: np.ndarray) -> float:
    """Oexle evenness of one window (Segmentation.cs:281-292)."""
    avg = window.mean()
    total = window.sum()
    e = 0.0
    level = 0
    while level <= avg:
        e += np.count_nonzero(window >= level) / total
        level += 1
    return e


def evenness_scores_by_window(
    coverage_by_contig: dict[str, np.ndarray], window: int) -> list[float]:
    """Per-window evenness scores; windows step by `window` but take
    window-1 bins (reference Take(windowSize-1), Segmentation.cs:283)."""
    out = []
    for cov in coverage_by_contig.values():
        cov = np.asarray(cov, dtype=np.float64)
        for index in range(0, len(cov) - window, window):
            w = cov[index:index + window - 1]
            e = _window_evenness(w)
            if np.isfinite(e):
                out.append(float(e))
    return out


def evenness_score(coverage_by_contig: dict[str, np.ndarray],
                   window: int = 100_000) -> float:
    """GetEvennessScore (Segmentation.cs:260-269)."""
    iqr_threshold = 0.015
    scores_iqr = evenness_scores_by_window(coverage_by_contig, 10_000)
    q1, _, q3 = stats.quartiles(np.asarray(scores_iqr, dtype=np.float32))
    scores = evenness_scores_by_window(coverage_by_contig, window)
    med = stats.median(scores)
    return q3 * 100.0 if (q3 - q1) > iqr_threshold else med * 100.0


def variability_by_window(coverage_by_contig: dict[str, np.ndarray],
                          window: int) -> list[float]:
    """Windowed MAD/median (Segmentation.cs:333-347)."""
    out = []
    for cov in coverage_by_contig.values():
        cov = np.asarray(cov, dtype=np.float64)
        for index in range(0, len(cov) - window, window):
            m = stats.mad(cov, index, index + window)
            med = stats.median(cov[index:index + window])
            # C# double division: 0/0 -> NaN, x/0 -> Inf (an all-zero
            # window, e.g. inside a homozygous deletion, stays in the list
            # and sorts NaN-first downstream; Segmentation.cs:343)
            with np.errstate(divide="ignore", invalid="ignore"):
                out.append(float(np.float32(np.float64(m) / med)))
    return out


def coverage_variability(coverage_by_contig: dict[str, np.ndarray],
                         window: int) -> float | None:
    """GetCoverageVariability (Segmentation.cs:299-327)."""
    total = sum(len(np.asarray(c)) for c in coverage_by_contig.values())
    if total < 10 * window:
        return None
    window_iqr = 10_000
    if window > window_iqr:
        iqr_threshold = 0.015
        rv = variability_by_window(coverage_by_contig, window_iqr)
        q1, q2, q3 = stats.quartiles(np.asarray(rv, dtype=np.float32))
        if (q3 - q1) / q2 > iqr_threshold:
            return float(q1)
    rv = variability_by_window(coverage_by_contig, window)
    # Deliberate divergence: when every contig is shorter than the window
    # (possible when total bins pass the 10*window gate but are spread over
    # many small contigs) the reference would throw from Median(empty);
    # treat it as "no variability estimate" instead.
    if not rv:
        return None
    return stats.median(np.asarray(rv, dtype=np.float32))


def factor_of_three_cmads(coverage_by_contig: dict[str, np.ndarray],
                          max_exponent: int = 8) -> list[float]:
    """FactorOfThreeCoverageVariabilities (Segmentation.cs:364-429).

    At each scale, non-overlapping triplets (a,b,c) sorted give the median b
    (carried to the next scale) and CMAD (c-a)/2/b."""
    results = {k: np.asarray(v, dtype=np.float64)
               for k, v in coverage_by_contig.items()}
    cmad_list: list[float] = [0.0]
    exponent = 1
    while exponent <= max_exponent:
        cmads: list[float] = []
        new_results = {}
        for key, data in results.items():
            n = len(data) // 3
            if n == 0:
                new_results[key] = data[:0]
                continue
            trip = np.sort(data[: n * 3].reshape(n, 3), axis=1)
            a, b, c = trip[:, 0], trip[:, 1], trip[:, 2]
            new_results[key] = b
            # b == 0 yields inf/nan CMADs, as in the reference; the median
            # downstream absorbs them
            with np.errstate(divide="ignore", invalid="ignore"):
                cmads.extend(((c - a) / 2.0 / b).tolist())
        results = new_results
        if len(cmads) < 50:
            cmad_list.extend([cmad_list[-1]] * (max_exponent - len(cmad_list) + 1))
            break
        cmad_list.append(stats.median(cmads))
        exponent += 1
    return cmad_list
