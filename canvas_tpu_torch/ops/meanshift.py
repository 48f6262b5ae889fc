"""Mean-shift clustering for the somatic caller's default clustering mode.

Behavioral re-implementation of the reference's Accord-derived MeanShift
(CanvasSomaticCaller/MeanShift.cs): grid-cell seeding at 2*bandwidth
(createSeeds, :616-681), per-seed hill climb to a density mode using
Gaussian-kernel weighted means over points within 3*bandwidth
(move/general, :478-607), sequential mode suppression within one
bandwidth (supress, :537-556), and nearest-seed label assignment
(classify + KD-tree Decide, :440-445, :683-705).

The per-seed kernel means are one [seeds, points] masked matrix product per
iteration — vectorized here instead of KD-tree walks; the mode-formation
pass stays an ordered host loop to reproduce the reference's sequential
suppression semantics (mode identity depends on seed order).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_BANDWIDTH = 0.005   # SomaticCaller.cs:1722
MAX_ITERATIONS = 100        # MeanShift.cs:279
TOLERANCE = 1e-3            # MeanShift.cs:280


@dataclass
class MeanShiftResult:
    modes: np.ndarray        # [K, D] density modes (cluster centers)
    seeds: np.ndarray        # [S, D] original seed positions
    seed_labels: np.ndarray  # [S] mode index per seed
    labels: np.ndarray       # [N] mode index per input point (nearest seed)

    @property
    def n_clusters(self) -> int:
        return len(self.modes)

    def decide(self, points: np.ndarray) -> np.ndarray:
        """Assign each point the mode of its nearest seed
        (MeanShiftClusterCollection.Decide semantics)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        d2 = np.sum((points[:, None, :] - self.seeds[None, :, :]) ** 2,
                    axis=2)
        return self.seed_labels[np.argmin(d2, axis=1)]


def _create_seeds(points: np.ndarray, bin_size: float) -> np.ndarray:
    """Occupied grid cells at resolution bin_size, first-seen order
    (MeanShift.cs:616-681; cell key = trunc(point / bin_size))."""
    keys = np.trunc(points / bin_size).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return keys[np.sort(first)].astype(np.float64) * bin_size


def mean_shift(points: np.ndarray,
               bandwidth: float = DEFAULT_BANDWIDTH,
               max_iterations: int = MAX_ITERATIONS,
               tolerance: float = TOLERANCE) -> MeanShiftResult:
    """Cluster [N, D] points; returns modes + labels for every point."""
    points = np.asarray(points, dtype=np.float64)
    if points.ndim != 2 or len(points) == 0:
        raise ValueError("mean_shift expects a non-empty [N, D] array")
    h2 = bandwidth * bandwidth
    radius2 = (3.0 * bandwidth) ** 2

    seeds = _create_seeds(points, 2.0 * bandwidth)
    current = seeds.copy()                              # [S, D]
    active = np.ones(len(seeds), dtype=bool)

    # batched hill climb: every seed climbs simultaneously; the Gaussian
    # kernel mean is exp(-d^2/2h^2) over points within 3h of the seed
    for _ in range(max_iterations):
        if not active.any():
            break
        cur = current[active]                           # [A, D]
        diff = points[None, :, :] - cur[:, None, :]     # [A, N, D]
        d2 = np.sum(diff * diff, axis=2)                # [A, N]
        w = np.where(d2 <= radius2, np.exp(-0.5 * d2 / h2), 0.0)
        wsum = w.sum(axis=1, keepdims=True)
        mean = np.where(wsum > 0, (w @ points) / np.maximum(wsum, 1e-300),
                        cur)
        shift = np.linalg.norm(mean - cur, axis=1)
        current[active] = mean
        still = shift >= tolerance * bandwidth
        active[np.flatnonzero(active)[~still]] = False

    # sequential mode suppression (order-dependent, as in the reference)
    modes: list[np.ndarray] = []
    seed_labels = np.zeros(len(seeds), dtype=np.int64)
    for i, pos in enumerate(current):
        assigned = -1
        for k, m in enumerate(modes):
            if np.linalg.norm(pos - m) < bandwidth:
                assigned = k
                break
        if assigned < 0:
            modes.append(pos.copy())
            assigned = len(modes) - 1
        seed_labels[i] = assigned

    mode_arr = np.array(modes) if modes else np.zeros((0, points.shape[1]))
    res = MeanShiftResult(mode_arr, seeds, seed_labels,
                          np.zeros(len(points), dtype=np.int64))
    res.labels = res.decide(points)
    return res


def pruned_centers(
    result: MeanShiftResult, window_labels: np.ndarray,
    coverage_scale: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Keep only clusters supported by 3 consecutive windows
    (findPrunedCenters, SomaticCaller.cs:2221-2253).  Returns
    (kept mode ids sorted, centroid coverages, centroid MAFs, sizes)."""
    lbl = np.asarray(window_labels)
    n = len(lbl)
    sizes = np.bincount(lbl[1:n - 1], minlength=result.n_clusters) \
        if n > 2 else np.zeros(result.n_clusters, dtype=np.int64)
    good: list[int] = []
    for i in range(1, n - 1):
        if lbl[i - 1] == lbl[i] == lbl[i + 1] and lbl[i] not in good:
            good.append(int(lbl[i]))
    good_sorted = sorted(good)
    cov = np.array([result.modes[k][0] * coverage_scale for k in good])
    maf = np.array([result.modes[k][1] for k in good])
    size = np.array([sizes[k] for k in good], dtype=np.int64)
    return np.array(good_sorted, dtype=np.int64), cov, maf, size
