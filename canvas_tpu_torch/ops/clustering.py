"""Segment clustering for the somatic caller.

  * Density-peak clustering (Rodriguez & Laio 2014) with the reference's
    exact Rho/Centroid semantics (CanvasCommon/DensityClusteringModel.cs):
    Gaussian local density over the pairwise distance matrix, centroid
    score = distance to the nearest higher-density point, clusters formed
    by rho-descending nearest-higher-density assignment, outliers flagged
    by the k-nearest-neighbour cutoff;
  * Gaussian mixture EM with fixed-count components seeded at model points
    (CanvasCommon/GaussianMixtureModel.cs): weighted posteriors, omega /
    mean / diagonal-covariance updates with the pairwise covariance
    anti-invasion scaling, and the silhouette coefficient used to choose
    the cluster count (SomaticCaller.ComputeSilhouette :897-951);
  * k-nearest-neighbour outlier cutoff (SomaticCaller :1546-1573).

All pairwise computations are dense numpy matrices (segment counts are
thousands at most).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from canvas_tpu_torch.ops import stats

OUTLIER_CLUSTER_FLAG = -10  # PloidyInfo.OutlierClusterFlag
RHO_CUTOFF = 2.0
NEIGHBOR_RATE = 0.02


def pairwise_distance(coverage: np.ndarray, maf: np.ndarray,
                      coverage_weight: float) -> np.ndarray:
    """Squared weighted distances [N, N]; NaN where either MAF < 0."""
    dc = (coverage[:, None] - coverage[None, :]) * coverage_weight
    d = dc * dc + (maf[:, None] - maf[None, :]) ** 2
    bad = (maf < 0)
    d[bad, :] = np.nan
    d[:, bad] = np.nan
    np.fill_diagonal(d, np.nan)
    return d


def knearest_neighbour_cutoff(coverage: np.ndarray, maf: np.ndarray,
                              coverage_weight: float, k: int = 10
                              ) -> tuple[np.ndarray, float]:
    """Sum of 10 nearest distances per segment and the 99th-percentile
    cutoff (SomaticCaller.KnearestNeighbourCutoff).  Uses the somatic
    GetModelDistance (2x coverage term when MAF missing)."""
    n = len(coverage)
    dc = ((coverage[:, None] - coverage[None, :]) * coverage_weight) ** 2
    dmaf = dc + (maf[:, None] - maf[None, :]) ** 2
    has = maf >= 0
    full = np.where(has[:, None] & has[None, :], dmaf, 2 * dc)
    np.fill_diagonal(full, np.inf)
    part = np.sort(full, axis=1)[:, :k]
    knn = part.sum(axis=1)
    cutoff = np.sort(knn)[int(n * 0.99)] if n else np.inf
    return knn, float(cutoff)


@dataclass
class DensityClusteringResult:
    cluster_ids: np.ndarray          # int; OUTLIER_CLUSTER_FLAG for outliers
    n_clusters: int
    centroids_maf: list[float]
    centroids_coverage: list[float]
    rho: np.ndarray
    delta: np.ndarray


def density_cluster(
    coverage: np.ndarray, maf: np.ndarray, weight: np.ndarray,
    coverage_weight: float, knn_cutoff: float, centroid_cutoff: float,
    rho_cutoff: float = RHO_CUTOFF,
) -> DensityClusteringResult:
    """DensityClusteringModel: EstimateDc + GaussianLocalDensity +
    FindCentroids + FindClusters."""
    n = len(coverage)
    d2 = pairwise_distance(coverage, maf, coverage_weight)
    valid = np.isfinite(d2)
    dist_vals = d2[np.triu_indices(n, 1)]
    dist_vals = dist_vals[np.isfinite(dist_vals)]
    if len(dist_vals) == 0:
        raise ValueError("Empty Distance Array!")
    dc = float(np.percentile(dist_vals, 100 * (1 - NEIGHBOR_RATE),
                             method="lower"))
    # Gaussian local density
    with np.errstate(over="ignore"):
        half = np.where(valid, np.exp(-((d2 / max(dc, 1e-300)) ** 2)), 0.0)
    rho = half.sum(axis=1)

    # delta: distance to nearest higher-density point (ties by index order
    # follow the reference's strict > comparisons)
    delta = np.zeros(n)
    maximum = np.zeros(n)
    for i in range(n):
        higher = (rho > rho[i]) & valid[i]
        if higher.any():
            delta[i] = np.min(d2[i][higher])
        vals = d2[i][valid[i] & ~higher]
        maximum[i] = np.max(vals) if len(vals) else 0.0
    delta = np.where(delta == 0, maximum, delta)

    # centroids
    is_centroid = (rho > rho_cutoff) & (delta > centroid_cutoff) & (maf >= 0)
    centroid_idx = np.flatnonzero(is_centroid)
    cluster_ids = np.zeros(n, dtype=np.int64)
    cmafs, ccovs = [], []
    for rank, ci in enumerate(centroid_idx):
        cluster_ids[ci] = rank + 1
        cmafs.append(float(maf[ci]))
        ccovs.append(float(coverage[ci]))

    knn, _ = knearest_neighbour_cutoff(coverage, maf, coverage_weight)
    order = np.argsort(-rho, kind="stable")
    assigned = np.zeros(n, dtype=bool)
    assigned[centroid_idx] = True
    for i in order:
        if i in centroid_idx:
            continue
        higher = (rho > rho[i]) & (maf >= 0)
        if higher.any():
            cand = np.where(higher, np.where(np.isfinite(d2[i]), d2[i], np.inf),
                            np.inf)
            j = int(np.argmin(cand))
            if maf[i] >= 0:
                cluster_ids[i] = cluster_ids[j]
        if cluster_ids[i] == 0 or maf[i] < 0 or knn[i] > knn_cutoff:
            cluster_ids[i] = OUTLIER_CLUSTER_FLAG
    return DensityClusteringResult(cluster_ids, len(centroid_idx),
                                   cmafs, ccovs, rho, delta)


# ---------------------------------------------------------------------------
# Gaussian mixture EM
# ---------------------------------------------------------------------------

@dataclass
class GmmComponent:
    mu: np.ndarray          # [2] = (maf, coverage)
    sigma: np.ndarray       # [2, 2]
    omega: float


def _gauss2(maf, cov, comp: GmmComponent) -> np.ndarray:
    s = comp.sigma
    det = s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]
    dx = maf - comp.mu[0]
    dy = cov - comp.mu[1]
    expo = -0.5 * (s[1, 1] / det * dx * dx
                   - s[0, 1] / det * dx * dy
                   - s[1, 0] / det * dx * dy
                   + s[0, 0] / det * dy * dy)
    with np.errstate(over="ignore", invalid="ignore"):
        lik = np.where(np.isnan(expo), 0.0,
                       1.0 / (2 * np.pi * np.sqrt(det)) * np.exp(expo))
    return np.where(np.isnan(lik), 0.0, lik)


def gmm_em(
    init_maf: np.ndarray, init_cov: np.ndarray,
    seg_maf: np.ndarray, seg_cov: np.ndarray, seg_weight: np.ndarray,
    coverage_weight: float, knn: np.ndarray, knn_cutoff: float,
    update_means: bool = True,
    n_iterations: int = 30,
    likelihood_cutoff: float = 0.000025,
    post_prob_thres: float = 0.01,
    omega_thres: float = 0.01,
):
    """runExpectationMaximization / FitGaussians (update_means=False for the
    Fit() variant that keeps component means at the model points).

    Returns (components, posterior [N, K], cluster_ids, likelihood)."""
    k = len(init_maf)
    comps = [GmmComponent(np.array([init_maf[j], init_cov[j]], float),
                          np.array([[0.01, 0.0],
                                    [0.0, 0.01 / coverage_weight ** 2]]),
                          1.0 / k) for j in range(k)]
    outlier = knn > knn_cutoff
    ok = ~outlier
    likelihood, prev = 0.0, -1.0
    post = np.zeros((len(seg_maf), k))
    for it in range(n_iterations):
        # E-step
        dens = np.stack([c.omega * _gauss2(seg_maf, seg_cov, c)
                         for c in comps], axis=1)     # [N, K]
        z = dens.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore"):
            post = np.where(z > 0, dens / z, 0.0)
        post[outlier] = 0.0
        # omegas
        sw = seg_weight[ok].sum()
        for j, c in enumerate(comps):
            c.omega = float(np.sum(post[ok, j] * seg_weight[ok]) / sw)
        # means
        if update_means:
            for j, c in enumerate(comps):
                if c.omega < omega_thres:
                    continue
                use = ok & (post[:, j] >= post_prob_thres)
                w = post[use, j] * seg_weight[use]
                if w.sum() <= 0:
                    continue
                c.mu = np.array([np.sum(w * seg_maf[use]) / w.sum(),
                                 np.sum(w * seg_cov[use]) / w.sum()])
        # covariances (uncorrelated)
        for j, c in enumerate(comps):
            use = ok & (post[:, j] >= post_prob_thres)
            w = post[use, j] * seg_weight[use]
            if w.sum() > 0:
                dx = seg_maf[use] - c.mu[0]
                dy = seg_cov[use] - c.mu[1]
                s00 = float(np.sum(w * dx * dx) / w.sum())
                s11 = float(np.sum(w * dy * dy) / w.sum())
                c.sigma = np.array([[max(s00, 1e-7), 0.0],
                                    [0.0, max(s11, 1e-7)]])
        _scale_covariances_pairwise(comps)
        # likelihood
        dens = np.stack([
            np.where(seg_maf == -1, c.omega,
                     c.omega * _gauss2(seg_maf, seg_cov, c))
            for c in comps], axis=1)
        tot = dens[ok].sum(axis=1)
        with np.errstate(divide="ignore"):
            likelihood = float(np.sum(np.log(tot) * seg_weight[ok])
                               / seg_weight.sum())
        if abs(likelihood - prev) < likelihood_cutoff and it > 1:
            break
        prev = likelihood
    cluster_ids = np.where(outlier, OUTLIER_CLUSTER_FLAG,
                           np.argmax(post, axis=1) + 1)
    return comps, post, cluster_ids, likelihood


def _scale_covariances_pairwise(comps: list[GmmComponent]) -> None:
    """EMScaleCovariancesPairwise: shrink a component whose covariance
    determinant dwarfs its most-confusable neighbour's."""
    for i, c1 in enumerate(comps):
        max_prob, max_j = 0.0, None
        for j, c2 in enumerate(comps):
            if i == j:
                continue
            prob = c2.omega * float(_gauss2(
                np.array([c1.mu[0]]), np.array([c1.mu[1]]), c2)[0])
            if prob > max_prob:
                max_prob, max_j = prob, j
        if max_j is None or max_prob <= 0:
            continue
        s1, s2 = c1.sigma, comps[max_j].sigma
        det1 = s1[0, 0] * s1[1, 1] - s1[0, 1] * s1[1, 0]
        det2 = s2[0, 0] * s2[1, 1] - s2[0, 1] * s2[1, 0]
        if det1 <= 1e-7 or det2 <= 1e-7:
            continue
        ratio = det1 / det2 if det1 > det2 else det2 / det1
        if ratio < 4:
            continue
        if det1 > det2:
            c1.sigma = s1 * 0.8
            comps[max_j].sigma = s2 * 1.1
        else:
            comps[max_j].sigma = s2 * 0.8
            c1.sigma = s1 * 1.1


def silhouette(
    seg_maf: np.ndarray, seg_cov: np.ndarray, cluster_ids: np.ndarray,
    coverage_weight: float, n_clusters: int,
) -> float:
    """ComputeSilhouette (SomaticCaller.cs:897-951): median within- vs
    between-cluster distances, averaged over clusters."""
    use = (cluster_ids > 0) & (seg_maf >= 0)
    maf, cov, cid = seg_maf[use], seg_cov[use], cluster_ids[use]
    if len(maf) == 0:
        return 0.0
    dc = ((cov[:, None] - cov[None, :]) * coverage_weight) ** 2
    d = dc + (maf[:, None] - maf[None, :]) ** 2
    coeff = 0.0
    for k in range(1, n_clusters + 1):
        within_mask = (cid[:, None] == k) & (cid[None, :] == k)
        np.fill_diagonal(within_mask, False)
        between_mask = (cid[:, None] == k) & (cid[None, :] != k)
        wvals = d[within_mask].astype(np.float32)
        bvals = d[between_mask].astype(np.float32)
        if len(wvals) > 2 and len(bvals) > 2:
            a = stats.median(wvals)
            b = stats.median(bvals)
            coeff += (b - a) / max(a, b)
    return coeff / n_clusters
