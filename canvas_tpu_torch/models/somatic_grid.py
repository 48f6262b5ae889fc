"""Vectorized somatic purity/ploidy grid — all models evaluated at once.

The reference evaluates ~10^4 (coverage, purity) models in a scalar loop,
each scanning all segments (SomaticCaller.cs:1899-1933).  Here the whole
grid is a batched tensor computation over [models, points, segments]:
model-point construction (with the batched AdjustedMAF), RefineDiploidMAF,
the two assignment passes of ModelDeviation, the per-point empirical
centroids (accuracy deviation), CN profiles (diploid/inter-model
distances), and the cluster-deviation branch.

Two backends share the same math: the float64 numpy oracle
(evaluate_grid_numpy, bit-faithful to somatic.model_deviation /
diploid_model_distance run per model) and the float64 torch path
(evaluate_grid_device, the [M, N, P] distance tensor in chunks of models on
the run's device).  evaluate_grid takes the torch path on a CUDA device and
the numpy oracle on the CPU; a failure on the card raises.
"""

from __future__ import annotations

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.models import somatic as som

# evaluate_grid's calls by path, "device" (torch) or "numpy"; read by
# chip_smoke.py to show which path a run took
CALLS = {"device": 0, "numpy": 0}


def build_grid_points(
    coverages: np.ndarray, purities: np.ndarray,
    ploidies: list[som.PloidyState],
):
    """Model points for every grid model: [M, P] coverages/MAFs."""
    cn = np.array([p.copy_number for p in ploidies], dtype=np.float64)
    major = np.array([p.major_count for p in ploidies], dtype=np.float64)
    th = coverages * purities / 2.0                      # [M]
    nh = coverages * (1.0 - purities) / 2.0
    pt_cov = cn[None, :] * th[:, None] + 2 * nh[:, None]  # [M, P]
    theoretical = (cn - major)[None, :] * th[:, None] + nh[:, None]
    M, P = pt_cov.shape
    pt_maf = som.adjusted_maf_batch(
        theoretical.reshape(-1), pt_cov.reshape(-1)).reshape(M, P)
    return pt_cov, pt_maf, cn.astype(np.int64), major.astype(np.int64)


def evaluate_grid(
    coverages: np.ndarray,        # [M]
    purities: np.ndarray,         # [M]
    infos: list[som.SegmentInfo],
    ploidies: list[som.PloidyState],
    coverage_weight: float,
    genome_length: int,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
    chunk: int | None = None,
    device: str | torch.device = "cuda",
):
    """Evaluate every model.  Returns dict of [M] arrays:
    deviation, precision, accuracy, ploidy, percent_cn2, percent_normal,
    diploid_distance, heterogeneity_index, plus cns [M, N] int16.

    On a CUDA device the float64 torch path (evaluate_grid_device), on the
    CPU the float64 numpy oracle (see the module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        CALLS["device"] += 1
        return evaluate_grid_device(
            coverages, purities, infos, ploidies, coverage_weight,
            genome_length, cluster_ids, n_clusters, mean_coverage, chunk,
            device=dev)
    CALLS["numpy"] += 1
    return evaluate_grid_numpy(
        coverages, purities, infos, ploidies, coverage_weight,
        genome_length, cluster_ids, n_clusters, mean_coverage,
        chunk if chunk is not None else 256)


def evaluate_grid_numpy(
    coverages: np.ndarray,        # [M]
    purities: np.ndarray,         # [M]
    infos: list[som.SegmentInfo],
    ploidies: list[som.PloidyState],
    coverage_weight: float,
    genome_length: int,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
    chunk: int = 256,
):
    """Float64 host oracle (see evaluate_grid)."""
    seg_cov = np.array([i.coverage for i in infos])
    seg_maf = np.array([i.maf for i in infos])
    seg_w = np.array([i.weight for i in infos])
    seg_len = np.array([i.segment.length for i in infos], dtype=np.float64)
    has_maf = seg_maf >= 0
    total_w = seg_w.sum()
    N = len(infos)
    M = len(coverages)
    cw = coverage_weight

    pt_cov_all, pt_maf_all, pt_cn, pt_major = build_grid_points(
        coverages, purities, ploidies)
    P = pt_cov_all.shape[1]
    balanced = (pt_cn % 2 == 0) & (pt_major * 2 == pt_cn)
    n_lv = 1 + som.MAX_COPY_NUMBER // 2
    lv_of_point = (pt_cn // 2)

    use_clusters = (cluster_ids is not None and n_clusters
                    and mean_coverage is not None
                    and int(np.count_nonzero(has_maf)) > 100 and N > 100
                    and n_clusters < 10)
    if use_clusters:
        cid = np.asarray(cluster_ids)
        cluster_onehot = np.stack(
            [cid == k + 1 for k in range(n_clusters)], axis=1)  # [N, K]
        mcc_frac = np.where((pt_major == 0) & (pt_cn == 0), 0.0,
                            pt_major / np.maximum(pt_cn, 1))    # [P]
        distinct_mcc = np.unique(mcc_frac)

    out = {k: np.zeros(M) for k in
           ("deviation", "precision", "accuracy", "ploidy", "percent_cn2",
            "percent_normal", "diploid_distance", "het_index")}
    out["cns"] = np.zeros((M, N), dtype=np.int16)
    out["percent_cn"] = np.zeros((M, som.MAX_COPY_NUMBER + 1))

    dummy_weight = 1e7
    for m0 in range(0, M, chunk):
        m1 = min(m0 + chunk, M)
        mc = m1 - m0
        pt_cov = pt_cov_all[m0:m1]                         # [mc, P]
        pt_maf = pt_maf_all[m0:m1].copy()

        def distances(maf_pts):
            dc = ((seg_cov[None, :, None] - pt_cov[:, None, :]) * cw) ** 2
            dm = dc + (seg_maf[None, :, None] - maf_pts[:, None, :]) ** 2
            return np.where(has_maf[None, :, None], dm, 2 * dc)  # [mc,N,P]

        # --- RefineDiploidMAF (two-pass) ---
        d = distances(pt_maf)
        best = np.argmin(d, axis=2)                        # [mc, N]
        m_sum = np.zeros((mc, n_lv))
        m_w = np.zeros((mc, n_lv))
        for k in np.flatnonzero(balanced):
            m_sum[:, lv_of_point[k]] += dummy_weight * pt_maf[:, k]
            m_w[:, lv_of_point[k]] += dummy_weight
        contrib = has_maf[None, :] & (seg_maf >= 0.4)[None, :] \
            & balanced[best]
        for lv in range(n_lv):
            sel = contrib & (lv_of_point[best] == lv)
            m_sum[:, lv] += np.sum(np.where(sel, seg_w * seg_maf, 0.0), axis=1)
            m_w[:, lv] += np.sum(np.where(sel, seg_w, 0.0), axis=1)
        for k in np.flatnonzero(balanced):
            pt_maf[:, k] = m_sum[:, lv_of_point[k]] / m_w[:, lv_of_point[k]]

        # --- assignment pass ---
        d = distances(pt_maf)
        best = np.argmin(d, axis=2)                        # [mc, N]
        best_d = np.sqrt(np.take_along_axis(d, best[..., None], axis=2)[..., 0])
        precision = np.sum(best_d * seg_w[None], axis=1) / total_w

        best_cn = pt_cn[best]                              # [mc, N]
        onehot_p = best[..., None] == np.arange(P)[None, None]  # [mc,N,P]
        w_per_point = np.sum(onehot_p * seg_w[None, :, None], axis=1)
        pc = np.zeros((mc, som.MAX_COPY_NUMBER + 1))
        for c in range(som.MAX_COPY_NUMBER + 1):
            pc[:, c] = np.sum(np.where(best_cn == c, seg_w[None], 0.0), axis=1)
        is_normal = (best_cn == 2) & (pt_major[best] == 1)
        percent_normal = np.sum(np.where(is_normal, seg_w[None], 0.0), axis=1) \
            / total_w
        cns = np.where((best_cn == 2) & (pt_major[best] == 2), 1, best_cn)

        # --- accuracy deviation (empirical centroids) ---
        wsum = np.maximum(w_per_point, 1e-300)             # [mc, P]
        emp_cov = np.sum(onehot_p * (seg_w * seg_cov)[None, :, None], axis=1) \
            / wsum
        mw = np.sum(onehot_p * np.where(has_maf, seg_w, 0.0)[None, :, None],
                    axis=1)
        emp_maf = np.divide(
            np.sum(onehot_p * np.where(has_maf, seg_w * seg_maf,
                                       0.0)[None, :, None], axis=1),
            np.maximum(mw, 1e-300))
        emp_maf = np.where(mw > 0, emp_maf, 0.0)
        dist_pt = np.sqrt(((pt_cov - emp_cov) * cw) ** 2
                          + (pt_maf - emp_maf) ** 2)
        accuracy = np.sum(np.where(w_per_point > 0, dist_pt * w_per_point,
                                   0.0), axis=1) / total_w

        pc /= total_w
        ploidy = pc @ np.arange(som.MAX_COPY_NUMBER + 1, dtype=np.float64)
        temp_dev = 0.5 * precision + 0.5 * accuracy
        deviation = temp_dev.copy()
        het_index = np.zeros(mc)

        # --- cluster deviation ---
        if use_clusters:
            pts_ok = pt_cov < mean_coverage * 2.0          # [mc, P]
            d_masked = np.where(pts_ok[:, None, :], d, np.inf)
            cbest = np.argmin(d_masked, axis=2)
            cbest_d = np.sqrt(np.take_along_axis(
                d_masked, cbest[..., None], axis=2)[..., 0])
            cbest_mcc = mcc_frac[cbest]                    # [mc, N]
            sizes = cluster_onehot.sum(axis=0)             # [K]
            mean_dist = np.stack([
                np.where(sizes[k] > 0,
                         np.sum(np.where(cluster_onehot[:, k][None],
                                         cbest_d, 0.0), axis=1)
                         / max(sizes[k], 1), 0.0)
                for k in range(n_clusters)], axis=1)       # [mc, K]
            med_cols = []
            for k in range(n_clusters):
                if sizes[k] == 0:   # empty cluster: nanmedian would warn
                    med_cols.append(np.zeros(mc))
                    continue
                med_cols.append(np.nanmedian(
                    np.where(cluster_onehot[:, k][None], cbest_d, np.nan),
                    axis=1))
            med_dist = np.nan_to_num(np.stack(med_cols, axis=1))
            entropy = np.zeros((mc, n_clusters))
            for k in range(n_clusters):
                if sizes[k] == 0:
                    continue
                nk = sizes[k]
                for v in distinct_mcc:
                    if v <= 0:
                        continue
                    present = np.any(
                        cluster_onehot[:, k][None]
                        & np.isclose(cbest_mcc, v), axis=1)
                    p_v = v / nk
                    entropy[:, k] += np.where(present,
                                              -p_v * np.log(p_v), 0.0)
            # fully-masked clusters carry float-max distances
            # (nan_to_num above); their mean/median overflows to inf with
            # C# double IEEE semantics — the model just scores unusably
            # bad — so the overflow is expected, not an error
            with np.errstate(over="ignore"):
                cdev = mean_dist.mean(axis=1)
                med_dist_all = np.median(med_dist, axis=1)
            med_ent_all = np.median(entropy, axis=1)
            n_het = np.sum((med_dist > med_dist_all[:, None])
                           & (entropy > med_ent_all[:, None]), axis=1)
            het_index = n_het / n_clusters
            trigger = n_het > som.HETEROGENEOUS_CLUSTERS_CUTOFF
            deviation = np.where(
                trigger,
                som.PRECISION_WEIGHTING_FACTOR * (precision + accuracy + cdev),
                temp_dev)

        # --- diploid model distance ---
        amp = pc[:, 3:som.MAX_COPY_NUMBER].sum(axis=1)
        baseline = np.where(amp > 0.8, 4, 2)
        extra = np.where(amp > 0.8, 1.0, 0.0)
        events = extra + np.sum(
            np.abs(cns - baseline[:, None]) * seg_len[None], axis=1) \
            / genome_length
        dd = 1.0 / np.maximum(0.001, events)

        sl = slice(m0, m1)
        out["deviation"][sl] = deviation
        out["precision"][sl] = precision
        out["accuracy"][sl] = accuracy
        out["ploidy"][sl] = ploidy
        out["percent_cn"][sl] = pc
        out["percent_cn2"][sl] = pc[:, 2]
        out["percent_normal"][sl] = percent_normal
        out["diploid_distance"][sl] = dd
        out["het_index"][sl] = het_index
        out["cns"][sl] = cns
    return out


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as numpy takes it: the mean of the two
    middle values for an even count (torch.median takes the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) / 2


def evaluate_grid_device(
    coverages: np.ndarray,        # [M]
    purities: np.ndarray,         # [M]
    infos: list[som.SegmentInfo],
    ploidies: list[som.PloidyState],
    coverage_weight: float,
    genome_length: int,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
    chunk: int | None = None,
    device: str | torch.device = "cuda",
):
    """The grid as float64 torch on `device`: evaluate_grid_numpy's steps
    one for one, over chunks of models.  Per-point sums over segments are
    one-hot contractions (batched float64 products, no atomics, no TF32),
    so the CN assignments and the chosen model equal the numpy oracle's and
    the floats agree to rounding."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    seg_cov_np = np.array([i.coverage for i in infos])
    seg_maf_np = np.array([i.maf for i in infos])
    seg_w_np = np.array([i.weight for i in infos])
    seg_len_np = np.array([i.segment.length for i in infos], dtype=np.float64)
    has_maf_np = seg_maf_np >= 0
    N = len(infos)
    M = len(coverages)
    cw = coverage_weight

    pt_cov_all, pt_maf_all, pt_cn_np, pt_major_np = build_grid_points(
        coverages, purities, ploidies)
    P = pt_cov_all.shape[1]
    balanced_np = (pt_cn_np % 2 == 0) & (pt_major_np * 2 == pt_cn_np)
    n_lv = 1 + som.MAX_COPY_NUMBER // 2
    lv_np = pt_cn_np // 2

    use_clusters = (cluster_ids is not None and n_clusters
                    and mean_coverage is not None
                    and int(np.count_nonzero(has_maf_np)) > 100 and N > 100
                    and n_clusters < 10)

    seg_cov = torch.as_tensor(seg_cov_np, **f64)
    seg_maf = torch.as_tensor(seg_maf_np, **f64)
    seg_w = torch.as_tensor(seg_w_np, **f64)
    seg_len = torch.as_tensor(seg_len_np, **f64)
    has_maf = torch.as_tensor(has_maf_np, device=dev)
    total_w = seg_w.sum()
    pt_cn = torch.as_tensor(pt_cn_np, device=dev)
    pt_major = torch.as_tensor(pt_major_np, device=dev)
    balanced = torch.as_tensor(balanced_np, device=dev)
    lv_of_point = torch.as_tensor(lv_np, device=dev)
    bal_idx = np.flatnonzero(balanced_np)
    point_ids = torch.arange(P, device=dev)
    levels = torch.arange(n_lv, device=dev)
    if use_clusters:
        cid = np.asarray(cluster_ids)
        mcc_np = np.where((pt_major_np == 0) & (pt_cn_np == 0), 0.0,
                          pt_major_np / np.maximum(pt_cn_np, 1))
        mcc_frac = torch.as_tensor(mcc_np, **f64)
        distinct_mcc = np.unique(mcc_np)
        members = [torch.as_tensor(np.flatnonzero(cid == k + 1), device=dev)
                   for k in range(n_clusters)]

    if chunk is None:
        # keep the [chunk, N, P] float64 tensors near 1 GB each
        chunk = max(64, min(1 << max(M - 1, 0).bit_length(),
                            120_000_000 // max(1, N * P)))

    out = {k: np.zeros(M) for k in
           ("deviation", "precision", "accuracy", "ploidy", "percent_cn2",
            "percent_normal", "diploid_distance", "het_index")}
    out["cns"] = np.zeros((M, N), dtype=np.int16)
    out["percent_cn"] = np.zeros((M, som.MAX_COPY_NUMBER + 1))

    dummy_weight = 1e7
    for m0 in range(0, M, chunk):
        m1 = min(m0 + chunk, M)
        mc = m1 - m0
        pt_cov = torch.as_tensor(pt_cov_all[m0:m1], **f64)      # [mc, P]
        pt_maf = torch.as_tensor(pt_maf_all[m0:m1], **f64)

        def distances(maf_pts):
            dc = ((seg_cov[None, :, None] - pt_cov[:, None, :]) * cw) ** 2
            dm = dc + (seg_maf[None, :, None] - maf_pts[:, None, :]) ** 2
            return torch.where(has_maf[None, :, None], dm, 2 * dc)

        # --- RefineDiploidMAF (two-pass) ---
        d = distances(pt_maf)
        best = torch.argmin(d, dim=2)                            # [mc, N]
        m_sum = torch.zeros((mc, n_lv), **f64)
        m_w = torch.zeros((mc, n_lv), **f64)
        for k in bal_idx:
            m_sum[:, lv_np[k]] += dummy_weight * pt_maf[:, k]
            m_w[:, lv_np[k]] += dummy_weight
        contrib = has_maf[None, :] & (seg_maf >= 0.4)[None, :] \
            & balanced[best]
        lv_best = lv_of_point[best]
        sel = contrib[..., None] & (lv_best[..., None] == levels)  # [mc,N,lv]
        m_sum += torch.einsum("mnl,n->ml", sel.to(torch.float64),
                              seg_w * seg_maf)
        m_w += torch.einsum("mnl,n->ml", sel.to(torch.float64), seg_w)
        for k in bal_idx:
            pt_maf[:, k] = m_sum[:, lv_np[k]] / m_w[:, lv_np[k]]

        # --- assignment pass ---
        d = distances(pt_maf)
        best = torch.argmin(d, dim=2)                            # [mc, N]
        best_d = torch.sqrt(torch.gather(d, 2, best[..., None])[..., 0])
        precision = (best_d * seg_w[None]).sum(dim=1) / total_w

        best_cn = pt_cn[best]                                    # [mc, N]
        onehot_p = (best[..., None] == point_ids).to(torch.float64)
        w_per_point = torch.einsum("mnp,n->mp", onehot_p, seg_w)
        pc = torch.stack([torch.where(best_cn == c, seg_w[None], 0.0)
                          .sum(dim=1)
                          for c in range(som.MAX_COPY_NUMBER + 1)], dim=1)
        is_normal = (best_cn == 2) & (pt_major[best] == 1)
        percent_normal = torch.where(is_normal, seg_w[None], 0.0) \
            .sum(dim=1) / total_w
        cns = torch.where((best_cn == 2) & (pt_major[best] == 2), 1, best_cn)

        # --- accuracy deviation (empirical centroids) ---
        wsum = torch.clamp(w_per_point, min=1e-300)
        emp_cov = torch.einsum("mnp,n->mp", onehot_p, seg_w * seg_cov) / wsum
        w_maf = torch.where(has_maf, seg_w, 0.0)
        mw = torch.einsum("mnp,n->mp", onehot_p, w_maf)
        emp_maf = torch.einsum("mnp,n->mp", onehot_p,
                               torch.where(has_maf, seg_w * seg_maf, 0.0)) \
            / torch.clamp(mw, min=1e-300)
        emp_maf = torch.where(mw > 0, emp_maf, 0.0)
        dist_pt = torch.sqrt(((pt_cov - emp_cov) * cw) ** 2
                             + (pt_maf - emp_maf) ** 2)
        accuracy = torch.where(w_per_point > 0, dist_pt * w_per_point,
                               0.0).sum(dim=1) / total_w

        pc = pc / total_w
        ploidy = pc @ torch.arange(som.MAX_COPY_NUMBER + 1, **f64)
        temp_dev = 0.5 * precision + 0.5 * accuracy
        deviation = temp_dev
        het_index = torch.zeros(mc, **f64)

        # --- cluster deviation ---
        if use_clusters:
            pts_ok = pt_cov < mean_coverage * 2.0                # [mc, P]
            d_masked = torch.where(pts_ok[:, None, :], d, torch.inf)
            cbest = torch.argmin(d_masked, dim=2)
            cbest_d = torch.sqrt(
                torch.gather(d_masked, 2, cbest[..., None])[..., 0])
            cbest_mcc = mcc_frac[cbest]                          # [mc, N]
            zeros = torch.zeros(mc, **f64)
            mean_cols, med_cols, ent_cols = [], [], []
            for k in range(n_clusters):
                idx = members[k]
                nk = len(idx)
                if nk == 0:
                    mean_cols.append(zeros)
                    med_cols.append(zeros)
                    ent_cols.append(zeros)
                    continue
                vals = cbest_d[:, idx]                           # [mc, nk]
                mean_cols.append(vals.sum(dim=1) / nk)
                med_cols.append(_median_last(vals))
                ent = zeros
                for v in distinct_mcc:
                    if v <= 0:
                        continue
                    present = torch.isclose(
                        cbest_mcc[:, idx],
                        torch.tensor(v, **f64)).any(dim=1)
                    p_v = v / nk
                    ent = ent + torch.where(present, -p_v * np.log(p_v), 0.0)
                ent_cols.append(ent)
            mean_dist = torch.stack(mean_cols, dim=1)            # [mc, K]
            med_dist = torch.nan_to_num(torch.stack(med_cols, dim=1))
            entropy = torch.stack(ent_cols, dim=1)
            cdev = mean_dist.mean(dim=1)
            med_dist_all = _median_last(med_dist)
            med_ent_all = _median_last(entropy)
            n_het = ((med_dist > med_dist_all[:, None])
                     & (entropy > med_ent_all[:, None])).sum(dim=1)
            het_index = n_het / n_clusters
            trigger = n_het > som.HETEROGENEOUS_CLUSTERS_CUTOFF
            deviation = torch.where(
                trigger,
                som.PRECISION_WEIGHTING_FACTOR * (precision + accuracy + cdev),
                temp_dev)

        # --- diploid model distance ---
        amp = pc[:, 3:som.MAX_COPY_NUMBER].sum(dim=1)
        baseline = torch.where(amp > 0.8, 4, 2)
        extra = torch.where(amp > 0.8, 1.0, 0.0)
        events = extra + (torch.abs(cns - baseline[:, None]) * seg_len[None]
                          ).sum(dim=1) / genome_length
        dd = 1.0 / torch.clamp(events, min=0.001)

        sl = slice(m0, m1)
        host = lambda t: t.cpu().numpy()
        out["deviation"][sl] = host(deviation)
        out["precision"][sl] = host(precision)
        out["accuracy"][sl] = host(accuracy)
        out["ploidy"][sl] = host(ploidy)
        out["percent_cn"][sl] = host(pc)
        out["percent_cn2"][sl] = host(pc[:, 2])
        out["percent_normal"][sl] = host(percent_normal)
        out["diploid_distance"][sl] = host(dd)
        out["het_index"][sl] = host(het_index)
        out["cns"][sl] = host(cns)
    return out
