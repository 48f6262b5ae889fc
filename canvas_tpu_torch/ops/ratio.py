"""Tumor/normal ratio normalization (CanvasNormalize).

Reference generators build a control coverage track from normal samples:
  * weighted average of controls, weights 1/median, normalized to sum 1
    (WeightedAverageReferenceGenerator.cs:28-71);
  * BestLR2 — the single control minimizing mean squared log2 ratio vs the
    tumor (BestLR2ReferenceGenerator.cs:33-93);
  * PCA — project the centered sample onto model axes and rescale by the
    median ratio (PCAReferenceGenerator.cs:33-148).

Ratio calculators:
  * LSNorm: ratio * (refMedian / sampleMedian), skipping reference bins
    with count < 1 (LSNormRatioCalculator.cs:21-49);
  * Raw: plain ratio with [min, max] reference-count gates
    (RawRatioCalculator.cs:23-48).

Ratios become pseudo-counts: count = ratio * 40 * ploidy/2
(CanvasNormalizeUtilities.cs:13-32, CanvasDiploidBinRatioFactor = 40).
"""

from __future__ import annotations

import numpy as np

from canvas_tpu_torch.io.bins import BinSet
from canvas_tpu_torch.ops import stats

DIPLOID_BIN_RATIO_FACTOR = 40.0


def weighted_average_reference(controls: list[BinSet]) -> BinSet:
    """Merge control samples into a reference track (weights 1/median)."""
    if len(controls) == 1:
        return controls[0]
    weights = np.empty(len(controls))
    for i, c in enumerate(controls):
        med = stats.median(c.count)
        weights[i] = 1.0 / med if med > 0 else 0.0
    weights /= weights.sum()
    counts = np.zeros(len(controls[0]), dtype=np.float64)
    for w, c in zip(weights, controls):
        counts += w * c.count.astype(np.float64)
    return controls[0].with_count(counts.astype(np.float32))


def best_lr2_reference(tumor: BinSet, controls: list[BinSet]) -> BinSet:
    """Pick the control minimizing mean squared log2 ratio vs the tumor
    (BestLR2ReferenceGenerator.cs:33-93)."""
    best, best_lr2 = None, np.inf
    t = tumor.count.astype(np.float64)
    for c in controls:
        r = c.count.astype(np.float64)
        ok = (t > 0) & (r > 0)
        if not ok.any():
            continue
        lr2 = np.mean(np.log2(t[ok] / r[ok]) ** 2)
        if lr2 < best_lr2:
            best_lr2, best = lr2, c
    assert best is not None, "no usable control sample"
    return best


def pca_reference(tumor: BinSet, axes: np.ndarray, mu: np.ndarray,
                  min_ref: float = 1.0, max_ref: float = np.inf) -> BinSet:
    """Project the centered tumor counts onto PCA model axes
    (PCAReferenceGenerator.Run, :33-70): counts floored at 1, ref =
    max(1, mu + sum_i axis_i (axis_i . (x - mu))), then multiplied by the
    median raw ratio over reference bins within [min_ref, max_ref]."""
    x = np.maximum(tumor.count.astype(np.float64), 1.0)
    centered = x - mu
    # axes: [n_axes, n_bins]; Project (Utilities.Project)
    proj = axes.T @ (axes @ centered)
    ref = np.maximum(mu + proj, 1.0)
    ok = (ref >= min_ref) & (ref <= max_ref)
    if ok.any():
        median_ratio = stats.median((x[ok] / ref[ok]).astype(np.float32))
        ref = ref * median_ratio
    return tumor.with_count(ref.astype(np.float32))


def load_pca_model(path) -> tuple[list[tuple[str, int, int]], np.ndarray,
                                  np.ndarray]:
    """PCA model file (PCAReferenceGenerator.PCAModel.LoadModel, :97-133):
    gzipped TSV 'chrom start stop mean axis1 axis2 ...'.  Axes are 2-norm
    normalized and must be mutually orthogonal.  Returns (bin keys, mu,
    axes[n_axes, n_bins])."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    keys: list[tuple[str, int, int]] = []
    mu: list[float] = []
    axes_cols: list[list[float]] = []
    with opener(str(path), "rt") as f:
        for line in f:
            toks = line.rstrip("\n").split("\t")
            if len(toks) < 4:
                continue
            if not axes_cols:
                axes_cols = [[] for _ in range(len(toks) - 4)]
            keys.append((toks[0], int(toks[1]), int(toks[2])))
            mu.append(float(toks[3]))
            for i in range(len(axes_cols)):
                axes_cols[i].append(float(toks[i + 4]))
    axes = np.asarray(axes_cols, dtype=np.float64)
    norms = np.linalg.norm(axes, axis=1, keepdims=True)
    axes = axes / np.where(norms == 0, 1.0, norms)
    gram = axes @ axes.T
    off = gram - np.diag(np.diag(gram))
    if np.abs(off).max(initial=0.0) > 1e-6:
        raise ValueError(f"Axes are not orthogonal to each other in {path}")
    return keys, np.asarray(mu, dtype=np.float64), axes


def lsnorm_ratios(sample: BinSet, reference: BinSet) -> BinSet:
    """Library-size-normalized ratios, dropping reference bins < 1."""
    s_med = stats.median(sample.count)
    r_med = stats.median(reference.count)
    factor = (r_med / s_med) if (s_med > 0 and r_med > 0) else 1.0
    keep = reference.count >= 1
    s = sample.select(keep)
    r = reference.count[keep].astype(np.float64)
    ratio = s.count.astype(np.float64) / r * factor
    return s.with_count(ratio.astype(np.float32))


def raw_ratios(sample: BinSet, reference: BinSet,
               min_ref: float = 1.0, max_ref: float = np.inf) -> BinSet:
    keep = (reference.count >= min_ref) & (reference.count <= max_ref)
    s = sample.select(keep)
    r = reference.count[keep].astype(np.float64)
    ratio = s.count.astype(np.float64) / r
    return s.with_count(ratio.astype(np.float32))


def ratios_to_counts(ratios: BinSet, ploidy_of_bin: np.ndarray | None = None) -> BinSet:
    """count = ratio * 40 * ploidy/2 (CanvasNormalizeUtilities.cs:23-32)."""
    ploidy = np.full(len(ratios), 2.0) if ploidy_of_bin is None \
        else np.asarray(ploidy_of_bin, dtype=np.float64)
    counts = ratios.count.astype(np.float64) * DIPLOID_BIN_RATIO_FACTOR * ploidy / 2.0
    return ratios.with_count(counts.astype(np.float32))


def write_cnd_file(sample: "BinSet", reference: "BinSet", ratios: "BinSet",
                   path) -> None:
    """Copy-number-data CSV (CanvasNormalizeUtilities.WriteCndFile, :51-95):
    one row per ratio bin with the matching fragment/reference counts;
    bins dropped during ratio calculation are skipped by key alignment."""
    import csv

    def keys(b):
        return {(int(b.contig_id[i]), int(b.start[i])): i
                for i in range(len(b))}

    skey = keys(sample)
    rkey = keys(reference)
    with open(str(path), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Fragment Count", "Reference Count", "Chromosome",
                    "Start", "End", "Unsmoothed Log Ratio"])
        names = ratios.contigs.names
        for i in range(len(ratios)):
            k = (int(ratios.contig_id[i]), int(ratios.start[i]))
            si, ri = skey.get(k), rkey.get(k)
            if si is None or ri is None:
                continue
            w.writerow([f"{sample.count[si]:g}", f"{reference.count[ri]:g}",
                        names[k[0]], int(ratios.start[i]),
                        int(ratios.end[i]), f"{ratios.count[i]:g}"])
