"""Somatic purity/ploidy caller (CanvasSomaticCaller core).

Reference flow (SomaticCaller.cs:366-476 -> CallCNVUsingSNVFrequency :2546):
  * usable segments: >=5kb, coverage <= 2x overall median, MAF from >=50 VFs
    (relaxing by 15 down to 5 when too few), weight = length scaled down for
    <10 VFs (GetUsableSegmentsForModeling :1426-1500);
  * coverage weighting factor = CoverageWeighting / medianCoverage, blended
    toward CoverageWeightingWithMafSegmentation for uneven coverage
    (:1661-1679);
  * ploidy models CN 0..8 x major count, balanced states using the
    empirical diploid-MAF model (InitializePloidies :87-116); model points
    mix tumor/normal: coverage = CN*tumorHaploid + 2*normalHaploid, MAF =
    AdjustedMAF(minor-allele coverage) (:754-777 with the binomial
    min-observation correction :686-716);
  * GRID SEARCH over (diploidCoverage in [median/4, median*2.355] step 1) x
    (purity in [hard limit..100] step 1): each model scored by
    ModelDeviation = 0.5*precision + 0.5*accuracy deviation after a
    RefineDiploidMAF pass (:958-1007, :1214-1379), ploidy-gated to
    (0.5, 8);
  * model selection: deviation cutoff at best*1.75 (or the 11th best),
    score = lowPurityWeight * 0.175 * (CN2/bestCN2 - 1)
          + 0.375 * deviationScore + 0.125 * diploidDistance/best
          (+ heterogeneity for enrichment) (:1939-2056);
  * per-segment nearest-model assignment with haploid-reference handling
    and >maxCN coverage extrapolation (AssignPloidyCalls :2379-2457);
    heterogeneity CN2->1/3 swap (AdjustPloidyCalls :2467-2489);
  * SNV-VAF purity cross-check (EstimatePurityFromSomaticSNVs /
    SelectPurityEstimate :2653-2750) and chromosome-count estimate.

The reference's ~10^4-model x per-segment loop is expressed here as a
batched computation: distances [models, points, segments] evaluated in
chunks of models, float64 torch on a CUDA device and vectorized float64
numpy on the CPU (models/somatic_grid.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.models.segment_model import Segment
from canvas_tpu_torch.models.diploid import estimate_diploid_maf
from canvas_tpu_torch.ops import stats

# SomaticCallerParameters.json
MAX_COPY_NUMBER = 8
MIN_VF_FOR_INFORMATIVE = 50
COVERAGE_WEIGHTING = 0.333
COVERAGE_WEIGHTING_WITH_MAF = 0.20
EVENNESS_THRESHOLD = 94.5
MIN_EVENNESS = 88.0
LOWER_COVERAGE_FACTOR = 4.0
UPPER_COVERAGE_FACTOR = 2.355
MAX_ALLOWED_PLOIDY = 8.0
MIN_ALLOWED_PLOIDY = 0.5
DEVIATION_FACTOR = 1.75
DEVIATION_INDEX_CUTOFF = 11
CN2_WEIGHT = 0.175
DEVIATION_SCORE_WEIGHT = 0.375
DIPLOID_DISTANCE_WEIGHT = 0.125
HETEROGENEITY_WEIGHT = 0.202
DISTANCE_RATIO = 0.3
# SomaticCallerParameters.cs:6 defaults to 10, but the shipped JSON
# (SomaticCallerParameters.json: "MinimumCallSize": "50000") is deserialized
# over the code default at startup (CanvasSomaticCaller/Program.cs:157-163),
# so the effective reference value is 50000.
MINIMUM_CALL_SIZE = 50000
MAX_RELATED_MODELS = 5


class NotEnoughUsableSegmentsException(Exception):
    """Sample lacks coverage/BAF variation to model purity (:1637, the
    reference's NotEnoughUsableSegementsException [sic])."""


class UncallableDataException(Exception):
    """Data is present but uncallable (:917, :1936)."""


@dataclass
class SegmentInfo:
    segment: Segment
    coverage: float
    maf: float          # -1 when uninformative
    weight: float
    cluster_id: int | None = None


@dataclass
class PloidyState:
    copy_number: int
    major_count: int
    maf: float                       # pure-tumor MAF
    mixed_coverage: float = 0.0
    mixed_maf: float = 0.0
    mixed_haploid_coverage: float = 0.0


@dataclass
class PurityModel:
    diploid_coverage: float
    purity: float
    deviation: float = np.inf
    precision_deviation: float = np.inf
    accuracy_deviation: float = np.inf
    percent_cn: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_COPY_NUMBER + 1))
    percent_normal: float = 0.0
    ploidy: float = 0.0
    diploid_distance: float = 0.0
    cns: np.ndarray | None = None
    inter_model_distance: float | None = None
    heterogeneity_index: float | None = None

    @property
    def tumor_haploid(self) -> float:
        return self.diploid_coverage * self.purity / 2.0

    @property
    def normal_haploid(self) -> float:
        return self.diploid_coverage * (1.0 - self.purity) / 2.0


def get_usable_segments(
    segments: list[Segment],
    is_enrichment: bool = False,
    min_vf: int = MIN_VF_FOR_INFORMATIVE,
    overall_median: float | None = None,
) -> list[SegmentInfo]:
    """GetUsableSegmentsForModeling (:1426-1500).  overall_median lets the
    windowed pass reuse the full-segment median (:1436-1458)."""
    if overall_median is None:
        if is_enrichment:
            counts = np.array([stats.median(s.bin_counts) for s in segments],
                              dtype=np.float32)
        else:
            counts = np.concatenate([s.bin_counts for s in segments])
        overall_median = stats.quartiles(counts)[1]
    out = []
    for seg in segments:
        if seg.length < 5000:
            continue
        freqs = seg.baf_frequencies
        if len(freqs) < min_vf:
            maf = -1.0
        else:
            folded = np.where(freqs > 0.5, 1 - freqs, freqs).astype(np.float64)
            folded.sort()
            maf = float(folded[len(folded) // 2])
        coverage = stats.median(seg.bin_counts)
        if coverage > overall_median * 2:
            continue
        weight = float(seg.length)
        if len(freqs) < 10:
            weight *= len(freqs) / 10.0
        out.append(SegmentInfo(seg, coverage, maf, weight))
    return out


def usable_segments_with_relaxation(segments: list[Segment],
                                    is_enrichment: bool = False):
    """ModelOverallCoverageAndPurity's relaxation loop (:1626-1634)."""
    min_vf = MIN_VF_FOR_INFORMATIVE
    while True:
        usable = get_usable_segments(segments, is_enrichment, min_vf)
        valid_maf = sum(1 for u in usable if u.maf >= 0)
        if valid_maf > min(20, len(segments)) or min_vf <= 5:
            return usable, min_vf
        min_vf = max(5, min_vf - 15)


def split_segment_windows(seg: Segment,
                          window_width: int = 500_000) -> list[Segment]:
    """oneSegmentToWindows (:2300-2356): chop a segment into ~window_width
    pieces; bins go to the window whose end exceeds their start, alleles
    split by position."""
    if seg.bin_starts is not None:
        bin_starts = np.asarray(seg.bin_starts)
    else:  # no recorded starts: spread bins evenly across the span
        bin_starts = seg.begin + np.arange(len(seg.bin_counts)) \
            * max(1, (seg.end - seg.begin) // max(1, len(seg.bin_counts)))
    positions = seg.baf_positions if len(seg.baf_positions) \
        else np.zeros(0, np.int64)
    windows = []
    for lo in range(seg.begin, seg.end, window_width):
        hi = min(lo + window_width, seg.end)
        bsel = (bin_starts >= lo) & (bin_starts < hi)
        asel = (positions >= lo) & (positions < hi)
        windows.append(Segment(
            seg.chrom, lo, hi, seg.bin_counts[bsel],
            bin_starts=bin_starts[bsel],
            baf_positions=positions[asel],
            baf_frequencies=seg.baf_frequencies[asel]
            if len(seg.baf_frequencies) else seg.baf_frequencies,
        ))
    return windows


def windowed_usable_segments(
    infos: list[SegmentInfo],
    overall_median: float,
    is_enrichment: bool = False,
    min_vf: int = MIN_VF_FOR_INFORMATIVE,
    window_width: int = 500_000,
) -> list[tuple[SegmentInfo, SegmentInfo]]:
    """segmentsToSegmentWindows (:2283-2297): split usable segments into
    ~500kb windows and run them through the usable-segment filter with the
    full-segment overall median; returns (window info, source info) pairs."""
    out = []
    for src in infos:
        wins = split_segment_windows(src.segment, window_width)
        wininfos = get_usable_segments(wins, is_enrichment, min_vf,
                                       overall_median=overall_median)
        out.extend((w, src) for w in wininfos)
    return out


def is_sample_clearly_not_all_reference_ploidy(
    infos: list[SegmentInfo],
    windowed: list[tuple[SegmentInfo, SegmentInfo]],
    median_coverage_level: float,
    median_maf: float,
    ref_ploidy_fn=None,
) -> bool:
    """IsSampleClearlyNotAllReferencePloidy (:2129-2211): if >=50 Mb of
    usable weight deviates strongly from the overall medians (z-scores
    normalized by within-segment CVs), allow purity down to 5%."""
    cvg_cv, maf_cv = [], []
    for win, src in windowed:
        ref_p = ref_ploidy_fn(win.segment) if ref_ploidy_fn else None
        if ref_p == 0 or win.segment.length < 400_000:
            continue
        if src.coverage != 0:
            cvg_cv.append(abs(win.coverage - src.coverage) / src.coverage)
        if src.maf != 0:
            maf_cv.append(abs(win.maf - src.maf) / src.maf)
    if not cvg_cv or not maf_cv:
        return False
    coverage_cv = stats.median(np.array(cvg_cv, dtype=np.float64))
    maf_cv_m = stats.median(np.array(maf_cv, dtype=np.float64))

    def ieee_div(num, den):
        """C# double semantics: x/0 = inf, 0/0 = NaN (never > cutoff)."""
        if den != 0:
            return num / den
        return float("inf") if num > 0 else float("nan")

    bases_outside = 0.0
    for info in infos:
        ref_p = ref_ploidy_fn(info.segment) if ref_ploidy_fn else None
        if ref_p == 0 or info.segment.length < 400_000:
            continue
        expected = median_coverage_level * (2.0 if ref_p is None
                                            else float(ref_p)) / 2.0
        cvg_z = ieee_div(ieee_div(abs(info.coverage - expected), expected),
                         coverage_cv)
        maf_z = ieee_div(ieee_div(abs(info.maf - median_maf), median_maf),
                         maf_cv_m) if ref_p == 2 else 0.0
        if cvg_z > 12 or maf_z > 12 or (cvg_z > 5 and maf_z > 5):
            bases_outside += info.weight
    return bases_outside >= 50_000_000


def initialize_ploidies(mean_coverage: float,
                        max_cn: int = MAX_COPY_NUMBER) -> list[PloidyState]:
    """Somatic InitializePloidies (:87-116)."""
    out = []
    for cn in range(max_cn + 1):
        major = cn
        while major * 2 >= cn:
            if cn == 0:
                maf = estimate_diploid_maf(1, mean_coverage)
            else:
                vf = major / cn
                maf = vf if vf < 0.5 else 1 - vf
                if major * 2 == cn:
                    maf = estimate_diploid_maf(cn, mean_coverage)
            out.append(PloidyState(cn, major, maf))
            major -= 1
    return out


# ---------------------------------------------------------------------------
# AdjustedMAF — binomial min-observation correction (:686-716)
# ---------------------------------------------------------------------------

def adjusted_maf_batch(theoretical: np.ndarray,
                       coverage: np.ndarray) -> np.ndarray:
    """AdjustedMAF (:686-716) vectorized over model points: expected
    min(i, c-i)/c under Binomial(n=int(c), p=theoretical/c).

    The reference sums the pmf over i = 0..n per point; that is O(c) per
    point and explodes for enrichment-scale coverages (raw target counts).
    Closed form instead:  min(i, c-i) = i - max(0, 2i - c), so with
    m = smallest integer i with 2i > c,

        E[min] = n*p - 2*S1 + c*S0
        S0 = P[X >= m]              = betainc(m, n-m+1, p)
        S1 = E[X; X >= m] = n*p*P[X' >= m-1],  X' ~ Binomial(n-1, p)

    (using i*pmf(n,p,i) = n*p*pmf(n-1,p,i-1)).  O(1) per point, exact."""
    from scipy.special import betainc

    theoretical = np.asarray(theoretical, dtype=np.float64)
    coverage = np.asarray(coverage, dtype=np.float64)
    out = np.zeros(len(coverage))
    ok = (coverage >= 1.0) & (theoretical != 0)
    if not ok.any():
        return out
    c = coverage[ok]
    n = np.floor(c)
    p = theoretical[ok] / c
    m = np.floor(c / 2.0) + 1.0          # smallest integer i with 2i > c

    def upper_tail(a, nn):
        """P[Binomial(nn, p) >= a]; a, nn float arrays."""
        t = np.zeros_like(p)
        full = a <= 0
        t[full] = 1.0
        live = (~full) & (a <= nn)
        t[live] = betainc(a[live], nn[live] - a[live] + 1.0, p[live])
        return t

    s0 = upper_tail(m, n)
    s1 = n * p * upper_tail(m - 1.0, n - 1.0)
    mean_obs = n * p - 2.0 * s1 + c * s0
    out[ok] = mean_obs / c
    return out


def adjusted_maf(theoretical_ma_cvg: float, coverage: float) -> float:
    return float(adjusted_maf_batch(np.array([theoretical_ma_cvg]),
                                    np.array([coverage]))[0])


def model_points(model: PurityModel, ploidies: list[PloidyState]) -> None:
    """InitializeModelPoints(CoveragePurityModel) (:754-777); updates the
    ploidy states' mixed_* fields in place."""
    th, nh = model.tumor_haploid, model.normal_haploid
    cn = np.array([p.copy_number for p in ploidies], dtype=np.float64)
    major = np.array([p.major_count for p in ploidies], dtype=np.float64)
    mixed_cov = cn * th + 2 * nh
    theoretical = (cn - major) * th + nh
    mafs = adjusted_maf_batch(theoretical, mixed_cov)
    for p, mc, mm in zip(ploidies, mixed_cov, mafs):
        p.mixed_coverage = float(mc)
        p.mixed_maf = float(mm)
        p.mixed_haploid_coverage = p.copy_number * th + nh


def write_cnv_modeling(path, ploidies: list["PloidyState"],
                       infos: list["SegmentInfo"],
                       coverage_weight: float, known_cn_fn=None) -> None:
    """CNVModeling.txt debug dump (SomaticCaller.cs:1330-1358): the best
    model's points (MAF, coverage, MCC/CN genotype), a blank line, then
    every usable segment with its distance to the nearest model point.
    ``plotSomaticModelMatrix.r`` / tools/plot_somatic_model.py read this.
    known_cn_fn: CopyNumberOracle hook (GetKnownCNForSegment, :3235-3239);
    -1 without a truth set."""
    with open(path, "w") as f:
        f.write("#MAF\tCoverage\tGenotype\n")
        for p in ploidies:
            gt = f"{p.major_count}/{p.copy_number}"
            f.write(f"{p.mixed_maf:g}\t{p.mixed_coverage:g}\t{gt}\n")
        f.write("\n")
        f.write("#MAF\tCoverage\tBestDistance\tChromosome\tBegin\tEnd\t"
                "Length\tTruthSetCN\n")
        for info in infos:
            best = min(
                model_distance(info.coverage, p.mixed_coverage, info.maf,
                               p.mixed_maf, coverage_weight)
                for p in ploidies)
            known = known_cn_fn(info.segment) if known_cn_fn else -1
            seg = info.segment
            f.write(f"{info.maf:g}\t{info.coverage:g}\t"
                    f"{math.sqrt(best):g}\t{seg.chrom}\t{seg.begin}\t"
                    f"{seg.end}\t{seg.end - seg.begin}\t{known}\n")


def model_distance(cov1, cov2, maf1, maf2, coverage_weight: float):
    """GetModelDistance (:884-892): squared weighted distance; MAF-less
    segments get 2x the coverage term."""
    diff = (cov1 - cov2) * coverage_weight
    d = diff * diff
    if maf1 is None or maf1 < 0:
        return 2 * d
    return d + (maf1 - maf2) ** 2


def refine_diploid_maf(
    seg_cov: np.ndarray, seg_maf: np.ndarray, seg_w: np.ndarray,
    pt_cov: np.ndarray, pt_maf: np.ndarray, pt_cn: np.ndarray,
    pt_major: np.ndarray, cw: float) -> np.ndarray:
    """RefineDiploidMAF (:958-1007), vectorized.  Returns refined pt_maf."""
    dummy_weight = 1e7
    n_lv = 1 + MAX_COPY_NUMBER // 2
    m_sum = np.zeros(n_lv)
    m_w = np.zeros(n_lv)
    balanced = (pt_cn % 2 == 0) & (pt_major * 2 == pt_cn)
    for k in np.flatnonzero(balanced):
        m_sum[pt_cn[k] // 2] += dummy_weight * pt_maf[k]
        m_w[pt_cn[k] // 2] += dummy_weight
    # assignment pass
    d = ((seg_cov[:, None] - pt_cov[None]) * cw) ** 2
    has_maf = seg_maf >= 0
    d_maf = d + (seg_maf[:, None] - pt_maf[None]) ** 2
    d_full = np.where(has_maf[:, None], d_maf, 2 * d)
    best = np.argmin(d_full, axis=1)
    for i in np.flatnonzero(has_maf):
        k = best[i]
        if balanced[k] and seg_maf[i] >= 0.4:
            m_sum[pt_cn[k] // 2] += seg_w[i] * seg_maf[i]
            m_w[pt_cn[k] // 2] += seg_w[i]
    out = pt_maf.copy()
    for k in np.flatnonzero(balanced):
        out[k] = m_sum[pt_cn[k] // 2] / m_w[pt_cn[k] // 2]
    return out


def model_deviation(
    model: PurityModel,
    ploidies: list[PloidyState],
    infos: list[SegmentInfo],
    coverage_weight: float,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    mean_coverage: float | None = None,
) -> float:
    """ModelDeviation (:1214-1379).  With clustering results provided (WGS,
    >100 segments and MAFs, <10 centroids) the cluster-deviation branch
    engages: when more than HeterogeneousClustersCutoff clusters straddle
    model points, totalDeviation = (precision + accuracy + cluster)/3,
    which penalizes degenerate (e.g. half-coverage) models whose points
    split real clusters."""
    model_points(model, ploidies)
    pt_cov = np.array([p.mixed_coverage for p in ploidies])
    pt_maf = np.array([p.mixed_maf for p in ploidies])
    pt_cn = np.array([p.copy_number for p in ploidies])
    pt_major = np.array([p.major_count for p in ploidies])
    seg_cov = np.array([i.coverage for i in infos])
    seg_maf = np.array([i.maf for i in infos])
    seg_w = np.array([i.weight for i in infos])

    pt_maf = refine_diploid_maf(seg_cov, seg_maf, seg_w, pt_cov, pt_maf,
                                pt_cn, pt_major, coverage_weight)
    for p, m in zip(ploidies, pt_maf):
        p.mixed_maf = float(m)

    d = ((seg_cov[:, None] - pt_cov[None]) * coverage_weight) ** 2
    has_maf = seg_maf >= 0
    d_full = np.where(has_maf[:, None],
                      d + (seg_maf[:, None] - pt_maf[None]) ** 2, 2 * d)
    best = np.argmin(d_full, axis=1)
    best_dist = np.sqrt(d_full[np.arange(len(infos)), best])
    total_w = seg_w.sum()
    precision_dev = float(np.sum(best_dist * seg_w) / total_w)

    best_cn = pt_cn[best]
    model.percent_cn = np.zeros(MAX_COPY_NUMBER + 1)
    np.add.at(model.percent_cn, best_cn, seg_w)
    is_normal = (best_cn == 2) & (pt_major[best] == 1)
    model.percent_normal = float(np.sum(seg_w[is_normal]) / total_w)
    # CN profile with LOH counted as one event (CN2 MCC2 -> 1)
    cns = np.where((best_cn == 2) & (pt_major[best] == 2), 1, best_cn)
    model.cns = cns

    # accuracy deviation: empirical centroids per model point
    acc = 0.0
    for k in range(len(ploidies)):
        m = best == k
        w = seg_w[m].sum()
        if w == 0:
            continue
        emp_cov = float(np.sum(seg_w[m] * seg_cov[m]) / w)
        mw = seg_w[m & has_maf].sum()
        emp_maf = float(np.sum(seg_w[m & has_maf] * seg_maf[m & has_maf]) / mw) \
            if mw > 0 else 0.0
        dist = math.sqrt(model_distance(pt_cov[k], emp_cov, pt_maf[k],
                                        emp_maf, coverage_weight))
        acc += dist * w
    accuracy_dev = acc / total_w

    model.percent_cn /= total_w
    model.ploidy = float(np.sum(np.arange(MAX_COPY_NUMBER + 1)
                                * model.percent_cn))
    model.precision_deviation = precision_dev
    model.accuracy_deviation = accuracy_dev
    temp_deviation = precision_dev * 0.5 + 0.5 * accuracy_dev
    model.deviation = temp_deviation

    valid_maf_count = int(np.count_nonzero(has_maf))
    if (cluster_ids is not None and n_clusters and mean_coverage is not None
            and valid_maf_count > 100 and len(infos) > 100
            and n_clusters < 10):
        cdev, n_het, het_index, _ = cluster_deviation(
            infos, cluster_ids, n_clusters, ploidies, coverage_weight,
            mean_coverage)
        model.heterogeneity_index = het_index
        if n_het > HETEROGENEOUS_CLUSTERS_CUTOFF:
            model.deviation = PRECISION_WEIGHTING_FACTOR * (
                precision_dev + accuracy_dev + cdev)
    return model.deviation


def diploid_model_distance(model: PurityModel, infos: list[SegmentInfo],
                           genome_length: int) -> float:
    """DiploidModelDistance (:842-860)."""
    baseline = 2
    total = 0.0
    amp = float(np.sum(model.percent_cn[3:MAX_COPY_NUMBER]))
    if amp > 0.8:
        baseline = 4
        total += 1.0
    lengths = np.array([i.segment.length for i in infos], dtype=np.float64)
    total += float(np.sum(np.abs(model.cns - baseline) * lengths) / genome_length)
    model.diploid_distance = 1.0 / max(0.001, total)
    return total


def grid_search(
    infos: list[SegmentInfo],
    mean_coverage: float,
    genome_length: int,
    coverage_weight: float,
    median_coverage_level: int,
    min_purity_hard_limit: int = 20,
    min_minor_allele_coverage: float | None = None,
    user_purity: float | None = None,
    user_diploid_coverage: float | None = None,
    cluster_ids: np.ndarray | None = None,
    n_clusters: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[PurityModel, list[PurityModel]]:
    """The coverage x purity grid (:1875-1933) on `device` + model
    selection (:1939-2056).  Returns (best model, all acceptable models)."""
    from canvas_tpu_torch.models import somatic_grid

    ploidies = initialize_ploidies(mean_coverage)
    min_cov = int(max(10, median_coverage_level / LOWER_COVERAGE_FACTOR))
    max_cov = int(max(10, median_coverage_level * UPPER_COVERAGE_FACTOR))
    if user_diploid_coverage is not None:
        min_cov = max_cov = int(user_diploid_coverage)
    grid_cov: list[int] = []
    grid_pur: list[int] = []
    for coverage in range(min_cov, max_cov + 1):
        if min_minor_allele_coverage is not None:
            min_purity = int(max(min_purity_hard_limit,
                                 100 * (1 - 2 * min_minor_allele_coverage
                                        / coverage) - 10))
        else:
            min_purity = min_purity_hard_limit
        max_purity = 100
        if user_purity is not None:
            min_purity = max_purity = int(user_purity * 100)
        for purity in range(min_purity, max_purity + 1):
            grid_cov.append(coverage)
            grid_pur.append(purity)
    res = somatic_grid.evaluate_grid(
        np.asarray(grid_cov, np.float64),
        np.asarray(grid_pur, np.float64) / 100.0,
        infos, ploidies, coverage_weight, genome_length,
        cluster_ids, n_clusters, mean_coverage, device=device)
    all_models: list[PurityModel] = []
    best_deviation = np.inf
    for k in range(len(grid_cov)):
        if not (MIN_ALLOWED_PLOIDY < res["ploidy"][k] < MAX_ALLOWED_PLOIDY):
            continue
        model = PurityModel(float(grid_cov[k]), grid_pur[k] / 100.0)
        model.deviation = float(res["deviation"][k])
        model.precision_deviation = float(res["precision"][k])
        model.accuracy_deviation = float(res["accuracy"][k])
        model.ploidy = float(res["ploidy"][k])
        model.percent_cn = res["percent_cn"][k]
        model.percent_normal = float(res["percent_normal"][k])
        model.diploid_distance = float(res["diploid_distance"][k])
        model.heterogeneity_index = float(res["het_index"][k])
        model.cns = res["cns"][k]
        best_deviation = min(best_deviation, model.deviation)
        all_models.append(model)
    if not all_models:
        raise UncallableDataException(
            "Error with CNV detection - unable to find any viable "
            "purity/ploidy model.  Check that the sample has reasonable "
            "coverage (>=10x)")

    worst_allowed = best_deviation * DEVIATION_FACTOR
    deviations = sorted(m.deviation for m in all_models)
    n_ok = sum(1 for m in all_models if m.deviation < worst_allowed)
    if n_ok < DEVIATION_INDEX_CUTOFF:
        worst_allowed = deviations[min(DEVIATION_INDEX_CUTOFF,
                                       len(deviations) - 1)]
    best_cn2 = 0.0
    best_dd = 0.0
    for m in all_models:
        if m.deviation > worst_allowed:
            continue
        best_cn2 = max(best_cn2, m.percent_cn[2])
        best_dd = max(best_dd, m.diploid_distance)

    best_model, best_score = None, 0.0
    scored: list[tuple[float, PurityModel]] = []
    for m in all_models:
        if m.deviation > worst_allowed:
            continue
        low_purity_w = 1.5 / ((1.5 - 0.5) / (1.0 - min_purity_hard_limit / 100)
                              * (m.purity - min_purity_hard_limit / 100) + 1.0)
        cn2_score = low_purity_w * CN2_WEIGHT * (
            m.percent_cn[2] / max(0.01, best_cn2) - 1)
        dev_score = 0.0
        if worst_allowed > best_deviation:
            dev_score = DEVIATION_SCORE_WEIGHT * (worst_allowed - m.deviation) \
                / (worst_allowed - best_deviation)
        dd_score = DIPLOID_DISTANCE_WEIGHT * m.diploid_distance / max(0.01, best_dd)
        score = cn2_score + dev_score + dd_score
        scored.append((score, m))
        if score > best_score:
            best_model, best_score = m, score
    if best_model is None:
        best_model = min(all_models, key=lambda m: m.deviation)

    # Dedup-model sanity probe (:2058-2080): when the winner looks like a
    # genome-duplication artifact (ploidy>3, low diploid coverage, purity>0),
    # score the model where its CN=2 becomes CN=1 / CN=4 becomes CN=2.  The
    # reference only logs when the deduped model is competitive; results are
    # deliberately not used to change the call.
    if (best_model.ploidy > 3 and best_model.diploid_coverage < 90
            and best_model.purity > 0):
        tumor_haploid = best_model.diploid_coverage * best_model.purity / 2
        normal_contrib = best_model.diploid_coverage * (1 - best_model.purity)
        dedup_diploid = normal_contrib + 4 * tumor_haploid
        dedup_purity = 1 - normal_contrib / dedup_diploid
        dedup = PurityModel(dedup_diploid, dedup_purity)
        model_deviation(dedup, initialize_ploidies(mean_coverage), infos,
                        coverage_weight, cluster_ids, n_clusters,
                        mean_coverage)
        if dedup.deviation < best_model.deviation + 0.001:
            print(f">>> Deduped model should be considered: Deviation "
                  f"{dedup.deviation:.5f}, coverage {dedup.diploid_coverage}, "
                  f"purity {dedup.purity * 100:.1f} vs duped model deviation "
                  f"{best_model.deviation}")

    # inter-model genome edit distance across top models (:2082-2094)
    scored.sort(key=lambda t: -t[0])
    inter = 0.0
    lengths = np.array([i.segment.length for i in infos], dtype=np.float64)
    for _, m in scored[1:MAX_RELATED_MODELS]:
        inter += float(np.sum(np.abs(best_model.cns - m.cns) * lengths)
                       / genome_length)
    best_model.inter_model_distance = inter / MAX_RELATED_MODELS
    # re-evaluate the winner so the ploidy states hold its model points
    model_deviation(best_model, ploidies, infos, coverage_weight,
                    cluster_ids, n_clusters, mean_coverage)
    return best_model, [m for _, m in scored]


# ---------------------------------------------------------------------------
# Cluster deviation + clonality (heterogeneity) scoring
# ---------------------------------------------------------------------------

# Clonality logistic weights (SomaticCallerParameters.json)
CLONALITY_INTERCEPT = 2.5621879132
CLONALITY_BEST_MODEL_DISTANCE = -45.471444424
CLONALITY_CLUSTER_ENTROPY = -4.2843880136
CLONALITY_CLUSTER_MEDIAN_DISTANCE = 1.3284471738
CLONALITY_CLUSTER_MEAN_DISTANCE = 7.7372213136
CLONALITY_CLUSTER_VARIANCE = 20.8041902168
CLONALITY_NUM_CLUSTERS = -0.0940266124
CLONALITY_MODEL_DEVIATION = -2.2441224164
HETEROGENEOUS_CLUSTERS_CUTOFF = 3
PRECISION_WEIGHTING_FACTOR = 1.0 / 3.0


@dataclass
class ClusterMetrics:
    cluster_id: int
    mean_distance: float = 0.0
    median_distance: float = 0.0
    variance: float = 0.0
    entropy: float = 0.0
    n: int = 0


def _cluster_entropy(mccs: np.ndarray) -> float:
    """ClusterInfo.ComputeClusterEntropy — note the reference iterates the
    unique MCC VALUES as if they were counts (ClusterInfo.cs:36-50);
    reproduced for parity."""
    if len(mccs) == 0:
        return 0.0
    entropy = 0.0
    for v in np.unique(mccs):
        if v > 0:
            p = v / len(mccs)
            entropy += -p * math.log(p)
    return float(entropy)


def cluster_metrics(
    infos: list[SegmentInfo],
    cluster_ids: np.ndarray,
    n_clusters: int,
    ploidies: list[PloidyState],
    coverage_weight: float,
    mean_coverage: float,
) -> list[ClusterMetrics]:
    """CalculateClusterMetrics (:1140-1205): per-cluster distance stats and
    the MCC-mix entropy, using each segment's nearest model point among
    points with coverage < 2x mean.  Vectorized (runs once per grid model)."""
    out = [ClusterMetrics(k + 1) for k in range(n_clusters)]
    pts = [(p.mixed_coverage, p.mixed_maf, p.copy_number, p.major_count)
           for p in ploidies if p.mixed_coverage < mean_coverage * 2.0]
    if not pts:
        return out
    pt_cov = np.array([p[0] for p in pts])
    pt_maf = np.array([p[1] for p in pts])
    pt_mcc = np.array([0.0 if (p[3] == 0 and p[2] == 0) else p[3] / p[2]
                       for p in pts])
    seg_cov = np.array([i.coverage for i in infos])
    seg_maf = np.array([i.maf for i in infos])
    dc = ((seg_cov[:, None] - pt_cov[None]) * coverage_weight) ** 2
    dfull = np.where((seg_maf >= 0)[:, None],
                     dc + (seg_maf[:, None] - pt_maf[None]) ** 2, 2 * dc)
    best = np.argmin(dfull, axis=1)
    best_d = np.sqrt(dfull[np.arange(len(infos)), best])
    best_mcc = pt_mcc[best]
    cids = np.asarray(cluster_ids)
    for cm in out:
        m = cids == cm.cluster_id
        cm.n = int(np.count_nonzero(m))
        if cm.n > 0:
            d = best_d[m]
            cm.mean_distance = float(d.mean())
            cm.median_distance = stats.median(d)
            cm.variance = stats.stddev(d) if len(d) > 1 else 0.0
            cm.entropy = _cluster_entropy(best_mcc[m])
    return out


def cluster_deviation(
    infos: list[SegmentInfo],
    cluster_ids: np.ndarray,
    n_clusters: int,
    ploidies: list[PloidyState],
    coverage_weight: float,
    mean_coverage: float,
) -> tuple[float, int, float, list[ClusterMetrics]]:
    """ClusterDeviation (:1033-1135): average cluster mean-distance, number
    of heterogeneous clusters (median distance AND entropy above cluster
    medians), heterogeneity index."""
    cms = cluster_metrics(infos, cluster_ids, n_clusters, ploidies,
                          coverage_weight, mean_coverage)
    if not any(c.n for c in cms):
        return float("inf"), 2 ** 31 - 1, float("inf"), cms
    dev = float(np.mean([c.mean_distance for c in cms])) if cms else 0.0
    med_dist = stats.median([c.median_distance for c in cms]) if cms else 0.0
    med_entropy = stats.median([c.entropy for c in cms]) if cms else 0.0
    het = [c for c in cms
           if c.median_distance > med_dist and c.entropy > med_entropy]
    het_index = len(het) / n_clusters if n_clusters else 0.0
    return dev, len(het), het_index, cms


def clonality_scores(
    infos: list[SegmentInfo],
    cluster_ids: np.ndarray,
    cms: list[ClusterMetrics],
    ploidies: list[PloidyState],
    coverage_weight: float,
    n_clusters: int,
    model_dev: float,
) -> dict[int, float]:
    """ComputeClonalityScore (:2736-2768): logistic heterogeneity score per
    segment (score < 0.5 -> heterogeneous).  Returns info-index -> score."""
    out: dict[int, float] = {}
    pts = [(p.mixed_coverage, p.mixed_maf) for p in ploidies]
    for i, (info, cid) in enumerate(zip(infos, cluster_ids)):
        if cid <= 0 or cid > len(cms):
            continue
        best = min(model_distance(info.coverage, c, info.maf, m,
                                  coverage_weight) for c, m in pts)
        best = math.sqrt(best)
        cm = cms[int(cid) - 1]
        score = CLONALITY_INTERCEPT
        score += best * CLONALITY_BEST_MODEL_DISTANCE
        score += cm.entropy * CLONALITY_CLUSTER_ENTROPY
        score += cm.median_distance * CLONALITY_CLUSTER_MEDIAN_DISTANCE
        score += cm.mean_distance * CLONALITY_CLUSTER_MEAN_DISTANCE
        score += cm.variance * CLONALITY_CLUSTER_VARIANCE
        score += n_clusters * CLONALITY_NUM_CLUSTERS
        score += model_dev * CLONALITY_MODEL_DEVIATION
        score = math.exp(score)
        out[i] = score / (score + 1)
    return out


def coverage_weighting_factor(median_coverage_level: int,
                              evenness_score: float | None) -> float:
    """:1661-1679."""
    if evenness_score is not None and evenness_score < EVENNESS_THRESHOLD:
        scaler = max(evenness_score - MIN_EVENNESS, 0.0) / (
            EVENNESS_THRESHOLD - MIN_EVENNESS)
        w = COVERAGE_WEIGHTING_WITH_MAF + (
            COVERAGE_WEIGHTING - COVERAGE_WEIGHTING_WITH_MAF) * scaler
        return w / median_coverage_level
    return COVERAGE_WEIGHTING / median_coverage_level


# ---------------------------------------------------------------------------
# GaussianMixture clustering mode (:1701-1713, :1499-1600, :790-832,
# :2494-2540) — EM over (MAF, coverage) with model-point seeding
# ---------------------------------------------------------------------------

def best_coverage_weighting_factor(
    infos: list[SegmentInfo],
    max_coverage_level: float,
    median_coverage_level: float,
    knn: np.ndarray, knn_cutoff: float,
) -> float:
    """BestCoverageWeightingFactor (:1579-1600): sweep ten factors between
    0.1/maxCoverage and CoverageWeighting/medianCoverage, seeding a
    6-cluster EM from a purity-90% model at coverage median/2, and keep the
    likelihood-maximizing factor."""
    from canvas_tpu_torch.ops import clustering as cl

    seg_maf = np.array([i.maf for i in infos])
    seg_cov = np.array([i.coverage for i in infos])
    seg_w = np.array([i.weight for i in infos])
    max_cw = COVERAGE_WEIGHTING / median_coverage_level
    min_cw = 0.1 / max(max_coverage_level, 1.0)
    step = max(1e-5, (max_cw - min_cw) / 10)
    seed = PurityModel(median_coverage_level / 2.0, 0.90)
    ploidies = initialize_ploidies(median_coverage_level)
    model_points(seed, ploidies)
    init_maf = np.array([p.mixed_maf for p in ploidies[:6]])
    init_cov = np.array([p.mixed_coverage for p in ploidies[:6]])
    best_lik, best_cw = -np.inf, min_cw
    cw = min_cw
    while cw < max_cw:
        _, _, _, lik = cl.gmm_em(init_maf, init_cov, seg_maf, seg_cov,
                                 seg_w, cw, knn, knn_cutoff)
        if lik > best_lik:
            best_lik, best_cw = lik, cw
        cw += step
    return best_cw


def best_num_clusters(
    infos: list[SegmentInfo],
    coverage_weight: float,
    knn: np.ndarray, knn_cutoff: float,
    rng: np.random.Generator,
):
    """BestNumClusters (:1499-1542): sweep 4..7 clusters x 10 random
    segment-seeded EMs, score by silhouette; returns
    (n_clusters, cluster_ids) of the best run."""
    from canvas_tpu_torch.ops import clustering as cl

    seg_maf = np.array([i.maf for i in infos])
    seg_cov = np.array([i.coverage for i in infos])
    seg_w = np.array([i.weight for i in infos])
    ok = seg_maf >= 0
    # pairwise-distance threshold at the 80th percentile (:1505-1519)
    dc = ((seg_cov[ok][:, None] - seg_cov[ok][None, :]) * coverage_weight) ** 2
    d = dc + (seg_maf[ok][:, None] - seg_maf[ok][None, :]) ** 2
    offdiag = d[~np.eye(len(d), dtype=bool)]
    offdiag.sort()
    thr = offdiag[min(int(len(offdiag) * 0.8), len(offdiag) - 1)] \
        if len(offdiag) else 0.0

    idx_ok = np.flatnonzero(ok)
    best_sil, best = -np.inf, (0, None)
    for n_clusters in range(4, 8):
        for _ in range(10):
            # segment-subsample seeding with the distance-escape rule
            # (InitializeModelPoints(segments, numClusters, thr), :592-637)
            last = int(rng.integers(1, len(idx_ok)))
            seeds = [idx_ok[last]]
            attempts = 0.0
            while len(seeds) < n_clusters:
                new = int(rng.integers(1, len(idx_ok)))
                attempts += 1.0
                dist = (seg_cov[idx_ok[last]] - seg_cov[idx_ok[new]]) ** 2 \
                    * coverage_weight ** 2 \
                    + (seg_maf[idx_ok[last]] - seg_maf[idx_ok[new]]) ** 2
                if dist > thr or attempts / len(idx_ok) > 0.3:
                    seeds.append(idx_ok[new])
                    last = new
                    attempts = 0.0
            _, _, ids, _ = cl.gmm_em(seg_maf[seeds], seg_cov[seeds],
                                     seg_maf, seg_cov, seg_w,
                                     coverage_weight, knn, knn_cutoff)
            sil = cl.silhouette(seg_maf, seg_cov, ids, coverage_weight,
                                n_clusters)
            if sil > best_sil:
                best_sil, best = sil, (n_clusters, ids)
    return best


def fit_gaussians(
    model: PurityModel,
    infos: list[SegmentInfo],
    ploidies: list[PloidyState],
    coverage_weight: float,
    knn: np.ndarray | None = None,
    knn_cutoff: float = np.inf,
):
    """FitGaussians (:790-832): EM with component means pinned at the
    model points; stores (omega, mu, sigma) per ploidy state and returns
    (components, likelihood)."""
    from canvas_tpu_torch.ops import clustering as cl

    model_points(model, ploidies)
    seg_maf = np.array([i.maf for i in infos])
    seg_cov = np.array([i.coverage for i in infos])
    seg_w = np.array([i.weight for i in infos])
    if knn is None:
        knn = np.zeros(len(infos))
    comps, _, _, lik = cl.gmm_em(
        np.array([p.mixed_maf for p in ploidies]),
        np.array([p.mixed_coverage for p in ploidies]),
        seg_maf, seg_cov, seg_w, coverage_weight, knn, knn_cutoff,
        update_means=False)
    return comps, lik


def assign_ploidy_calls_gaussian_mixture(
    segments: list[Segment],
    model: PurityModel,
    ploidies: list[PloidyState],
    components,
) -> None:
    """AssignPloidyCallsGaussianMixture (:2494-2540): posterior-probability
    assignment using the fitted per-ploidy Gaussians; zero posterior falls
    back to coverage-only rounding."""
    from canvas_tpu_torch.ops.clustering import _gauss2

    for seg in segments:
        folded = np.where(seg.baf_frequencies > 0.5,
                          1 - seg.baf_frequencies, seg.baf_frequencies)
        folded = np.sort(folded.astype(np.float64))
        median_cov = stats.median(seg.bin_counts)
        median_maf = float(folded[len(folded) // 2]) \
            if len(folded) >= 10 else -1.0
        probs = np.array([
            c.omega * float(_gauss2(np.array([median_maf]),
                                    np.array([median_cov]), c)[0])
            for c in components])
        total = probs.sum()
        post = probs / total if total > 0 else probs
        best = int(np.argmax(post))
        if post[best] == 0:
            seg.copy_number = int(round(2 * median_cov
                                        / model.diploid_coverage))
            seg.major_chromosome_count = seg.copy_number // 2
        else:
            seg.copy_number = ploidies[best].copy_number
            seg.major_chromosome_count = ploidies[best].major_count


def assign_ploidy_calls(
    segments: list[Segment],
    model: PurityModel,
    ploidies: list[PloidyState],
    coverage_weight: float,
    ref_ploidy_fn=None,
) -> None:
    """AssignPloidyCalls (:2379-2457)."""
    for seg in segments:
        folded = np.where(seg.baf_frequencies > 0.5,
                          1 - seg.baf_frequencies, seg.baf_frequencies)
        folded = np.sort(folded.astype(np.float64))
        median_cov = stats.median(seg.bin_counts)
        median_maf = float(folded[len(folded) // 2]) if len(folded) >= 10 else None
        is_haploid = ref_ploidy_fn is not None and ref_ploidy_fn(seg) == 1
        best_d, second_d = np.inf, np.inf
        best_p, second_p = None, None
        for p in ploidies:
            cov = p.mixed_haploid_coverage if is_haploid else p.mixed_coverage
            maf = 0.0 if is_haploid else p.mixed_maf
            d = model_distance(median_cov, cov, median_maf, maf, coverage_weight)
            if d < best_d:
                second_d, second_p = best_d, best_p
                best_d, best_p = d, p
            elif d < second_d:
                second_d, second_p = d, p
        seg.copy_number = best_p.copy_number
        seg.second_best_copy_number = second_p.copy_number
        seg.major_chromosome_count = best_p.major_count \
            if median_maf is not None else None
        seg.model_distance = best_d
        seg.runner_up_model_distance = second_d
        # >maxCN extrapolation from coverage ratio
        if seg.copy_number == MAX_COPY_NUMBER:
            ratio = seg.mean_count / model.diploid_coverage
            ref_cn = ref_ploidy_fn(seg) if ref_ploidy_fn else 2
            est = (2 * ratio - ref_cn * (1 - model.purity)) / model.purity
            est_cn = int(round(est))
            if est_cn > MAX_COPY_NUMBER:
                seg.copy_number = est_cn
                seg.major_chromosome_count = None
                cov = model.diploid_coverage * (
                    (1 - model.purity) + model.purity * est_cn / 2.0)
                seg.model_distance = abs(seg.mean_count - cov) * coverage_weight


def adjust_ploidy_calls(segments: list[Segment], model: PurityModel) -> None:
    """AdjustPloidyCalls heterogeneity swap (:2467-2489)."""
    for seg in segments:
        if not seg.is_heterogeneous or model.purity <= 0.2:
            continue
        if seg.runner_up_model_distance == 0:
            continue
        if seg.model_distance / seg.runner_up_model_distance <= DISTANCE_RATIO:
            continue
        if seg.copy_number == 2 and seg.second_best_copy_number in (1, 3):
            seg.copy_number, seg.second_best_copy_number = \
                seg.second_best_copy_number, seg.copy_number
            seg.major_chromosome_count = 1 if seg.second_best_copy_number == 1 \
                else 2


def select_purity_estimate(model: PurityModel, segments: list[Segment],
                           snv_purity: float) -> None:
    """SelectPurityEstimate (:2653-2678)."""
    total_w = sum(s.length for s in segments)
    abnormal = sum(s.length for s in segments
                   if s.copy_number != 2 or s.major_chromosome_count != 1)
    fraction = abnormal / total_w if total_w else 0.0
    if fraction < 0.07 and not math.isnan(snv_purity) and model.purity < 0.5:
        model.purity = snv_purity


def estimate_purity_from_somatic_vafs(vafs: np.ndarray) -> float:
    """EstimatePurityFromSomaticSNVs tail (:2718-2728): purity = min(1,
    2 * median VF) over PASS somatic SNVs with VF < 0.5 (needs >=100)."""
    vafs = np.asarray(vafs, dtype=np.float32)
    vafs = vafs[vafs < 0.5]
    if len(vafs) < 100:
        return float("nan")
    return min(1.0, 2 * stats.median(vafs))


def estimate_chromosome_count(segments: list[Segment]) -> float:
    """EstimateChromosomeCount (:2613-2651)."""
    overall = 0.0
    current = None
    counts = np.zeros(MAX_COPY_NUMBER + 1)

    def weighted():
        w = counts.sum()
        if w == 0:
            return 0.0
        return float(np.sum(counts * np.arange(len(counts))) / w)

    for seg in segments:
        if seg.chrom != current:
            if current is not None:
                overall += weighted()
            counts[:] = 0
            current = seg.chrom
        if not seg.is_pass or seg.copy_number == -1:
            continue
        counts[min(seg.copy_number, MAX_COPY_NUMBER)] += seg.length
    overall += weighted()
    return overall


def call_somatic(
    segments: list[Segment],
    genome_length: int,
    evenness_score: float | None = None,
    somatic_vafs: np.ndarray | None = None,
    ref_ploidy_fn=None,
    is_enrichment: bool = False,
    user_purity: float | None = None,
    clustering_mode: str = "MeanShift",
    debug_dir=None,
    device: str | torch.device = "cuda",
) -> tuple[PurityModel, list[str]]:
    """Core somatic calling (CallCNVUsingSNVFrequency without file I/O).

    clustering_mode is MeanShift (the reference default, Program.cs:46-47)
    or Density; assigns copy numbers in place; returns (model, headers).
    The model grid runs on `device` (somatic_grid.evaluate_grid)."""
    device = resolve_device(device)
    infos, _ = usable_segments_with_relaxation(segments, is_enrichment)
    if len(infos) < 3:
        raise NotEnoughUsableSegmentsException(
            "Cannot model coverage/purity with less than 3 segments.")
    # coverage/MAF scaling stats over reference-diploid segments
    cov_list, maf_list = [], []
    for info in infos:
        if ref_ploidy_fn is not None and ref_ploidy_fn(info.segment) != 2:
            continue
        cov_list.append(info.segment.bin_counts)
        f = info.segment.baf_frequencies
        maf_list.append(1 - np.maximum(f, 1 - f))
    cov_all = np.concatenate(cov_list) if cov_list else np.zeros(1)
    maf_all = np.concatenate(maf_list) if maf_list else np.zeros(0)
    q = stats.quartiles(cov_all.astype(np.float32))
    median_coverage_level = int(np.rint(q[1]))
    median_maf = float(stats.median(maf_all.astype(np.float64))) \
        if len(maf_all) else 0.0
    cw = coverage_weighting_factor(median_coverage_level, evenness_score)

    mean_coverage = float(np.mean(cov_all, dtype=np.float64))

    # ~500kb windows of the usable segments feed MeanShift clustering and
    # the all-reference-ploidy check (:1681, :2283-2297)
    windowed = windowed_usable_segments(infos, q[1], is_enrichment)

    # segment clustering BEFORE the grid (SomaticCaller.cs:1690-1866): the
    # cluster structure feeds ModelDeviation for every candidate model
    cluster_ids = None
    n_clusters = 0
    cms = None
    centroids_cov = np.zeros(0)
    centroids_maf = np.zeros(0)
    centroids_size = np.zeros(0, dtype=np.int64)
    valid_maf = sum(1 for i in infos if i.maf >= 0)
    # gate parses as (!IsEnrichment && MeanShift) ? windows>100 :
    # (usable>100 && validMAF>100)  (:1691-1693) — enrichment samples
    # cluster too when they have enough usable segments
    run_clustering = (len(windowed) > 100
                      if (not is_enrichment and clustering_mode == "MeanShift")
                      else len(infos) > 100 and valid_maf > 100)
    if run_clustering:
        from canvas_tpu_torch.ops import clustering as cl

        seg_cov = np.array([i.coverage for i in infos])
        seg_maf = np.array([i.maf for i in infos])
        seg_w = np.array([i.weight for i in infos])
        if clustering_mode == "MeanShift":
            # windows with valid MAF, scaled (cov/400, maf) (:1722-1768)
            from canvas_tpu_torch.ops import meanshift as ms

            scale = 400.0
            win_pts = np.array([[w.coverage / scale, w.maf]
                                for w, _ in windowed if w.maf >= 0])
            if len(win_pts):
                res = ms.mean_shift(win_pts)
                good, centroids_cov, centroids_maf, centroids_size = \
                    ms.pruned_centers(res, res.labels, scale)
                relabel = {int(g): i + 1 for i, g in enumerate(good)}
                seg_labels = res.decide(
                    np.stack([seg_cov / scale, seg_maf], axis=1))
                cluster_ids = np.array(
                    [relabel.get(int(l), cl.OUTLIER_CLUSTER_FLAG)
                     for l in seg_labels])
                n_clusters = len(good)
        elif clustering_mode == "GaussianMixture":
            # best weighting factor + cluster count by silhouette, then EM
            # (:1701-1713)
            knn, knn_cut = cl.knearest_neighbour_cutoff(seg_cov, seg_maf, cw)
            max_lvl = float(np.percentile(seg_cov, 75))
            gmm_cw = best_coverage_weighting_factor(
                infos, max_lvl, median_coverage_level, knn, knn_cut)
            n_best, ids = best_num_clusters(
                infos, gmm_cw, knn, knn_cut, np.random.default_rng(0))
            if n_best > 0 and ids is not None:
                cluster_ids, n_clusters = ids, n_best
        else:  # Density
            knn, knn_cut = cl.knearest_neighbour_cutoff(seg_cov, seg_maf, cw)
            try:
                res = cl.density_cluster(seg_cov, seg_maf, seg_w, cw, knn_cut,
                                         centroid_cutoff=0.03)
                if res.n_clusters > 0:
                    cluster_ids, n_clusters = res.cluster_ids, res.n_clusters
            except ValueError:
                pass
        if n_clusters == 0:
            cluster_ids = None

    # purity search limits (:1885-1894): samples with >=50Mb clearly
    # non-reference get the 5% purity floor; cluster minor-allele coverage
    # bounds the low end of the purity grid
    not_all_ref = is_sample_clearly_not_all_reference_ploidy(
        infos, windowed, median_coverage_level, median_maf, ref_ploidy_fn)
    min_purity_hard_limit = 5 if not_all_ref else 20
    min_minor_allele_coverage = None
    if len(centroids_cov):
        min_windows = max(1, int(len(windowed) * 0.01))
        eligible = centroids_size > min_windows
        if eligible.any():
            min_minor_allele_coverage = float(
                np.min(centroids_cov[eligible] * centroids_maf[eligible]))

    model, _ = grid_search(
        infos, mean_coverage, genome_length, cw, median_coverage_level,
        min_purity_hard_limit=min_purity_hard_limit,
        min_minor_allele_coverage=min_minor_allele_coverage,
        user_purity=user_purity, cluster_ids=cluster_ids,
        n_clusters=n_clusters, device=device)

    ploidies = initialize_ploidies(mean_coverage)
    model_deviation(model, ploidies, infos, cw, cluster_ids, n_clusters,
                    mean_coverage)
    if debug_dir is not None:
        from pathlib import Path

        d = Path(debug_dir)
        d.mkdir(parents=True, exist_ok=True)
        write_cnv_modeling(d / "CNVModeling.txt", ploidies, infos, cw)
    if clustering_mode == "GaussianMixture" and run_clustering:
        # GMM mode assigns by posterior under per-ploidy Gaussians fitted
        # on the chosen model's points (AssignPloidyCallsGaussianMixture,
        # :2494-2540; the reference's gate is ploidies carrying Sigma from
        # the earlier EM runs — here the fit is re-run on the best model)
        comps, _ = fit_gaussians(model, infos, ploidies, cw)
        assign_ploidy_calls_gaussian_mixture(segments, model, ploidies,
                                             comps)
    else:
        assign_ploidy_calls(segments, model, ploidies, cw, ref_ploidy_fn)

    # heterogeneity marking via clonality scores on the best model
    # (:2566-2574, gated on evenness for WGS)
    heterogeneity_proportion = 0.0
    if cluster_ids is not None and not is_enrichment \
            and (evenness_score is None
                 or evenness_score >= EVENNESS_THRESHOLD):
        _, n_het, het_index, cms = cluster_deviation(
            infos, cluster_ids, n_clusters, ploidies, cw, mean_coverage)
        model.heterogeneity_index = het_index
        if n_het > 0:
            scores = clonality_scores(
                infos, cluster_ids, cms, ploidies, cw, n_clusters,
                model.deviation)
            het_bases = 0
            all_bases = 1
            marked = {id(infos[i].segment) for i, s in scores.items()
                      if s < 0.5}
            for seg in segments:
                all_bases += seg.length
                if id(seg) in marked:
                    seg.is_heterogeneous = True
                    het_bases += seg.length
            heterogeneity_proportion = het_bases / all_bases
    adjust_ploidy_calls(segments, model)

    if somatic_vafs is not None:
        snv_purity = estimate_purity_from_somatic_vafs(somatic_vafs)
        select_purity_estimate(model, segments, snv_purity)

    headers = [
        f"##EstimatedTumorPurity={model.purity:.2f}",
        f"##PurityModelFit={model.deviation:.4f}",
        f"##InterModelDistance={model.inter_model_distance:.4f}",
    ]
    if not is_enrichment:
        headers.append(
            f"##HeterogeneityProportion={heterogeneity_proportion:.2f}")
    return model, headers
