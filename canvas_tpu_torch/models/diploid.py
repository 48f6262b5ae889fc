"""Germline single-sample copy-number caller (CanvasDiploidCaller).

Semantics (CanvasDiploidCaller/CanvasDiploidCaller.cs):
  * ploidy models for CN 0..10 × major chromosome count (:51-82), expected
    coverage = diploidCoverage * CN/2, expected MAF = majorCount/CN folded,
    balanced-CN MAF from the empirical EstimateDiploidMAF model
    (Utilities.cs:948-955), CN0 MAF = 0.01;
  * diploid coverage = MEAN of all bin counts (:305-309);
  * per segment: median coverage, median MAF when enough SNVs
    (>= max(10, length/463/2)), nearest model by weighted squared distance
    with coverage weight 0.6/diploidCoverage (:125-179);
  * q-scores via LogisticGermline; merge same-CN neighbors; re-score;
  * MCC left unset when <10 allele frequencies (:177).

The nearest-model assignment is a [n_segments, n_models] distance argmin —
computed in one vectorized pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from canvas_tpu_torch.models import qscore as qs
from canvas_tpu_torch.models.segment_model import (
    SEGMENT_SIZE_CUTOFF, Segment, merge_segments, set_filters)
from canvas_tpu_torch.ops import stats

MAX_COPY_NUMBER = 10                 # CanvasDiploidCaller.cs:15
COVERAGE_WEIGHTING = 0.6             # :25
MEDIAN_HET_SNPS_DISTANCE = 463       # :28
QUALITY_FILTER_THRESHOLD = 10        # :31


def estimate_diploid_maf(copy_number: int, mean_coverage: float) -> float:
    """Utilities.cs:948-955."""
    expected = copy_number * (mean_coverage / 2.0)
    return 0.5 - 1.0 / (3.352 * expected ** 0.4747)


@dataclass
class PloidyModel:
    copy_number: int
    major_count: int
    maf: float
    coverage: float = 0.0


def initialize_ploidies(mean_coverage: float) -> list[PloidyModel]:
    """CanvasDiploidCaller.InitializePloidies (:51-82)."""
    models = []
    for cn in range(MAX_COPY_NUMBER + 1):
        major = cn
        while major * 2 >= cn:
            if cn == 0:
                maf = 0.01
            else:
                vf = major / cn
                maf = vf if vf < 0.5 else 1 - vf
                if major * 2 == cn:
                    maf = estimate_diploid_maf(cn, mean_coverage)
            models.append(PloidyModel(cn, major, maf))
            major -= 1
    return models


def assign_ploidy_calls(
    segments: list[Segment],
    models: list[PloidyModel],
    diploid_coverage: float,
) -> None:
    """Nearest-model assignment (:125-179), vectorized over segments."""
    weight = COVERAGE_WEIGHTING / diploid_coverage
    model_cov = np.array([diploid_coverage * m.copy_number / 2.0 for m in models])
    model_maf = np.array([0.0 if math.isnan(m.maf) else m.maf for m in models])

    for seg in segments:
        mafs = seg.baf_frequencies.astype(np.float64)
        mafs = np.where(mafs > 0.5, 1 - mafs, mafs)
        cutoff = max(10, seg.length // MEDIAN_HET_SNPS_DISTANCE // 2)
        median_cov = stats.median(seg.bin_counts)
        use_maf = len(mafs) >= cutoff
        d = ((model_cov - median_cov) * weight) ** 2
        if use_maf:
            median_maf = stats.median(mafs)
            d = d + (model_maf - median_maf) ** 2
        order = np.argsort(d, kind="stable")
        best = int(order[0])
        seg.copy_number = models[best].copy_number
        seg.major_chromosome_count = models[best].major_count
        seg.model_distance = float(d[best])
        seg.runner_up_model_distance = float(d[order[1]]) if len(d) > 1 else np.inf
        if len(mafs) < 10:
            seg.major_chromosome_count = None


def call_variants(
    segments: list[Segment],
    quality_threshold: int = QUALITY_FILTER_THRESHOLD,
    qscore_params: dict | None = None,
    mean_allele_coverage: float | None = None,
) -> tuple[list[Segment], float]:
    """Full diploid calling pass (CallVariants :273-359 minus file I/O).

    `mean_allele_coverage` is the average SNV total depth used by the
    balanced-MAF model (reference sets MeanCoverage from the VF file,
    CanvasDiploidCaller.cs:298); defaults to 30 like the reference field.
    Returns (merged called segments, diploid coverage)."""
    all_counts = np.concatenate([s.bin_counts for s in segments]) \
        if segments else np.zeros(0, np.float32)
    diploid_coverage = float(np.mean(all_counts, dtype=np.float64))
    models = initialize_ploidies(mean_allele_coverage
                                 if mean_allele_coverage is not None else 30.0)
    assign_ploidy_calls(segments, models, diploid_coverage)
    qs.assign_quality_scores(segments, "LogisticGermline", qscore_params)
    merged = merge_segments(segments)
    qs.assign_quality_scores(merged, "LogisticGermline", qscore_params)
    set_filters(merged, quality_threshold, SEGMENT_SIZE_CUTOFF)
    return merged, diploid_coverage
