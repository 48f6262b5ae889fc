"""Global configuration for canvas_tpu_torch.

Precision policy: the reference pipeline does all statistics in C# doubles.
Host statistics (medians, quartiles, NB tables) run in numpy float64; the
hot device ops (binning prefixes, Viterbi) are exact integer or f32
(max,+) arithmetic; the pedigree joint likelihood runs in float64 on the
run's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass
class CanvasConfig:
    """Tunable constants shared across stages.

    Mirrors the reference's JSON parameter files
    (CanvasPartitionParameters.json, PedigreeCallerParameters.json,
    SomaticCallerParameters.json, QualityScoreParameters.json); defaults are
    the reference defaults.
    """

    # CanvasBin (reference CanvasBin/Program.cs): median observed reads/bin.
    counts_per_bin: int = 100
    # Coverage mode cap (TruncatedDynamicRange; CanvasBin.cs:618-625)
    truncated_dynamic_range_cap: int = 10
    # CanvasBin -m/--mode (Utilities.ParseCanvasCoverageMode)
    coverage_mode: str = "TruncatedDynamicRange"
    # CanvasBin -z/--binsize: fixed bin size overriding the rate estimate
    fixed_bin_size: int | None = None

    # CanvasClean -m/--mode (MedianByGC | LOESS) and -w/--weightedmedian
    gc_norm_mode: str = "MedianByGC"
    min_bins_per_gc_weighted_median: int = 100

    # CanvasPartition -m/--method override (None = per-mode default)
    partition_method: str | None = None
    # Run the CanvasSmooth repeated-median filter on enrichment target bins
    # before T/N normalization.  Default OFF: the reference ships
    # CanvasSmooth as a standalone stage with no caller in its own
    # orchestration (only external ISAS wrappers invoke it), and smoothing
    # both samples independently creates zero-noise plateaus that break
    # CBS's permutation null (every plateau step tests as significant).
    smooth_enrichment_bins: bool = False

    # CanvasNormalize -m/--mode (WeightedAverage | BestLR2 | PCA)
    normalize_mode: str = "WeightedAverage"

    # CanvasSomaticCaller training mode: any modeling exception produces an
    # empty-but-valid VCF instead of failing (SomaticCaller.cs:409-422)
    somatic_training_mode: bool = False

    # CanvasPartition (CanvasPartitionParameters.json)
    max_inter_bin_dist_in_segment: int = 1000000
    mad_factor: float = 2.0
    cbs_alpha: float = 0.01
    evenness_score_threshold: float = 94.5
    evenness_score_window: int = 100000
    threshold_lower_maf: float = 0.05

    # HMM segmentation (HiddenMarkovModelsRunner.cs)
    hmm_states: int = 5
    hmm_self_transition: float = 0.99
    hmm_min_bins_per_chromosome: int = 10

    # Callers
    diploid_max_copy_number: int = 10            # CanvasDiploidCaller.cs:15
    diploid_coverage_weighting: float = 0.6      # CanvasDiploidCaller.cs:25
    median_het_snps_distance: int = 463          # CanvasDiploidCaller.cs:28
    quality_filter_threshold: int = 10           # CanvasDiploidCaller.cs:31
    pedigree_max_copy_number: int = 5            # PedigreeCallerParameters.json
    denovo_rate: float = 1e-5
    denovo_quality_threshold: int = 20
    # DefaultCaller (PedigreeCallerParameters.cs:25-27):
    # VariantCaller | HaplotypeVariantCaller
    pedigree_caller: str = "VariantCaller"

    # Q-score logistic coefficients (QualityScoreParameters.json)
    qscore: dict = field(default_factory=lambda: dict(DEFAULT_QSCORE_PARAMS))


# Reference QualityScoreParameters.json values.
DEFAULT_QSCORE_PARAMS = {
    "logistic_germline_intercept": -5.0123,
    "logistic_germline_log_bin_count": 4.9801,
    "logistic_germline_model_distance": -5.5472,
    "logistic_germline_distance_ratio": -1.7914,
    "logistic_intercept": -0.5143,
    "logistic_log_bin_count": 0.8596,
    "logistic_model_distance": -50.4366,
    "logistic_distance_ratio": -0.6511,
    "generalized_linear_fit_intercept": -3.65,
    "generalized_linear_fit_log_bin_count": -1.12,
    "generalized_linear_fit_model_distance": 3.89,
    "generalized_linear_fit_major_chromosome_count": 0.47,
    "generalized_linear_fit_maf_mean": -0.68,
    "generalized_linear_fit_log_maf_cv": -0.25,
}


DEFAULT = CanvasConfig()


def config_from_jax(cfg_dict: dict) -> CanvasConfig:
    """The port's CanvasConfig from `dataclasses.asdict()` of a canvas_tpu
    CanvasConfig.  The system has no learned weights; this is what carries
    a tuned configuration across.  numpy scalars in the qscore parameters
    become Python floats; unknown keys raise."""
    names = {f.name for f in dataclasses.fields(CanvasConfig)}
    unknown = set(cfg_dict) - names
    if unknown:
        raise ValueError(f"unknown CanvasConfig fields: {sorted(unknown)}")
    kwargs = dict(cfg_dict)
    kwargs["qscore"] = {k: float(v)
                        for k, v in cfg_dict.get(
                            "qscore", DEFAULT_QSCORE_PARAMS).items()}
    return CanvasConfig(**kwargs)


def resolve_device(device: str | torch.device) -> torch.device:
    """The run's device, as asked for: a CUDA device that is not there
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


# ---------------------------------------------------------------------------
# JSON parameter files (SURVEY.md §5 config tier 3): the reference ships
# SomaticCallerParameters.json / PedigreeCallerParameters.json /
# QualityScoreParameters.json / CanvasPartitionParameters.json next to the
# binaries and deserializes them at startup.  load_parameter_file applies a
# file of the same shape: CanvasConfig fields by snake_case name, somatic
# caller constants by their PascalCase JSON name.
# ---------------------------------------------------------------------------

# SomaticCallerParameters.json name -> canvas_tpu_torch.models.somatic
# attribute
SOMATIC_JSON_FIELDS = {
    "MaximumCopyNumber": "MAX_COPY_NUMBER",
    "MinimumVariantFrequenciesForInformativeSegment": "MIN_VF_FOR_INFORMATIVE",
    "CoverageWeighting": "COVERAGE_WEIGHTING",
    "CoverageWeightingWithMafSegmentation": "COVERAGE_WEIGHTING_WITH_MAF",
    "EvennessScoreThreshold": "EVENNESS_THRESHOLD",
    "MinEvennessScore": "MIN_EVENNESS",
    "LowerCoverageLevelWeightingFactor": "LOWER_COVERAGE_FACTOR",
    "UpperCoverageLevelWeightingFactor": "UPPER_COVERAGE_FACTOR",
    "DeviationFactor": "DEVIATION_FACTOR",
    "DeviationIndexCutoff": "DEVIATION_INDEX_CUTOFF",
    "PrecisionWeightingFactor": "PRECISION_WEIGHTING_FACTOR",
    "HeterogeneityWeight": "HETEROGENEITY_WEIGHT",
    "DistanceRatio": "DISTANCE_RATIO",
    "MinimumCallSize": "MINIMUM_CALL_SIZE",
}


def load_parameter_file(path, config: "CanvasConfig | None" = None
                        ) -> "CanvasConfig":
    """Apply a reference-style JSON parameter file.

    snake_case keys update CanvasConfig fields; PascalCase keys matching
    SomaticCallerParameters.json update the somatic module constants.
    Unknown keys raise (typos in tuned parameter files must not be
    silently ignored)."""
    import json
    from pathlib import Path

    from canvas_tpu_torch.models import somatic

    data = json.loads(Path(path).read_text())
    config = config or CanvasConfig()
    field_names = {f.name for f in dataclasses.fields(CanvasConfig)}
    for key, value in data.items():
        if key in field_names:
            setattr(config, key, value)
        elif key in SOMATIC_JSON_FIELDS:
            setattr(somatic, SOMATIC_JSON_FIELDS[key], value)
        elif key == "QualityScoreParameters":
            config.qscore.update(value)
        else:
            raise ValueError(f"unknown parameter {key!r} in {path}")
    return config
