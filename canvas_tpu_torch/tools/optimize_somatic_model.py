"""Somatic caller parameter training (Tools/scripts/
optimizeSomaticCanvasModel.py + SomaticCanvasModelWorkflow.py).

The reference sweeps SomaticCallerParameters.json one parameter at a time:
for each candidate value it re-runs the somatic caller over a training
corpus, scores each run with EvaluateCNV, keeps the n best values, and
iterates until converged (greedy coordinate descent with a held-out
cross-validation fraction).  This is the same loop with the caller invoked
in-process: parameters are module constants on canvas_tpu_torch.models.somatic,
overridden per evaluation and restored afterwards.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# SomaticCallerParameters.json fields exposed for sweeping -> module attr
SWEEPABLE = {
    "DeviationFactor": "DEVIATION_FACTOR",
    "DeviationIndexCutoff": "DEVIATION_INDEX_CUTOFF",
    "PrecisionWeightingFactor": "PRECISION_WEIGHTING_FACTOR",
    "CoverageWeighting": "COVERAGE_WEIGHTING",
    "MinimumVariantFrequenciesForInformativeSegment": "MIN_VF_FOR_INFORMATIVE",
    "HeterogeneityWeight": "HETEROGENEITY_WEIGHT",
    "MinimumCallSize": "MINIMUM_CALL_SIZE",
}


@dataclass
class SweepResult:
    best_params: dict[str, float]
    best_score: float
    history: list[dict] = field(default_factory=list)


def _set_params(overrides: dict[str, float]) -> dict[str, float]:
    """Apply overrides to the somatic module; returns the previous values."""
    from canvas_tpu_torch.models import somatic

    old = {}
    for name, value in overrides.items():
        attr = SWEEPABLE[name]
        old[name] = getattr(somatic, attr)
        setattr(somatic, attr, value)
    return old


def score_samples(run_fn, score_fn, samples: list) -> float:
    """Mean score over the corpus; a failed run scores 0 for that sample
    (the reference treats caller crashes as failed parameter points)."""
    scores = []
    for sample in samples:
        try:
            out = run_fn(sample)
            scores.append(float(score_fn(sample, out)))
        except Exception:
            scores.append(0.0)
    return float(np.mean(scores)) if scores else 0.0


def sweep(
    param_grid: dict[str, list[float]],
    run_fn,
    score_fn,
    samples: list,
    n_best: int = 2,
    cross_validation: float = 0.2,
    max_rounds: int = 3,
    rng: np.random.Generator | None = None,
) -> SweepResult:
    """Greedy coordinate descent over param_grid.

    run_fn(sample) -> caller output; score_fn(sample, output) -> higher is
    better (e.g. EvaluateCNV F-score).  A cross_validation fraction of the
    corpus is held out; the final reported score is on the held-out set
    (train score drives the search)."""
    rng = rng or np.random.default_rng(0)
    unknown = set(param_grid) - set(SWEEPABLE)
    if unknown:
        raise ValueError(f"unknown sweep parameters: {sorted(unknown)}")

    order = rng.permutation(len(samples))
    n_test = max(1, int(len(samples) * cross_validation)) \
        if len(samples) > 1 else 0
    test = [samples[i] for i in order[:n_test]]
    train = [samples[i] for i in order[n_test:]] or samples

    current: dict[str, float] = {}
    from canvas_tpu_torch.models import somatic
    for name in param_grid:
        current[name] = getattr(somatic, SWEEPABLE[name])

    history = []
    for round_idx in range(max_rounds):
        improved = False
        for name, values in param_grid.items():
            candidates = sorted(set(list(values) + [current[name]]),
                                key=float)
            scored = []
            for v in candidates:
                trial = dict(current)
                trial[name] = v
                old = _set_params(trial)
                try:
                    s = score_samples(run_fn, score_fn, train)
                finally:
                    _set_params(old)
                scored.append((s, v))
                history.append({"round": round_idx, "param": name,
                                "value": v, "train_score": s})
            scored.sort(key=lambda t: (-t[0], t[1]))
            best_score, best_value = scored[0]
            # keep the n best for the next refinement ring (the reference's
            # nbestParams); here they narrow the candidate list next round
            param_grid[name] = [v for _, v in scored[:n_best]]
            if best_value != current[name]:
                current[name] = best_value
                improved = True
        if not improved:
            break

    old = _set_params(current)
    try:
        final = score_samples(run_fn, score_fn, test or train)
    finally:
        _set_params(old)
    return SweepResult(dict(current), final, history)


def write_parameters_json(path: str | Path, params: dict[str, float]) -> None:
    """Persist the trained values in SomaticCallerParameters.json shape."""
    Path(path).write_text(json.dumps(params, indent=2) + "\n")


def main(argv=None) -> int:
    """CLI: optimize over prepared workspaces.

    The manifest TSV lists one training sample per line:
    <output_dir>\t<bam>\t<reference_dir>\t<truth_bed>[\t<b_allele_vcf>]
    Each evaluation re-runs the somatic workflow into a scratch dir and
    scores the VCF against the truth bed with EvaluateCNV's F-score."""
    import argparse
    import shutil
    import tempfile

    from canvas_tpu_torch.config import resolve_device
    from canvas_tpu_torch.pipeline import runner
    from canvas_tpu_torch.tools import evaluate_cnv

    p = argparse.ArgumentParser(prog="optimize_somatic_model")
    p.add_argument("manifest", help="TSV of training samples")
    p.add_argument("param_grid_json",
                   help="JSON {parameter: [candidate values]}")
    p.add_argument("-o", "--output", required=True,
                   help="where to write the trained parameter JSON")
    p.add_argument("--n-best", type=int, default=2)
    p.add_argument("--cross-validation", type=float, default=0.2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of every workflow run (default cuda; a "
                        "missing CUDA device is an error)")
    args = p.parse_args(argv)
    # a missing card raises here, not as a failed run of every sample
    resolve_device(args.device)

    samples = []
    for line in Path(args.manifest).read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        fields = line.split("\t")
        samples.append({
            "bam": fields[1], "reference": fields[2], "truth": fields[3],
            "b_allele_vcf": fields[4] if len(fields) > 4 else None,
        })
    param_grid = json.loads(Path(args.param_grid_json).read_text())

    def run_fn(sample):
        scratch = Path(tempfile.mkdtemp(prefix="somatic_sweep_"))
        try:
            ctx = runner.WorkflowContext(
                reference_folder=sample["reference"],
                output_dir=str(scratch), resume=False,
                device=args.device)
            tumor = runner.Sample("t", sample["bam"],
                                  normal_vcf=sample["b_allele_vcf"])
            return runner.somatic_wgs(ctx, tumor)
        finally:
            sample["_scratch"] = scratch

    def score_fn(sample, vcf_path):
        try:
            m = evaluate_cnv.evaluate(sample["truth"], vcf_path,
                                      passing_only=False)
            return 0.0 if np.isnan(m.f1) else m.f1
        finally:
            shutil.rmtree(sample.pop("_scratch", ""), ignore_errors=True)

    result = sweep(param_grid, run_fn, score_fn, samples,
                   n_best=args.n_best,
                   cross_validation=args.cross_validation)
    write_parameters_json(args.output, result.best_params)
    print(json.dumps({"best_params": result.best_params,
                      "held_out_score": result.best_score,
                      "evaluations": len(result.history)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
