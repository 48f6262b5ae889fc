"""Exhaustive caller-flag sweep (Src/Canvas/SweepParameters.py).

Where optimize_somatic_model is the reference's greedy JSON-parameter
trainer, this is its simpler sibling: enumerate the full cartesian product
of candidate flag values, run the workflow once per combination with the
values passed through the --custom-parameters mechanism, score each run
with EvaluateCNV, and write ParamSweep/ResultsSummary.txt with one line per
combination (SweepParameters.py:20-89 builds `-x "<flags>"` command lines
and summarizes each run's min/mean accuracy + event count).
"""

from __future__ import annotations

import itertools
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np


def combinations(param_grid: dict[str, list]) -> list[dict]:
    """All flag-value combinations, in the reference's odometer order
    (last flag varies fastest; SweepParameters.py:21-46)."""
    names = list(param_grid)
    return [dict(zip(names, values))
            for values in itertools.product(*(param_grid[n] for n in names))]


def run_sweep(param_grid: dict[str, list], run_fn, score_fn,
              samples: list, sweep_folder: str | Path) -> list[dict]:
    """Run every combination over the corpus.

    run_fn(sample, combo) -> caller output path; score_fn(sample, output)
    -> list of metric values (EvaluateCNV rows).  Each combination gets a
    ResultsN.txt with its per-sample metrics; ResultsSummary.txt collects
    <index> <values...> <min> <mean> per combination (the reference tracks
    AccuracyMin / AccuracyMean / EventMean; a crashed run logs FAIL)."""
    folder = Path(sweep_folder)
    folder.mkdir(parents=True, exist_ok=True)
    combos = combinations(param_grid)
    results = []
    with open(folder / "ResultsSummary.txt", "w") as summary:
        summary.write("#Index\t" + "\t".join(param_grid) +
                      "\tScoreMin\tScoreMean\n")
        for idx, combo in enumerate(combos):
            desc = "\t".join(str(combo[n]) for n in param_grid)
            values: list[float] = []
            failed = False
            try:
                for sample in samples:
                    out = run_fn(sample, combo)
                    values.extend(float(v) for v in score_fn(sample, out))
            except Exception:
                failed = True
            with open(folder / f"Results{idx}.txt", "w") as f:
                for v in values:
                    f.write(f"{v}\n")
            if failed or not values:
                summary.write(f"{idx}\t{desc}\tFAIL\n")
                results.append({"combo": combo, "failed": True})
                continue
            lo, mean = float(np.min(values)), float(np.mean(values))
            summary.write(f"{idx}\t{desc}\t{lo:.4f}\t{mean:.4f}\n")
            results.append({"combo": combo, "min": lo, "mean": mean,
                            "failed": False})
    return results


def main(argv=None) -> int:
    """CLI: sweep workflow flag combinations over a training manifest.

    The manifest TSV lists one sample per line:
    <bam>\t<reference_dir>\t<truth_bed>[\t<b_allele_vcf>]
    The grid JSON maps custom-parameter flags to candidate values, e.g.
    {"CanvasBin,-d": [75, 100, 125], "CanvasPartition,-m": ["HMM",
    "Wavelets"]} — each key is the "<Tool>,<flag>" form accepted by
    --custom-parameters.
    """
    import argparse

    from canvas_tpu_torch.config import CanvasConfig, resolve_device
    from canvas_tpu_torch.pipeline import custom_params, runner
    from canvas_tpu_torch.tools import evaluate_cnv

    p = argparse.ArgumentParser(prog="sweep_parameters")
    p.add_argument("manifest", help="TSV of samples to score")
    p.add_argument("grid_json", help='JSON {"Tool,-flag": [values]}')
    p.add_argument("-o", "--output", default="ParamSweep",
                   help="sweep folder (default ParamSweep)")
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
            "bam": fields[0], "reference": fields[1], "truth": fields[2],
            "b_allele_vcf": fields[3] if len(fields) > 3 else None,
        })
    grid = json.loads(Path(args.grid_json).read_text())

    def run_fn(sample, combo):
        scratch = Path(tempfile.mkdtemp(prefix="param_sweep_"))
        sample["_scratch"] = scratch
        config = CanvasConfig()
        entries = [f"{tool_flag} {value}"
                   for tool_flag, value in combo.items()]
        custom_params.apply_custom_parameters(
            config, custom_params.parse_custom_parameters(entries))
        ctx = runner.WorkflowContext(
            reference_folder=sample["reference"], output_dir=str(scratch),
            config=config, resume=False, device=args.device)
        tumor = runner.Sample("t", sample["bam"],
                              normal_vcf=sample["b_allele_vcf"])
        return runner.somatic_wgs(ctx, tumor)

    def score_fn(sample, vcf_path):
        try:
            m = evaluate_cnv.evaluate(sample["truth"], vcf_path,
                                      passing_only=False)
            return [0.0 if np.isnan(m.f1) else m.f1]
        finally:
            shutil.rmtree(sample.pop("_scratch", ""), ignore_errors=True)

    results = run_sweep(grid, run_fn, score_fn, samples, args.output)
    ok = [r for r in results if not r["failed"]]
    best = max(ok, key=lambda r: r["mean"]) if ok else None
    print(json.dumps({"combinations": len(results),
                      "failed": len(results) - len(ok),
                      "best": best}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
