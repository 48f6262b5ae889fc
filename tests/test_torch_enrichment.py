"""Somatic-Enrichment and Tumor-normal-enrichment on the CPU:
canvas_tpu_torch against canvas_tpu on the enrichment fixture of
tests/test_pipeline.py (a CN4 gain on chr1 with MAF 0.25 het sites, 1 kb
targets every 2 kb), plus the copied numeric modules of the slice held
directly against their canvas_tpu counterparts."""

import gzip
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from canvas_tpu.io import bam as jax_bamio
from canvas_tpu.io.bins import BinSet as JaxBinSet
from canvas_tpu.io.manifest import Manifest as JaxManifest
from canvas_tpu.models import somatic as jax_somatic
from canvas_tpu.models import somatic_grid as jax_grid
from canvas_tpu.ops import ratio as jax_ratio
from canvas_tpu.ops import smooth as jax_smooth
from canvas_tpu.pipeline import runner as jax_runner
from canvas_tpu_torch.config import load_parameter_file
from canvas_tpu_torch.genome.contigs import ContigTable
from canvas_tpu_torch.io.bins import BinSet
from canvas_tpu_torch.io.manifest import Manifest
from canvas_tpu_torch.models import somatic, somatic_grid
from canvas_tpu_torch.ops import ratio, smooth
from benchmarks._synth import write_sample_bam
from canvas_tpu_torch.pipeline import runner as torch_runner
from tests.test_pipeline import (  # noqa: F401
    L, make_somatic_bam, reference_dir)

torch.set_num_threads(1)

PLAN = {"chr1": [(80_000, 200_000, 4)]}
MAF_PLAN = {"chr1": [(80_000, 200_000, 0.25)]}
MODES = ["Somatic-Enrichment", "Tumor-normal-enrichment"]
STAGES = ["CanvasBin_tumor.binned.gz", "CanvasClean_tumor.cleaned.gz",
          "tumor.partitioned"]


def _body(path: Path) -> list[bytes]:
    """Decompressed VCF lines without ##fileDate."""
    return [ln for ln in gzip.open(path).read().split(b"\n")
            if not ln.startswith(b"##fileDate")]


def _write_targets(path: Path) -> Path:
    lines = [f"{chrom}\t{s}\t{s + 1000}" for chrom in ("chr1", "chr2")
             for s in range(10_000, 290_000, 2000)]
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("enrichment")
    tumor, vcf, normal = d / "t.bam", d / "normal.vcf", d / "n.bam"
    make_somatic_bam(tumor, vcf, PLAN, MAF_PLAN)
    # a diploid normal at the tumour's read-start rate, written vectorised
    write_sample_bam(normal, {"chr1": L, "chr2": L}, 0.25, {}, seed=9)
    return {"tumor": tumor, "vcf": vcf, "normal": normal,
            "manifest": _write_targets(d / "targets.bed")}


def _run(runner, ref, out, inputs, mode, **ctx_kw):
    ctx = runner.WorkflowContext(reference_folder=str(ref),
                                 output_dir=str(out), **ctx_kw)
    tumor = runner.Sample("tumor", str(inputs["tumor"]),
                          normal_vcf=str(inputs["vcf"]))
    normal = runner.Sample("tumor_N", str(inputs["normal"])) \
        if mode == "Tumor-normal-enrichment" else None
    return runner.somatic_wgs(ctx, tumor, normal,
                              manifest_path=str(inputs["manifest"]))


@pytest.fixture(scope="module")
def runs(reference_dir, inputs, tmp_path_factory):
    out = {}
    for mode in MODES:
        oj = tmp_path_factory.mktemp("jax")
        ot = tmp_path_factory.mktemp("torch")
        _run(jax_runner, reference_dir, oj, inputs, mode)
        _run(torch_runner, reference_dir, ot, inputs, mode, device="cpu")
        out[mode] = (oj, ot)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_vcf_matches_canvas_tpu(runs, mode):
    oj, ot = runs[mode]
    body = _body(ot / "tumor_CNV.vcf.gz")
    assert body == _body(oj / "tumor_CNV.vcf.gz")
    gains = [ln for ln in body if ln.startswith(b"chr1\t")
             and b"GAIN" in ln]
    assert gains, "the planted CN4 gain is not called"


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("mode", MODES)
def test_stage_output_matches_canvas_tpu(runs, mode, stage):
    oj, ot = runs[mode]
    read = (lambda p: gzip.open(p).read()) if stage.endswith(".gz") \
        else (lambda p: p.read_bytes())
    assert read(ot / "Checkpoints" / stage) == read(oj / "Checkpoints" / stage)


def test_tumor_normal_ratio_file_matches(runs):
    oj, ot = runs["Tumor-normal-enrichment"]
    assert (ot / "tumor.cnd").read_bytes() == (oj / "tumor.cnd").read_bytes()


@pytest.mark.parametrize("mode", MODES)
def test_profile_names_host_cbs_engine(runs, mode):
    _, ot = runs[mode]
    prof = json.loads((ot / "tumor_profile.json").read_text())
    notes = [s for s in prof["stages"]
             if s["name"] == "CanvasPartitionCbsEngine"]
    assert notes and notes[0]["cbs_engine"] == "host"
    assert notes[0]["host_workers"] >= 1
    # the whole-recursion engine's work in the stage: none on the host path
    work = ("engine_calls", "arc_pairs", "walk_chunks", "graph_replays",
            "engine_reads")
    assert [notes[0][k] for k in work] == [0] * len(work)


def test_cli_tumor_normal_matches_library_run(reference_dir, inputs, runs,
                                              tmp_path, monkeypatch):
    """`python -m canvas_tpu_torch Tumor-normal-enrichment ...`, run as the
    interpreter runs it (runpy) but in this process, which has already
    computed the CBS stopping boundary."""
    _, ot = runs["Tumor-normal-enrichment"]
    out = tmp_path / "cli"
    monkeypatch.setattr(sys, "argv", [
        "canvas_tpu_torch", "Tumor-normal-enrichment", "--device", "cpu",
        "-b", str(inputs["tumor"]), "-n", "tumor",
        "--normal-bam", str(inputs["normal"]),
        "--sample-b-allele-vcf", str(inputs["vcf"]),
        "--manifest", str(inputs["manifest"]),
        "-r", str(reference_dir), "-o", str(out)])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("canvas_tpu_torch", run_name="__main__")
    assert done.value.code == 0
    assert _body(out / "tumor_CNV.vcf.gz") == _body(ot / "tumor_CNV.vcf.gz")


def test_cli_enrichment_needs_manifest(reference_dir, inputs, tmp_path,
                                      capsys):
    """Without --manifest an enrichment mode warns and runs whole-genome
    binning (Somatic-WGS), as canvas_tpu's CLI does."""
    from canvas_tpu.pipeline import cli as jax_cli
    from canvas_tpu_torch.pipeline import cli

    args = ["Somatic-Enrichment", "-b", str(inputs["tumor"]), "-n", "tumor",
            "--sample-b-allele-vcf", str(inputs["vcf"]),
            "-r", str(reference_dir)]
    assert jax_cli.main([*args, "-o", str(tmp_path / "jax")]) == 0
    capsys.readouterr()
    assert cli.main([*args, "--device", "cpu",
                     "-o", str(tmp_path / "torch")]) == 0
    assert "without --manifest" in capsys.readouterr().err
    assert _body(tmp_path / "torch" / "tumor_CNV.vcf.gz") == \
        _body(tmp_path / "jax" / "tumor_CNV.vcf.gz")
    assert not (tmp_path / "torch" / "tumor_profile.json").read_text() \
        .count("CanvasPartitionCbsEngine")


def _fragment_bam(path: Path) -> None:
    """Properly-paired fragments, CN4 over chr1:80-200 kb (the fixture of
    test_pipeline.test_fragment_coverage_mode_enrichment, at a third of its
    fragment rate)."""
    records = []
    k = 0
    for ci in range(2):
        cn = np.full(L, 2.0)
        for s, e, c in PLAN.get(f"chr{ci + 1}", []):
            cn[s:e] = c
        n_frag = np.random.default_rng(3000 + ci).poisson(0.04 * cn / 2.0)
        for pos in np.flatnonzero(n_frag):
            for _ in range(int(n_frag[pos])):
                mate = min(int(pos) + 250, L - 51)
                name = f"f{ci}_{k}"
                k += 1
                records.append(jax_bamio.BamRecord(
                    ci, int(pos), 50, 0x1 | 0x2 | 0x20, name, [(50, "M")],
                    "A" * 50, np.full(50, 30, np.uint8), ci, mate, 300))
                records.append(jax_bamio.BamRecord(
                    ci, mate, 50, 0x1 | 0x2 | 0x10, name, [(50, "M")],
                    "A" * 50, np.full(50, 30, np.uint8), ci, int(pos), -300))
    jax_bamio.write_bam(path, [("chr1", L), ("chr2", L)], records)


def test_fragment_mode_bins_match_canvas_tpu(reference_dir, inputs, tmp_path):
    bam = tmp_path / "frag.bam"
    _fragment_bam(bam)
    got_want = []
    for runner, manifest_cls, kw in (
            (torch_runner, Manifest, {"device": "cpu"}),
            (jax_runner, JaxManifest, {})):
        ctx = runner.WorkflowContext(reference_folder=str(reference_dir),
                                     output_dir=str(tmp_path / runner.__name__),
                                     **kw)
        ctx.config.coverage_mode = "Fragment"
        got_want.append(runner.run_bin_predefined(
            ctx, runner.Sample("frag", str(bam)),
            manifest_cls.read(str(inputs["manifest"]))))
    got, want = got_want
    for f in ("contig_id", "start", "end", "gc", "count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert float(got.count.sum()) > 0


# --- copied numeric modules, held directly against canvas_tpu -------------

def _binsets(seed: int, n_samples: int):
    """Random BinSets of both packages with the same bins and counts."""
    from canvas_tpu.genome.contigs import ContigTable as JaxContigTable

    rng = np.random.default_rng(seed)
    names, lengths = ("chr1", "chr2"), (400_000, 300_000)
    per = [150, 110]
    cid = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(per)])
    start = np.concatenate([np.arange(n, dtype=np.int64) * 2000 + 1000
                            for n in per])
    end = start + 1000
    gc = rng.integers(30, 60, len(cid)).astype(np.int32)
    out = []
    for _ in range(n_samples):
        count = rng.poisson(100, len(cid)).astype(np.float32)
        count[rng.integers(0, len(cid), 5)] = 0.0
        out.append((
            BinSet(ContigTable(names, lengths), cid, start, end, gc, count),
            JaxBinSet(JaxContigTable(names, lengths), cid, start, end, gc,
                      count)))
    return out


def _assert_binsets_equal(got, want):
    for f in ("contig_id", "start", "end", "gc", "count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("half_window", [1, 5])
def test_smooth_matches_canvas_tpu(half_window):
    (t, j), = _binsets(3, 1)
    _assert_binsets_equal(smooth.smooth(t, half_window),
                          jax_smooth.smooth(j, half_window))


@pytest.mark.parametrize("generator", ["WeightedAverage", "BestLR2"])
def test_ratio_matches_canvas_tpu(generator):
    sets = _binsets(5, 3)
    (t, j), controls = sets[0], sets[1:]
    if generator == "WeightedAverage":
        rt = ratio.weighted_average_reference([c[0] for c in controls])
        rj = jax_ratio.weighted_average_reference([c[1] for c in controls])
    else:
        rt = ratio.best_lr2_reference(t, [c[0] for c in controls])
        rj = jax_ratio.best_lr2_reference(j, [c[1] for c in controls])
    _assert_binsets_equal(rt, rj)
    lt, lj = ratio.lsnorm_ratios(t, rt), jax_ratio.lsnorm_ratios(j, rj)
    _assert_binsets_equal(lt, lj)
    _assert_binsets_equal(ratio.raw_ratios(t, rt), jax_ratio.raw_ratios(j, rj))
    ploidy = np.where(np.arange(len(lt)) % 7 == 0, 1.0, 2.0)
    _assert_binsets_equal(ratio.ratios_to_counts(lt, ploidy),
                          jax_ratio.ratios_to_counts(lj, ploidy))


def test_pca_reference_matches_canvas_tpu():
    (t, j), = _binsets(8, 1)
    rng = np.random.default_rng(8)
    mu = rng.normal(0, 0.1, len(t))
    axes = np.linalg.qr(rng.normal(size=(len(t), 3)))[0].T
    _assert_binsets_equal(ratio.pca_reference(t, axes, mu),
                          jax_ratio.pca_reference(j, axes, mu))


def _grid_infos(mod, seg_mod, seed: int, n: int):
    rng = np.random.default_rng(seed)
    infos = []
    for i in range(n):
        seg = seg_mod.Segment("chr1", i * 100_000, (i + 1) * 100_000,
                              np.full(10, 1.0, np.float32))
        cov = float(rng.choice([20.0, 30.0, 40.0, 50.0]) + rng.normal(0, 1))
        maf = float(rng.uniform(0.1, 0.5)) if i % 4 else -1.0
        infos.append(mod.SegmentInfo(seg, cov, maf, float(rng.uniform(1, 5))))
    return infos


@pytest.mark.parametrize("clusters", [False, True])
def test_evaluate_grid_numpy_matches_canvas_tpu(clusters):
    from canvas_tpu.models import segment_model as jax_seg
    from canvas_tpu_torch.models import segment_model as torch_seg

    cov = np.repeat(np.arange(20.0, 40.0), 3)
    pur = np.tile(np.array([0.4, 0.7, 1.0]), 20)
    n = 120
    kw = {}
    if clusters:
        kw = dict(cluster_ids=np.random.default_rng(4).integers(1, 4, n),
                  n_clusters=3, mean_coverage=30.0)
    got = somatic_grid.evaluate_grid_numpy(
        cov, pur, _grid_infos(somatic, torch_seg, 4, n),
        somatic.initialize_ploidies(30.0), 0.02, 3_000_000, **kw)
    want = jax_grid.evaluate_grid_numpy(
        cov, pur, _grid_infos(jax_somatic, jax_seg, 4, n),
        jax_somatic.initialize_ploidies(30.0), 0.02, 3_000_000, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_parameter_file_sets_somatic_constants(tmp_path):
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"MinimumCallSize": 12345, "cbs_alpha": 0.05}))
    saved = somatic.MINIMUM_CALL_SIZE
    try:
        cfg = load_parameter_file(p)
        assert somatic.MINIMUM_CALL_SIZE == 12345
        assert cfg.cbs_alpha == 0.05
    finally:
        somatic.MINIMUM_CALL_SIZE = saved
