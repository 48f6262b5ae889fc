"""Germline-WGS, Somatic-WGS and GCContentWeighted binning on the CPU:
canvas_tpu_torch against canvas_tpu on the fixtures of tests/test_pipeline.py
(the germline CNV_PLAN sample, the somatic CN4 gain with MAF 0.25 het
sites, its matched normal and two controls), plus the somatic model grid's
torch path held against the numpy oracle."""

import gzip
from pathlib import Path

import numpy as np
import pytest
import torch

from canvas_tpu.io import bam as jax_bamio
from canvas_tpu.models import somatic as jax_somatic
from canvas_tpu.ops import binning as jax_binning
from canvas_tpu.pipeline import runner as jax_runner
from canvas_tpu.tools import evaluate_cnv
from canvas_tpu_torch.models import segment_model, somatic, somatic_grid
from canvas_tpu_torch.ops import binning
from canvas_tpu_torch.pipeline import cli
from canvas_tpu_torch.pipeline import runner as torch_runner
from tests.test_pipeline import (  # noqa: F401
    CNV_PLAN, L, make_bam, make_somatic_bam, reference_dir, simulate_reads)
from tests.test_torch_pipeline import PLANS, TYPES

torch.set_num_threads(1)

RUNNERS = {"jax": (jax_runner, {}), "torch": (torch_runner, {"device": "cpu"})}
SOMATIC_PLAN = {"chr1": [(80_000, 200_000, 4)]}
SOMATIC_MAF = {"chr1": [(80_000, 200_000, 0.25)]}


def _body(path: Path) -> list[bytes]:
    """Decompressed VCF lines without ##fileDate."""
    return [ln for ln in gzip.open(path).read().split(b"\n")
            if not ln.startswith(b"##fileDate")]


def _records(path: Path) -> list[bytes]:
    return [ln for ln in _body(path) if ln and not ln.startswith(b"#")]


def _ctx(which: str, ref: Path, out: Path, coverage_mode: str | None = None):
    runner, kw = RUNNERS[which]
    ctx = runner.WorkflowContext(reference_folder=str(ref),
                                 output_dir=str(out), **kw)
    if coverage_mode:
        ctx.config.coverage_mode = coverage_mode
    return runner, ctx


def _truth(path: Path, plan: dict) -> Path:
    path.write_text("".join(f"{c}\t{s}\t{e}\t{cn}\n"
                            for c, evs in plan.items() for s, e, cn in evs))
    return path


# --- Germline-WGS -----------------------------------------------------------

@pytest.fixture(scope="module")
def germline_bam(tmp_path_factory):
    bam = tmp_path_factory.mktemp("germline") / "sample.bam"
    make_bam(bam, np.random.default_rng(7), CNV_PLAN)
    return bam


@pytest.fixture(scope="module")
def germline_runs(reference_dir, germline_bam, tmp_path_factory):
    out = {}
    for which in RUNNERS:
        d = tmp_path_factory.mktemp(f"germline_{which}")
        runner, ctx = _ctx(which, reference_dir, d)
        out[which] = runner.germline_wgs(ctx,
                                         runner.Sample("s1", str(germline_bam)))
    return out


def test_germline_vcf_matches_canvas_tpu(germline_runs):
    assert _body(germline_runs["torch"]) == _body(germline_runs["jax"])


def test_germline_calls_planted_events(germline_runs, tmp_path):
    m = evaluate_cnv.evaluate(_truth(tmp_path / "truth.bed", CNV_PLAN),
                              germline_runs["torch"], passing_only=False)
    assert m.recall > 80.0 and m.precision > 80.0


@pytest.mark.parametrize("stage", ["CanvasBin_s1.binned.gz",
                                   "CanvasClean_s1.cleaned.gz",
                                   "s1.partitioned"])
def test_germline_stage_output_matches_canvas_tpu(germline_runs, stage):
    read = (lambda p: gzip.open(p).read()) if stage.endswith(".gz") \
        else (lambda p: p.read_bytes())
    got, want = (germline_runs[w].parent / "Checkpoints" / stage
                 for w in ("torch", "jax"))
    assert read(got) == read(want)


def test_germline_resume_equals_first_run(reference_dir, germline_bam,
                                          germline_runs):
    first = _body(germline_runs["torch"])
    _, ctx = _ctx("torch", reference_dir, germline_runs["torch"].parent)
    again = torch_runner.germline_wgs(
        ctx, torch_runner.Sample("s1", str(germline_bam)))
    assert _body(again) == first


def test_germline_profile_names_its_stages(germline_runs):
    import json

    prof = json.loads((germline_runs["torch"].parent
                       / "s1_profile.json").read_text())
    assert [s["name"] for s in prof["stages"]] == [
        "CanvasBin", "CanvasClean", "CanvasSNV", "CanvasPartition",
        "CanvasDiploidCaller"]


def test_cli_germline_writes_vcf(reference_dir, germline_bam, germline_runs,
                                 tmp_path):
    out = tmp_path / "cli"
    rc = cli.main(["Germline-WGS", "--device", "cpu", "-b", str(germline_bam),
                   "-n", "s1", "-r", str(reference_dir), "-o", str(out)])
    assert rc == 0
    assert _body(out / "s1_CNV.vcf.gz") == _body(germline_runs["torch"])


def test_run_partition_accepts_wavelets_refuses_hmm(reference_dir,
                                                    germline_runs, tmp_path):
    from canvas_tpu_torch.io.bins import BinSet

    _, ctx = _ctx("torch", reference_dir, tmp_path)
    bins = BinSet.read_text(germline_runs["torch"].parent / "Checkpoints"
                            / "CanvasClean_s1.cleaned.gz", ctx.contigs)
    parts = torch_runner.run_partition(ctx, {"s1": bins}, "Wavelets", True)
    assert len(parts["s1"]["chr1"]) > 2
    with pytest.raises(NotImplementedError, match="HMM"):
        torch_runner.run_partition(ctx, {"s1": bins}, "HMM", True)


# --- GCContentWeighted --------------------------------------------------------

def _gc_tracks(seed: int, length: int, weight_scale: float):
    """Tracks of one contig with GC weights spread around weight_scale."""
    rng = np.random.default_rng(seed)
    ratio = (rng.uniform(0.3, 3.0, 101) * weight_scale).astype(np.float32)
    return {"c": dict(possible=rng.random(length) < 0.8,
                      observed=rng.poisson(1.5, length).astype(np.uint8),
                      is_gc=rng.random(length) < 0.45,
                      offset=int(rng.integers(0, 1000)),
                      gc_weights=ratio[rng.integers(0, 101, length)])}


# (seed, length, bin size, weight scale) -> bins where canvas_tpu's float32
# segment sum lands on the other side of a .5 than the float64 row sum
# (ROADMAP Queue C, C2); every other bin is equal
GC_CASES = {
    (0, 400_000, 500, 1.0): [],
    (1, 300_001, 977, 0.05): [169],
    (2, 250_000, 311, 20.0): [],
}


@pytest.mark.parametrize("case", sorted(GC_CASES))
def test_gc_weighted_bin_sample_matches_canvas_tpu(case):
    seed, length, bs, scale = case
    tracks = _gc_tracks(seed, length, scale)
    got = binning.bin_sample(tracks, bs, mode="GCContentWeighted",
                             device="cpu")["c"]
    want = jax_binning.bin_sample(tracks, bs, mode="GCContentWeighted")["c"]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3].dtype == want[3].dtype == np.float32
    differ = np.flatnonzero(got[3] != want[3]).tolist()
    assert differ == GC_CASES[case]
    # where they differ, the port holds the float64 sum, rounded
    t = tracks["c"]
    vals = np.minimum(10, np.asarray(t["observed"], np.float32)
                      / t["gc_weights"])
    for k in differ:
        s, e = got[0][k], got[1][k]
        exact = np.sum(vals[s:e][t["possible"][s:e]], dtype=np.float64)
        assert got[3][k] == np.round(exact)
        assert abs(float(got[3][k]) - float(want[3][k])) == 1.0


def test_gc_weighted_bin_sample_empty_contig():
    tracks = _gc_tracks(3, 500, 1.0)
    got = binning.bin_sample(tracks, 1000, mode="GCContentWeighted",
                             device="cpu")["c"]
    assert all(len(a) == 0 for a in got)


@pytest.fixture(scope="module")
def gc_bam(tmp_path_factory):
    """test_gc_weighted_coverage_mode's sample: reads with tlen 300."""
    bam = tmp_path_factory.mktemp("gc") / "gc.bam"
    records = []
    for ci, contig in enumerate(("chr1", "chr2")):
        cn = np.full(L, 2, dtype=np.float64)
        for s, e, c in CNV_PLAN.get(contig, []):
            cn[s:e] = c
        recs = simulate_reads(np.random.default_rng(2000 + ci), L, cn)
        for r in recs:
            r.ref_id = ci
            r.tlen = 300
        records.extend(recs)
    jax_bamio.write_bam(bam, [("chr1", L), ("chr2", L)], records)
    return bam


@pytest.fixture(scope="module")
def gc_runs(reference_dir, gc_bam, tmp_path_factory):
    out = {}
    for which in RUNNERS:
        d = tmp_path_factory.mktemp(f"gc_{which}")
        runner, ctx = _ctx(which, reference_dir, d, "GCContentWeighted")
        out[which] = runner.germline_wgs(ctx, runner.Sample("gcw", str(gc_bam)))
    return out


def test_gc_weighted_germline_matches_canvas_tpu(gc_runs):
    assert _body(gc_runs["torch"]) == _body(gc_runs["jax"])
    got, want = (gzip.open(gc_runs[w].parent / "Checkpoints"
                           / "CanvasBin_gcw.binned.gz").read()
                 for w in ("torch", "jax"))
    assert got == want


def test_gc_weighted_counts_differ_from_tdr(reference_dir, gc_bam, gc_runs,
                                            tmp_path):
    """The weights reach the counts: the same sample under
    TruncatedDynamicRange bins to other counts."""
    from canvas_tpu_torch.io.bins import BinSet

    runner, ctx = _ctx("torch", reference_dir, tmp_path)
    tdr, _ = runner.run_bin(ctx, runner.Sample("gcw", str(gc_bam)))
    gcw = BinSet.read_text(gc_runs["torch"].parent / "Checkpoints"
                           / "CanvasBin_gcw.binned.gz", ctx.contigs)
    np.testing.assert_array_equal(tdr.start, gcw.start)
    assert not np.array_equal(tdr.count, gcw.count)


def test_gc_weighted_predefined_bins_match_canvas_tpu(reference_dir, gc_bam,
                                                      tmp_path):
    from canvas_tpu.io.manifest import Manifest as JaxManifest
    from canvas_tpu_torch.io.manifest import Manifest

    bed = tmp_path / "targets.bed"
    bed.write_text("".join(f"{c}\t{s}\t{s + 1000}\n" for c in ("chr1", "chr2")
                           for s in range(10_000, 290_000, 2000)))
    got_want = []
    for which, manifest_cls in (("torch", Manifest), ("jax", JaxManifest)):
        runner, ctx = _ctx(which, reference_dir, tmp_path / which,
                           "GCContentWeighted")
        got_want.append(runner.run_bin_predefined(
            ctx, runner.Sample("gcw", str(gc_bam)),
            manifest_cls.read(str(bed))))
    got, want = got_want
    for f in ("contig_id", "start", "end", "gc", "count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_gc_weighted_trio_bins_as_tdr(reference_dir, tmp_path):
    """ROADMAP Queue C, C1: under SmallPedigree-WGS canvas_tpu hands the
    observed counts to run_bin, so -m GCContentWeighted bins as
    TruncatedDynamicRange; the port does the same instead of raising."""
    bams = {}
    for name, plan in PLANS.items():
        bams[name] = tmp_path / f"{name}.bam"
        make_bam(bams[name], np.random.default_rng(11), plan)
    bodies = {}
    for which in RUNNERS:
        runner, ctx = _ctx(which, reference_dir, tmp_path / which,
                           "GCContentWeighted")
        vcf = runner.small_pedigree_wgs(
            ctx, [runner.Sample(n, str(b), sample_type=TYPES[n])
                  for n, b in bams.items()])
        bodies[which] = _body(vcf)
    assert bodies["torch"] == bodies["jax"]
    assert any(b"GAIN" in ln for ln in bodies["torch"])


# --- Somatic-WGS ----------------------------------------------------------------

@pytest.fixture(scope="module")
def somatic_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("somatic")
    tumor, vcf = d / "t.bam", d / "n.vcf"
    make_somatic_bam(tumor, vcf, SOMATIC_PLAN, SOMATIC_MAF)
    normal, c1, c2 = d / "normal.bam", d / "c1.bam", d / "c2.bam"
    make_bam(normal, np.random.default_rng(9), {})
    make_bam(c1, np.random.default_rng(10), {})
    make_bam(c2, np.random.default_rng(11), {})
    return {"tumor": tumor, "vcf": vcf, "normal": normal,
            "controls": [c1, c2]}


def _somatic(which, ref, out, inputs, case):
    runner, ctx = _ctx(which, ref, out)
    tumor = runner.Sample("tumor", str(inputs["tumor"]),
                          normal_vcf=str(inputs["vcf"]))
    if case == "tumor_normal":
        return runner.somatic_wgs(
            ctx, tumor, runner.Sample("tumor_N", str(inputs["normal"])))
    return runner.somatic_wgs(
        ctx, tumor, controls=[runner.Sample(f"tumor_C{i}", str(b))
                              for i, b in enumerate(inputs["controls"])])


SOMATIC_CASES = ["tumor_normal", "controls"]


@pytest.fixture(scope="module")
def somatic_runs(reference_dir, somatic_inputs, tmp_path_factory):
    out = {}
    for case in SOMATIC_CASES:
        for which in RUNNERS:
            d = tmp_path_factory.mktemp(f"{case}_{which}")
            out[case, which] = _somatic(which, reference_dir, d,
                                        somatic_inputs, case)
    return out


@pytest.mark.parametrize("case", SOMATIC_CASES)
def test_somatic_wgs_vcf_matches_canvas_tpu(somatic_runs, case):
    got = somatic_runs[case, "torch"]
    assert _body(got) == _body(somatic_runs[case, "jax"])
    calls = evaluate_cnv.load_cnv_calls(got)
    assert any(c.chrom == "chr1" and c.cn > 2 and c.start < 200_000
               and c.end > 80_000 for cl in calls.values() for c in cl)


@pytest.mark.parametrize("case", SOMATIC_CASES)
def test_somatic_wgs_outputs_match_canvas_tpu(somatic_runs, case):
    """The .cnd ratio file, the same checkpoint files (an EvennessMetric
    file in both or in neither), and the stage outputs byte for byte."""
    got, want = (somatic_runs[case, w].parent for w in ("torch", "jax"))
    assert (got / "tumor.cnd").read_bytes() == (want / "tumor.cnd").read_bytes()
    names = sorted(p.name for p in (got / "Checkpoints").iterdir())
    assert names == sorted(p.name for p in (want / "Checkpoints").iterdir())
    for name in names:
        if name.startswith(("CanvasBin", "CanvasClean", "Evenness",
                            "LocalSd")) or name.endswith(".partitioned"):
            read = gzip.open if name.endswith(".gz") else open
            with read(got / "Checkpoints" / name, "rb") as a, \
                    read(want / "Checkpoints" / name, "rb") as b:
                assert a.read() == b.read(), name


def test_somatic_wgs_controls_share_the_tumour_bin_size(somatic_runs):
    ck = somatic_runs["controls", "torch"].parent / "Checkpoints"
    sizes = {p.name: p.read_text() for p in ck.glob("*.binsize.txt")}
    assert len(sizes) == 3 and len(set(sizes.values())) == 1


@pytest.fixture(scope="module")
def training_runs(reference_dir, somatic_inputs, tmp_path_factory):
    """test_somatic_training_mode_empty_vcf_on_failure in both packages:
    the caller raises; production fails, training mode writes an empty
    VCF."""
    out = {}
    for which, mod in (("jax", jax_somatic), ("torch", somatic)):
        runner, _ = RUNNERS[which]

        def boom(*a, **k):
            raise mod.UncallableDataException("outside testable range")

        saved = mod.call_somatic
        mod.call_somatic = boom
        try:
            _, ctx = _ctx(which, reference_dir,
                          tmp_path_factory.mktemp(f"prod_{which}"))
            with pytest.raises(mod.UncallableDataException):
                runner.somatic_wgs(
                    ctx, runner.Sample("tumor", str(somatic_inputs["tumor"])))
            _, ctx = _ctx(which, reference_dir,
                          tmp_path_factory.mktemp(f"train_{which}"))
            ctx.config.somatic_training_mode = True
            out[which] = runner.somatic_wgs(
                ctx, runner.Sample("tumor", str(somatic_inputs["tumor"])))
        finally:
            mod.call_somatic = saved
    return out


def test_somatic_training_mode_writes_empty_vcf(training_runs):
    assert _records(training_runs["torch"]) == []
    assert _body(training_runs["torch"]) == _body(training_runs["jax"])


def test_cli_somatic_wgs_matches_library_run(reference_dir, somatic_inputs,
                                             somatic_runs, tmp_path):
    out = tmp_path / "cli"
    rc = cli.main(["Somatic-WGS", "--device", "cpu",
                   "-b", str(somatic_inputs["tumor"]), "-n", "tumor",
                   "--normal-bam", str(somatic_inputs["normal"]),
                   "--sample-b-allele-vcf", str(somatic_inputs["vcf"]),
                   "-r", str(reference_dir), "-o", str(out)])
    assert rc == 0
    assert _body(out / "tumor_CNV.vcf.gz") == \
        _body(somatic_runs["tumor_normal", "torch"])


# --- the somatic model grid ---------------------------------------------------

def _grid_infos(seed: int, n: int):
    rng = np.random.default_rng(seed)
    infos = []
    for i in range(n):
        seg = segment_model.Segment("chr1", i * 100_000, (i + 1) * 100_000,
                                    np.full(10, 1.0, np.float32))
        cov = float(rng.choice([20.0, 30.0, 40.0, 50.0]) + rng.normal(0, 1))
        maf = float(rng.uniform(0.1, 0.5)) if i % 4 else -1.0
        infos.append(somatic.SegmentInfo(seg, cov, maf,
                                         float(rng.uniform(1, 5))))
    return infos


@pytest.mark.parametrize("clusters", [False, True])
def test_evaluate_grid_device_matches_numpy(clusters):
    """tests/test_somatic_grid.py's comparison, on CPU tensors: equal CN
    assignments and best model, floats within 1e-12 relative."""
    cov = np.repeat(np.arange(20.0, 45.0), 4)
    pur = np.tile(np.array([0.3, 0.55, 0.8, 1.0]), 25)
    n = 160          # over 100 segments with a MAF: the cluster branch runs
    kw = {}
    if clusters:
        kw = dict(cluster_ids=np.random.default_rng(4).integers(1, 9, n),
                  n_clusters=8, mean_coverage=30.0)
    args = (cov, pur, _grid_infos(4, n), somatic.initialize_ploidies(30.0),
            0.02, 3_000_000)
    got = somatic_grid.evaluate_grid_device(*args, chunk=37, device="cpu",
                                            **kw)
    want = somatic_grid.evaluate_grid_numpy(*args, **kw)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["cns"], want["cns"])
    assert int(np.argmin(got["deviation"])) == int(np.argmin(want["deviation"]))
    for k in want:
        if k != "cns":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                       err_msg=k)
    if clusters:
        assert np.any(want["het_index"] > 0)


def test_evaluate_grid_takes_numpy_on_the_cpu(monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("the torch path ran for device='cpu'")

    monkeypatch.setattr(somatic_grid, "evaluate_grid_device", no_device)
    args = (np.arange(20.0, 30.0), np.full(10, 0.6), _grid_infos(2, 20),
            somatic.initialize_ploidies(25.0), 0.02, 2_000_000)
    got = somatic_grid.evaluate_grid(*args, device="cpu")
    want = somatic_grid.evaluate_grid_numpy(*args)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
