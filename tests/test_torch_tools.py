"""The tools and the embedding wrapper of canvas_tpu_torch against
canvas_tpu on the CPU: EvaluateCNV, the copy-number oracle, the parameter
sweep, the somatic-model optimizer and the somatic-model plot reader on
tests/test_tools.py's inputs, and the wrapper on tests/test_wrapper.py's.
Every output is compared exactly (NaN equal to NaN)."""

import dataclasses
import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from canvas_tpu import wrapper as jax_wrapper
from canvas_tpu.models import segment_model as jax_sm
from canvas_tpu.models import somatic as jax_somatic
from canvas_tpu.tools import copy_number_oracle as jax_oracle
from canvas_tpu.tools import evaluate_cnv as jax_ec
from canvas_tpu.tools import optimize_somatic_model as jax_opt
from canvas_tpu.tools import plot_somatic_model as jax_plot
from canvas_tpu.tools import sweep_parameters as jax_sp
from canvas_tpu_torch import wrapper
from canvas_tpu_torch.genome.reference import write_fasta
from canvas_tpu_torch.models import segment_model as sm
from canvas_tpu_torch.models import somatic
from canvas_tpu_torch.tools import copy_number_oracle as oracle
from canvas_tpu_torch.tools import evaluate_cnv as ec
from canvas_tpu_torch.tools import optimize_somatic_model as opt
from canvas_tpu_torch.tools import plot_somatic_model as plot
from canvas_tpu_torch.tools import sweep_parameters as sp
from tests.test_pipeline import CNV_PLAN, make_bam, reference_dir  # noqa: F401

torch.set_num_threads(1)

HEADER = ["##fileformat=VCFv4.1",
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
LOSS_1000_2000 = ("chr1\t1000\tCanvas:LOSS:chr1:1001-2000\tN\t<CN0>\t30\tPASS"
                  "\tSVTYPE=CNV;END=2000\tGT:CN:QS:FT\t0/1:1:30:PASS")

# tests/test_tools.py's EvaluateCNV inputs: (truth bed, call records)
EVAL_CASES = {
    "perfect_calls": (
        "chr1\t1000\t2000\t1\nchr1\t5000\t6000\t3\n",
        [LOSS_1000_2000,
         "chr1\t2001\tCanvas:REF:chr1:2001-5000\tN\t.\t30\tPASS\tEND=5000"
         "\tGT:CN:QS:FT\t./.:2:30:PASS",
         "chr1\t5000\tCanvas:GAIN:chr1:5001-6000\tN\t<CN3>\t30\tPASS\t"
         "SVTYPE=CNV;END=6000\tGT:CN:QS:FT\t./1:3:30:PASS"]),
    "cn_above_max_clamps": (
        "chr1\t1000\t2000\t8\nchr1\t5000\t6000\t4\n",
        ["chr1\t1000\tCanvas:GAIN:chr1:1001-2000\tN\t<CN10>\t30\tPASS\t"
         "SVTYPE=CNV;END=2000\tGT:CN:QS:FT\t./1:10:30:PASS",
         "chr1\t5000\tCanvas:GAIN:chr1:5001-6000\tN\t<CN9>\t30\tPASS\t"
         "SVTYPE=CNV;END=6000\tGT:CN:QS:FT\t./1:9:30:PASS"]),
    "partial_overlap": (
        "chr1\t1000\t2000\t1\n",
        ["chr1\t1000\tCanvas:LOSS:chr1:1001-1500\tN\t<CN0>\t30\tPASS\t"
         "SVTYPE=CNV;END=1500\tGT:CN:QS:FT\t0/1:1:30:PASS"]),
    "false_positive": ("chr1\t1000\t2000\t2\n", [LOSS_1000_2000]),
    "size_split": (
        "chr1\t1000\t3000\t1\nchr1\t100000\t300000\t1\n",
        ["chr1\t1000\tCanvas:LOSS:chr1:1001-3000\tN\t<CN0>\t30\tPASS\t"
         "SVTYPE=CNV;END=3000\tGT:CN:QS:FT\t0/1:1:30:PASS",
         "chr1\t3001\tCanvas:REF:chr1:3001-300000\tN\t.\t30\tPASS\t"
         "END=300000\tGT:CN:QS:FT\t./.:2:30:PASS"]),
    "min_entry_size": (
        "chr1\t1000\t3000\t1\nchr1\t50000\t90000\t3\n",
        ["chr1\t1000\tCanvas:LOSS:chr1:1001-3000\tN\t<CN1>\t30\tPASS\t"
         "END=3000\tGT:CN:QS:FT\t0/1:1:30:PASS",
         "chr1\t50000\tCanvas:GAIN:chr1:50001-90000\tN\t<CN3>\t30\tPASS\t"
         "END=90000\tGT:CN:QS:FT\t./1:3:30:PASS"]),
}


def _files(tmp_path, truth, records):
    (tmp_path / "truth.bed").write_text(truth)
    (tmp_path / "calls.vcf").write_text("\n".join(HEADER + records) + "\n")
    return tmp_path / "truth.bed", tmp_path / "calls.vcf"


def _plain(x):
    """Dataclasses and arrays as plain containers for assert_equal."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _evaluations(module, truth, vcf, tmp_path):
    """Every EvaluateCNV entry point test_tools.py drives on one input."""
    out = {}
    for name, kw in (("all", {}), ("small", dict(min_size=0, max_size=4999)),
                     ("large", dict(min_size=100_000, max_size=499_999)),
                     ("min_entry", dict(min_entry_size=10_000,
                                        ploidy_fn=lambda c, s, e: 2))):
        m, counter = module.evaluate(truth, vcf, return_counter=True, **kw)
        out[name] = (_plain(m), counter.base_count.tolist(),
                     module.format_report(m, counter))
    roi = tmp_path / "roi.bed"
    roi.write_text("chr1\t1500\t2500\n")
    m, counter = module.evaluate(truth, vcf, roi_path=roi,
                                 return_counter=True)
    out["roi"] = (_plain(m), module.format_report(m, counter))
    excl = tmp_path / "excl.bed"
    excl.write_text("chr1\t1000\t1500\n")
    counter = module.BaseCounter()
    module.count_bases(module.load_truth_bed(truth),
                       module.load_cnv_calls(vcf), counter,
                       module.load_exclude_bed(excl))
    out["excluded"] = counter.base_count.tolist()
    kmer = tmp_path / "kmer.fa"
    write_fasta(kmer, {"chr1": "acgt" * 250})
    out["unmappable"] = _plain(module.evaluate(truth, vcf, kmer_fa=kmer))
    return out


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_cnv_matches_canvas_tpu(case, tmp_path):
    truth, vcf = _files(tmp_path, *EVAL_CASES[case])
    np.testing.assert_equal(_evaluations(ec, truth, vcf, tmp_path),
                            _evaluations(jax_ec, truth, vcf, tmp_path))


def test_evaluate_cnv_cli_matches_canvas_tpu(tmp_path):
    truth, vcf = _files(tmp_path, "chr1\t1000\t3000\t1\n",
                        [EVAL_CASES["size_split"][1][0]])
    (tmp_path / "empty.bed").write_text("")
    texts = {}
    for key, module in (("jax", jax_ec), ("torch", ec)):
        out = tmp_path / f"eval_{key}"
        assert module.main([str(truth), str(vcf),
                            str(tmp_path / "empty.bed"), str(out),
                            "--split-by-size", "--ploidy", "2",
                            "--min-size", "0"]) == 0
        texts[key] = {p.name: p.read_text() for p in sorted(out.iterdir())}
    assert texts["torch"] == texts["jax"]
    assert "Recall\t100.0000" in \
        texts["torch"]["EvaluateCNVResults_0kb_5kb.txt"]


def test_evaluate_cnv_loaders_match_canvas_tpu(tmp_path):
    """DQ filter, allele-pair truth rows with the het filter, truth VCFs,
    sex ploidy with a PAR bed and the callability metric."""
    dq = tmp_path / "dq.vcf"
    dq.write_text("\n".join(HEADER + [
        "chr1\t1000\tx\tN\t<CN0>\t30\tPASS\tEND=2000\tGT:CN:QS:FT:DQ\t"
        "0/1:1:30:PASS:25.0",
        "chr1\t3000\tx\tN\t<CN0>\t30\tPASS\tEND=4000\tGT:CN:QS:FT:DQ\t"
        "0/1:1:30:PASS:5.0",
        "chr1\t5000\tx\tN\t<CN0>\t30\tPASS\tEND=6000\tGT:CN:QS:FT\t"
        "0/1:1:30:PASS"]) + "\n")
    pairs = tmp_path / "pairs.bed"
    pairs.write_text("chr1\t1000\t2000\t0\t1\nchr1\t5000\t6000\t1\t1\t0.2\n"
                     "chr1\t8000\t9000\t1\t2\t0.9\n")
    tvcf = tmp_path / "truth.vcf"
    tvcf.write_text("\n".join([
        "##fileformat=VCFv4.1",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
        "chr1\t1000\t.\tN\t<CNV>\t.\tPASS\tCN=3;END=2000",
        "chr1\t5000\t.\tN\t<CNV>\t.\tPASS\tCN=2.5;END=6000",
        "chr1\t9000\t.\tN\t<CNV>\t.\tPASS\tCN=1.4;END=9500"]) + "\n")
    par = tmp_path / "par.bed"
    par.write_text("chrX\t0\t1000\nchrX\t5000\t6000\n")
    filt = tmp_path / "filter.bed"
    filt.write_text("chr1\t0\t100\nchr1\t900\t1000\n")
    probes = [("chrX", 100, 900), ("chrX", 2000, 4000), ("X", 2000, 4000),
              ("chrY", 0, 10_000), ("chr7", 0, 10_000), ("chrX", 900, 3000)]

    def run(module):
        calls = {"chr1": [
            module.CnvCall("chr1", 100, 500, 3, 2, "<CN3>", True),
            module.CnvCall("chr1", 400, 600, 1, 2, "<CN1>", True),
            module.CnvCall("chr1", 700, 800, 0, 2, "<CN0>", False)]}
        called, total = module.compute_callability(
            calls, filt, {"chr1": 1000, "chrY": 500}, exclude_chr_y=True)
        return _plain({
            "dq": module.load_cnv_calls(dq, dq_threshold=20.0),
            "pairs": module.load_truth_bed(pairs),
            "het": module.load_truth_bed(pairs, heterogeneity_fraction=0.5),
            "truth_vcf": module.load_known_cn(tvcf),
            "ploidy": [[module.sex_ploidy_fn(x, y, par)(*p) for p in probes]
                       for x, y in ((1, 1), (2, 0))],
            "callability": module.format_callability(called, total)})

    got = run(ec)
    np.testing.assert_equal(got, run(jax_ec))
    assert [iv["cn"] for iv in got["pairs"]["chr1"]] == [1, 2, 3]
    assert "Percent callability\t62.5000" in got["callability"]


def test_copy_number_oracle_matches_canvas_tpu(tmp_path):
    bed = tmp_path / "truth.bed"
    bed.write_text("chr1\t1000\t5000\t2\t1\nchr1\t8000\t9000\t1\t0\t0.4\n")
    vcf = tmp_path / "truth.vcf"
    vcf.write_text("\n".join([
        "##fileformat=VCFv4.1",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
        "chr2\t100\t.\tN\t<CNV>\t.\tPASS\tCN=2.5;END=900",
        "chr2\t2000\t.\tN\t<CNV>\t.\tPASS\tCN=4;END=3000"]) + "\n")
    spans = [("chr1", 1500, 4000), ("1", 8000, 9000), ("chr1", 4500, 12000),
             ("chr2", 100, 900), ("chr2", 2000, 3000)]

    def run(module, sm_):
        out = []
        for path in (bed, vcf):
            orc = module.CopyNumberOracle(path)
            segs = [sm_.Segment(c, s, e, np.zeros(1, np.float32))
                    for c, s, e in spans]
            segs[-1].copy_number = 4
            out.append([(orc.known_cn_for_segment(s),
                         orc.known_clonality_for_segment(s)) for s in segs])
            out.append(orc.accuracy_report(segs))
        return out

    got = run(oracle, sm)
    np.testing.assert_equal(got, run(jax_oracle, jax_sm))
    assert got[0][0][0] == 3 and got[2][3][0] == 3


def test_sweep_parameters_matches_canvas_tpu(tmp_path):
    grid = {"CanvasBin,-d": [50, 100],
            "CanvasPartition,-m": ["HMM", "Wavelets"]}

    def run_fn(sample, combo):
        if combo["CanvasBin,-d"] == 50 and sample == "s_crash":
            raise RuntimeError("boom")
        return combo

    def score_fn(sample, combo):
        return [1.0 - abs(combo["CanvasBin,-d"] - 100) / 100
                - (0.0 if combo["CanvasPartition,-m"] == "HMM" else 0.25)]

    out = {}
    for key, module in (("jax", jax_sp), ("torch", sp)):
        folder = tmp_path / key
        res = module.run_sweep(grid, run_fn, score_fn, ["s1", "s_crash"],
                               folder)
        out[key] = (module.combinations(grid), res,
                    {p.name: p.read_text() for p in sorted(folder.iterdir())})
    assert out["torch"] == out["jax"]
    assert sum("FAIL" in ln for ln in
               out["torch"][2]["ResultsSummary.txt"].splitlines()) == 2


def test_optimize_somatic_model_matches_canvas_tpu():
    """The greedy sweep over the port's somatic constants finds the same
    optimum, history and held-out score, and restores the constants."""
    results = {}
    for key, module, som in (("jax", jax_opt, jax_somatic),
                             ("torch", opt, somatic)):
        before = (som.DEVIATION_FACTOR, som.HETEROGENEITY_WEIGHT)

        def run_fn(sample, som=som):
            return (som.DEVIATION_FACTOR, som.HETEROGENEITY_WEIGHT)

        def score_fn(sample, out):
            df, hw = out
            return -((df - 2.0) ** 2 + (hw - 0.3) ** 2)

        grid = {"DeviationFactor": [1.0, 1.75, 2.0, 3.0],
                "HeterogeneityWeight": [0.1, 0.202, 0.3, 0.5]}
        res = module.sweep(grid, run_fn, score_fn, samples=[1, 2, 3, 4, 5])
        assert (som.DEVIATION_FACTOR, som.HETEROGENEITY_WEIGHT) == before
        results[key] = (res.best_params, res.best_score, res.history)
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == {"DeviationFactor": 2.0,
                                   "HeterogeneityWeight": 0.3}
    with pytest.raises(ValueError):
        opt.sweep({"NotAParam": [1]}, lambda s: None, lambda s, o: 0.0, [1])


@pytest.mark.parametrize("module", [sp, opt])
def test_tool_clis_need_the_card_by_default(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    (tmp_path / "manifest.tsv").write_text("")
    (tmp_path / "grid.json").write_text(json.dumps({}))
    argv = [str(tmp_path / "manifest.tsv"), str(tmp_path / "grid.json"),
            "-o", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(argv)


def test_plot_somatic_model_reader_matches_canvas_tpu(tmp_path):
    (tmp_path / "CNVModeling.txt").write_text(
        "#expected\n0.5\t60.0\tAB\n0.33\t90.0\tAAB\n\n#observed\n"
        "0.48\t61.5\n0.31\t88.0\n")
    got = plot.read_cnv_modeling(tmp_path / "CNVModeling.txt")
    assert got == jax_plot.read_cnv_modeling(tmp_path / "CNVModeling.txt")
    assert got[0][1] == (0.33, 90.0, "AAB") and len(got[1]) == 2
    # no CNVModeling.txt: the R script's message and no plot, and no
    # matplotlib import
    assert plot.plot_somatic_model(tmp_path / "missing", tmp_path) is None
    assert plot.main([str(tmp_path / "missing"), str(tmp_path)]) == 1


def test_wrapper_stub_and_gate_match_canvas_tpu(tmp_path):
    stub = tmp_path / "Sample_S1"
    got = wrapper.CanvasOutput.from_stub(stub)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_wrapper.CanvasOutput.from_stub(stub))
    assert got.cnv_vcf.name == "Sample_S1.vcf.gz" and not got.exists()
    caller = wrapper.GermlineWgsCnvCaller(reference_folder=str(tmp_path),
                                          device="cpu")
    with pytest.raises(FileNotFoundError):
        caller.run({"s": wrapper.GermlineWgsInput(bam="x.bam")},
                   tmp_path / "sandbox")


def test_wrapper_checkpoint_matches_canvas_tpu(reference_dir,  # noqa: F811
                                               tmp_path):
    """tests/test_wrapper.py's run-then-load on both packages: the moved
    VCFs have equal bodies, and the second run loads without the caller."""
    bam = tmp_path / "s.bam"
    make_bam(bam, np.random.default_rng(3), CNV_PLAN)
    bodies = {}
    for key, module, kw in (("jax", jax_wrapper, {}),
                            ("torch", wrapper, {"device": "cpu"})):
        caller = module.GermlineWgsCnvCaller(
            reference_folder=str(reference_dir), **kw)
        stub_dir = tmp_path / f"results_{key}"
        ran = module.CanvasCheckpoint(
            caller, stub_fn=lambda n: stub_dir / f"{n}_CNV").run(
            {"s1": module.GermlineWgsInput(bam=str(bam))},
            tmp_path / f"sandbox_{key}")
        assert ran["s1"].cnv_vcf == stub_dir / "s1_CNV.vcf.gz"
        assert ran["s1"].coverage_and_variant_frequencies.exists()
        bodies[key] = [ln for ln in gzip.open(ran["s1"].cnv_vcf, "rt")
                       if not ln.startswith("##fileDate")]
    assert bodies["torch"] == bodies["jax"]

    class Boom:
        def run(self, inputs, sandbox):
            raise AssertionError("caller must not re-run")

    stub_dir = tmp_path / "results_torch"
    loaded = wrapper.CanvasCheckpoint(
        Boom(), stub_fn=lambda n: stub_dir / f"{n}_CNV").run(
        {"s1": wrapper.GermlineWgsInput(bam=str(bam))},
        tmp_path / "sandbox2")
    assert loaded["s1"].cnv_vcf == Path(stub_dir / "s1_CNV.vcf.gz")
