"""Common-CNV SetA/SetB segmentation (--common-cnvs-bed) in canvas_tpu_torch
against canvas_tpu on the CPU: tests/test_common_cnv.py's cases run through
both packages (equal regions, sets and choices, and the original
assertions), and tests/test_pipeline.py's common-CNV trio through
SmallPedigree-WGS with equal VCF bodies."""

import numpy as np
import pytest
import torch

from canvas_tpu.models import common_cnv as jax_cc
from canvas_tpu.models import pedigree as jax_ped
from canvas_tpu.models import segment_model as jax_sm
from canvas_tpu.pipeline import runner as jax_runner
from canvas_tpu_torch.models import common_cnv as cc
from canvas_tpu_torch.models import pedigree as ped
from canvas_tpu_torch.models import segment_model as sm
from canvas_tpu_torch.pipeline import runner as torch_runner
from tests.test_pipeline import make_bam, reference_dir  # noqa: F401
from tests.test_torch_pipeline import _body

torch.set_num_threads(1)

# package -> (common_cnv, pedigree, segment_model)
PACKAGES = {"jax": (jax_cc, jax_ped, jax_sm), "torch": (cc, ped, sm)}


def _seg(sm_, chrom, begin, end, mean=100.0, bin_size=1000):
    """tests/test_common_cnv.py's make_seg in the given package."""
    starts = np.arange(begin, end, bin_size)
    ends = np.minimum(starts + bin_size, end)
    rng = np.random.default_rng(begin)
    return sm_.Segment(chrom, begin, end,
                       rng.poisson(mean, len(starts)).astype(np.float32),
                       bin_starts=starts, bin_ends=ends)


def _bounds(segs):
    return None if segs is None else [(s.begin, s.end, s.is_common_cnv)
                                      for s in segs]


def _summary(regions):
    return [(_bounds(r.set_a), _bounds(r.set_b), r.selected)
            for r in regions]


def _within(pkg):
    cc_, _, sm_ = pkg
    canvas = [_seg(sm_, "chr1", 0, 100_000)]
    common = [_seg(sm_, "chr1", 30_000, 60_000)]
    common[0].is_common_cnv = True
    return cc_.merge_common_cnv_segments(canvas, common)


def _no_overlap(pkg):
    cc_, _, sm_ = pkg
    canvas = [_seg(sm_, "chr1", 0, 10_000), _seg(sm_, "chr1", 50_000, 60_000)]
    common = [_seg(sm_, "chr1", 20_000, 30_000)]
    return cc_.merge_common_cnv_segments(canvas, common)


def _identical(pkg):
    cc_, _, sm_ = pkg
    return cc_.merge_common_cnv_segments([_seg(sm_, "chr1", 10_000, 20_000)],
                                         [_seg(sm_, "chr1", 10_000, 20_000)])


def _small_common(pkg):
    cc_, _, sm_ = pkg
    return cc_.merge_common_cnv_segments([_seg(sm_, "chr1", 0, 100_000)],
                                         [_seg(sm_, "chr1", 30_000, 30_500)])


MERGE_CASES = {"common_within_canvas": _within,
               "no_overlap_passthrough": _no_overlap,
               "identical_coordinates_prefers_common": _identical,
               "small_common_skipped": _small_common}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_matches_canvas_tpu(case):
    got = MERGE_CASES[case](PACKAGES["torch"])
    assert _summary(got) == _summary(MERGE_CASES[case](PACKAGES["jax"]))
    # tests/test_common_cnv.py's assertions, on the port
    if case == "common_within_canvas":
        assert len(got) == 1
        assert [s.begin for s in got[0].set_a] == [0]
        assert [(s.begin, s.end) for s in got[0].set_b] == [
            (0, 30_000), (30_000, 60_000), (60_000, 100_000)]
    elif case == "no_overlap_passthrough":
        assert [("A" if r.set_b is None else "B") for r in got] == \
            ["A", "B", "A"]
    elif case == "identical_coordinates_prefers_common":
        assert len(got) == 1 and got[0].set_a is None
        assert got[0].set_b[0].begin == 10_000
    else:
        assert all(r.set_b is None for r in got)


def _choose(pkg, cnv: bool, forced: bool):
    """tests/test_common_cnv.py's choose_best_sets cases: a 45 kb loss
    inside a 90 kb canvas segment (cnv) or uniform coverage, and the
    forced SetB region."""
    cc_, ped_, sm_ = pkg
    rng = np.random.default_rng(1234)
    starts = np.arange(0, 90_000, 1000)
    ends = starts + 1000
    counts = rng.poisson(100, len(starts)).astype(np.float32)
    lo, hi = (22_000, 67_000) if cnv else (30_000, 60_000)
    if cnv:
        m = (starts >= lo) & (starts < hi)
        counts[m] = rng.poisson(50, m.sum())
    canvas_seg = sm_.Segment("chr1", 0, 90_000, counts, bin_starts=starts,
                             bin_ends=ends)
    common = cc_.common_segments_from_bed([(lo, hi)], "chr1", starts, ends,
                                          counts)
    regions = {"s1": cc_.merge_common_cnv_segments([canvas_seg], common)}
    stats = {"s1": ped_.SampleStats.from_segments(
        [_seg(sm_, "chr1", 0, 200_000, 100.0)])}
    models = {"s1": ped_.CopyNumberModel(5, stats["s1"].max_coverage,
                                         stats["s1"].mean_coverage, 60.0)}
    if forced:
        regions = {"s1": [cc_.OverlappingRegion(None, [common[0]])]}
    cc_.choose_best_sets(regions, stats, models, 5)
    return regions["s1"], cc_.resolve_regions(regions["s1"])


@pytest.mark.parametrize("cnv,forced", [(True, False), (True, True),
                                        (False, False)])
def test_choose_best_sets_matches_canvas_tpu(cnv, forced):
    regions, final = _choose(PACKAGES["torch"], cnv, forced)
    want_regions, want_final = _choose(PACKAGES["jax"], cnv, forced)
    assert _summary(regions) == _summary(want_regions)
    assert _bounds(final) == _bounds(want_final)
    for a, b in zip(final, want_final):
        np.testing.assert_array_equal(a.bin_counts, b.bin_counts)
    if forced:
        assert regions[0].selected == "B" and final[0].is_common_cnv
    else:
        assert regions[0].selected == "A"
        if cnv:
            assert [(s.begin, s.end) for s in regions[0].set_b] == [
                (0, 22_000), (22_000, 67_000), (67_000, 90_000)]
        else:
            assert len(final) == 1


@pytest.fixture(scope="module")
def common_trio(reference_dir, tmp_path_factory):  # noqa: F811
    """tests/test_pipeline.py::test_small_pedigree_with_common_cnvs's trio
    and bed through small_pedigree_wgs in each package."""
    d = tmp_path_factory.mktemp("common_trio")
    plan = {"chr1": [(80_000, 140_000, 3)]}
    bams = {}
    for name in ("father", "mother", "proband"):
        bams[name] = d / f"{name}.bam"
        make_bam(bams[name], np.random.default_rng(13),
                 plan if name != "mother" else {})
    bed = d / "common.bed"
    bed.write_text("chr1\t80000\t140000\n")
    types = {"father": "Father", "mother": "Mother", "proband": "Proband"}
    for key, runner, kw in (("jax", jax_runner, {}),
                            ("torch", torch_runner, {"device": "cpu"})):
        ctx = runner.WorkflowContext(reference_folder=str(reference_dir),
                                     output_dir=str(d / key), **kw)
        samples = [runner.Sample(n, str(b), sample_type=types[n])
                   for n, b in bams.items()]
        runner.small_pedigree_wgs(ctx, samples, common_cnvs_bed=str(bed))
    return d / "jax", d / "torch"


@pytest.mark.parametrize("vcf", ["CNV.vcf.gz", "father_CNV.vcf.gz",
                                 "mother_CNV.vcf.gz", "proband_CNV.vcf.gz"])
def test_common_cnv_trio_vcf_matches_canvas_tpu(common_trio, vcf):
    out_jax, out_torch = common_trio
    body = _body(out_torch / vcf)
    assert body == _body(out_jax / vcf)
    assert len([ln for ln in body if ln and not ln.startswith(b"#")]) >= 2
    if vcf == "CNV.vcf.gz":
        # the bed's interval became a common-CNV segment
        assert any(b"COMMONCNV" in ln for ln in body)
