"""Germline-WGS in several gloo processes through canvas_tpu_torch's CLI
on the CPU: each process scans its contig_shards subset of the BAM, the
read starts are all-gathered, and every process's VCF equals the port's
one-process run's and canvas_tpu's one-process run's on the same BAM (the
proband of the dryrun's trio: 4 contigs of 120 kbp, a CN 3 gain and a CN
1 loss).  Five processes for four contigs leave one owning nothing."""

import gzip
import json

import pytest

from canvas_tpu.parallel import distributed as jax_dist
from canvas_tpu.pipeline import runner as jax_runner
from canvas_tpu_torch import graft_entry
from canvas_tpu_torch.pipeline import runner as torch_runner
from tests.test_torch_parallel import run_group

GERMLINE_WORKER = """
import sys
from canvas_tpu_torch.pipeline import cli

bam, ref, out = sys.argv[1:4]
addr, n, rank = sys.argv[4:7]
raise SystemExit(cli.main([
    "Germline-WGS", "-b", bam, "-n", "proband", "-r", ref, "-o",
    f"{out}/p{rank}", "--device", "cpu", "--coordinator", addr,
    "--num-processes", n, "--process-id", rank]))
"""


def _body(path) -> list[bytes]:
    return [ln for ln in gzip.open(path).read().split(b"\n")
            if not ln.startswith(b"##fileDate")]


@pytest.fixture(scope="module")
def proband(tmp_path_factory):
    """The trio's proband BAM and reference, and the one-process VCFs of
    both packages."""
    base = tmp_path_factory.mktemp("mp")
    ref, bams = graft_entry.write_demo_trio(base)
    vcfs = {}
    for which, runner, kw in (("jax", jax_runner, {}),
                              ("torch", torch_runner, {"device": "cpu"})):
        ctx = runner.WorkflowContext(reference_folder=str(ref),
                                     output_dir=str(base / which), **kw)
        vcfs[which] = runner.germline_wgs(
            ctx, runner.Sample("proband", str(bams["proband"])))
    return {"ref": ref, "bam": bams["proband"], "base": base,
            "vcfs": vcfs}


def test_one_process_vcfs_equal_and_call_the_events(proband):
    body = _body(proband["vcfs"]["torch"])
    assert body == _body(proband["vcfs"]["jax"])
    records = [ln.split(b"\t") for ln in body if ln and not ln.startswith(b"#")]
    assert any(r[0] == b"chr1" and b"GAIN" in r[2] for r in records)
    assert any(r[0] == b"chr2" and b"LOSS" in r[2] for r in records)


@pytest.mark.parametrize("n", [4, 5])
def test_germline_in_gloo_processes_equals_one_process(proband, n,
                                                       tmp_path):
    res = run_group(n, ["-c", GERMLINE_WORKER, str(proband["bam"]),
                        str(proband["ref"]), str(tmp_path)], tmp_path)
    want = _body(proband["vcfs"]["jax"])
    lengths = {c: graft_entry.TRIO_LEN for c in graft_entry.TRIO_CONTIGS}
    owned = []
    for rank, (rc, _out, err) in enumerate(res):
        assert rc == 0, err
        assert f"multi-host: process {rank}/{n}" in err
        out = tmp_path / f"p{rank}"
        assert _body(out / "proband_CNV.vcf.gz") == want
        stages = json.loads((out / "proband_profile.json").read_text())
        scan = [s for s in stages["stages"] if s["name"] == "CanvasBinScan"]
        assert scan == [{"name": "CanvasBinScan", "seconds": 0.0,
                         "peak_rss_mb": 0.0, "process": rank,
                         "processes": n,
                         "contigs": jax_dist.contig_shards(lengths, n,
                                                           rank)}]
        owned.append(scan[0]["contigs"])
    assert sorted(c for o in owned for c in o) == sorted(lengths)
    assert owned.count([]) == n - len(lengths)


@pytest.mark.parametrize("extra", [
    ["--num-processes", "2", "--process-id", "0"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "2"],
])
def test_cli_refuses_an_incomplete_process_group(extra, tmp_path, capsys):
    """A run asked for several processes never runs alone: a process
    count or id without a coordinator, or an incomplete or out-of-range
    group, exits 2 before it reads anything."""
    from canvas_tpu_torch.pipeline import cli

    rc = cli.main(["Germline-WGS", "-b", str(tmp_path / "s.bam"), "-n", "s",
                   "-r", str(tmp_path), "-o", str(tmp_path / "out"),
                   "--device", "cpu", *extra])
    assert rc == 2
    assert "Error:" in capsys.readouterr().err
