"""canvas_tpu_torch's stage functions run on the card unless the caller
asks for the CPU: called without a device where there is no CUDA device,
each raises instead of carrying on quietly on the CPU."""

import numpy as np
import pytest
import torch

from canvas_tpu_torch import graft_entry
from canvas_tpu_torch.models import pedigree, somatic, somatic_grid
from canvas_tpu_torch.ops import binning, cbs, cbs_device, hmm
from canvas_tpu_torch.parallel import mesh
from canvas_tpu_torch.pipeline import cli

COV = {"chr1": np.full(50, 100.0)}
CALLS = {
    "bin_sample": lambda: binning.bin_sample({}, 100),
    "batched_emissions": lambda: hmm.batched_emissions(COV),
    "segment_coverage_batched": lambda: hmm.segment_coverage_batched(COV),
    "run_cbs_device": lambda: cbs_device.run_cbs_device(COV),
    "run_cbs": lambda: cbs.run_cbs(COV),
    "pedigree_joint_likelihood_batched":
        lambda: pedigree.pedigree_joint_likelihood_batched(
            np.ones((1, 2, pedigree.MAX_COPY_NUMBER)),
            np.ones((1, 1, pedigree.MAX_COPY_NUMBER)),
            pedigree.transition_matrix()),
    "call_pedigree": lambda: pedigree.call_pedigree({}, {}),
    "bin_sample_gc_weighted": lambda: binning.bin_sample(
        {}, 100, mode="GCContentWeighted"),
    "evaluate_grid": lambda: somatic_grid.evaluate_grid(
        np.array([30.0]), np.array([1.0]), [], [], 0.1, 1_000_000),
    "call_somatic": lambda: somatic.call_somatic([], 1_000_000),
    "segment_coverage_joint_batched":
        lambda: hmm.segment_coverage_joint_batched(COV),
    "make_mesh": lambda: mesh.make_mesh(),
    "entry": lambda: graft_entry.entry(),
    "dryrun_multichip": lambda: graft_entry.dryrun_multichip(1),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_stage_function_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CALLS[name]()


@pytest.mark.parametrize("mode", ["Germline-WGS", "Somatic-WGS"])
def test_wgs_modes_default_to_the_card(mode, tmp_path, monkeypatch):
    """The CLI's default --device is cuda: without a card the run raises
    before it reads the reference."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "kmer.fa").write_text("")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main([mode, "-b", str(tmp_path / "s.bam"), "-n", "s",
                  "-r", str(tmp_path), "-o", str(tmp_path / "out")])
