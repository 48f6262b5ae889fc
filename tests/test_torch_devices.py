"""canvas_tpu_torch's stage functions run on the card unless the caller
asks for the CPU: called without a device where there is no CUDA device,
each raises instead of carrying on quietly on the CPU."""

import numpy as np
import pytest
import torch

from canvas_tpu_torch.models import pedigree
from canvas_tpu_torch.ops import binning, cbs, cbs_device, hmm

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
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_stage_function_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CALLS[name]()
