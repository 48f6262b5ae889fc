"""The control: the plain reference with its values and cumulative sums
held in bfloat16 (the step below the engine's float32), put in the
program's place, must fail the check.  On the CPU at a size a test run
holds; on the card at the cells' own size (marked `cuda`)."""

import numpy as np
import pytest
import torch

from cnvbench import control, spec

CPU = torch.device("cpu")
CBS = spec.load_partition("cbs")


def _planted(seed: int) -> dict:
    """Three contigs of 2,000 bins of N(100, 10), rounded, each with one
    step of 30-430 bins."""
    rng = np.random.default_rng(seed)
    cov = {}
    for c in range(3):
        v = rng.normal(100.0, 10.0, 2000)
        a = rng.integers(100, 1500)
        v[a:a + rng.integers(30, 400)] += rng.choice([-15.0, 12.0])
        cov[f"c{c}"] = np.rint(v).astype(np.float32)
    return cov


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_control_fails_the_check(seed):
    cov = _planted(seed)
    want = CBS.reference(cov, CPU)
    got = CBS.control(cov, CPU)
    assert CBS.off(got, want) >= 1
    assert CBS.off(want, CBS.reference(cov, CPU)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["lowpass.tumour",
                                      "lowpass.low_purity"])
def test_control_fails_at_the_cells_size(card, workload):
    cell = spec.load_cell(workload)
    for seed in (11, 12, 13):
        r = control.readings(cell, seed, card, program=True)
        assert r["control_off"] > CBS.LIMIT
        assert r["program_off"] <= CBS.LIMIT
