"""The plain reference against the port's whole-recursion engine on CPU
tensors (its plain versions), on tiny samples: equal segments, contig by
contig."""

import time

import numpy as np
import pytest
import torch

from cnvbench import generator, spec
from cnvbench.tests.conftest import CpuSystem, tiny_tree

CPU = torch.device("cpu")
CBS = spec.load_partition("cbs")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    tree = tiny_tree(tmp_path_factory.mktemp("ref"))
    cell = spec.load_cell("tiny.cell", tree / "BENCHMARK.json",
                          tree / "cnvbench")
    return generator.make_pool(cell.config, cell.mix, 12345, CPU)


def test_reference_equals_the_engine_on_cpu_tensors(pool):
    system = CpuSystem()
    for sample in pool[:2]:
        got, info = system(sample)
        want = CBS.reference(sample, CPU)
        assert CBS.checkable(info)
        assert CBS.off(got, want) == 0
        assert all(int(np.sum(want[c])) == len(sample[c]) for c in sample)


def test_reference_finds_planted_steps():
    rng = np.random.default_rng(3)
    v = rng.normal(100.0, 5.0, 1500)
    v[500:800] += 30.0
    w = rng.normal(100.0, 5.0, 900)
    cov = {"a": np.rint(v).astype(np.float32),
           "b": np.rint(w).astype(np.float32)}
    out = CBS.reference(cov, CPU)
    assert out["a"].tolist() == [500, 300, 700]
    assert out["b"].tolist() == [900]


def test_reference_returns_none_past_the_table():
    """More leaves than max(64, 4 C) slots: the engine hands such an
    input to its frontier engine, which the reference does not model."""
    rng = np.random.default_rng(4)
    v = rng.normal(100.0, 2.0, 9000)
    for i in range(70):                       # 140 steps of 60 bins
        v[120 * i + 30:120 * i + 90] += 40.0
    t = time.perf_counter()
    assert CBS.reference({"a": np.rint(v).astype(np.float32)},
                         CPU) is None
    assert time.perf_counter() - t < 600
