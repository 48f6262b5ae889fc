"""The wavelet partition and the coverage metrics of canvas_tpu_torch
(host numpy copies) held bit for bit against canvas_tpu's on seeded
coverage: NB coverage with steps, an all-zero contig, interior zero runs
(homozygous deletions, N-gaps) and contigs of 1-11 bins."""

import numpy as np
import pytest

from canvas_tpu.ops import metrics as jax_metrics
from canvas_tpu.ops import wavelets as jax_wavelets
from canvas_tpu_torch.ops import metrics, wavelets


def _nb(rng, mean: float, n: int, size: float = 20.0) -> np.ndarray:
    """Negative-binomial counts of the given mean (dispersion `size`)."""
    return rng.negative_binomial(size, size / (size + mean), n).astype(
        np.float64)


def nb_steps(seed: int, n: int = 3_000) -> np.ndarray:
    """NB(100) coverage with a CN1 and a CN3 step."""
    rng = np.random.default_rng(seed)
    x = _nb(rng, 100.0, n)
    x[n // 5:n // 5 + n // 10] = _nb(rng, 50.0, n // 10)
    x[n // 2:n // 2 + n // 8] = _nb(rng, 150.0, n // 8)
    return x


def zero_runs(seed: int, n: int = 3_000) -> np.ndarray:
    """NB steps with interior exact-zero runs, one at the contig's end."""
    x = nb_steps(seed, n)
    x[700:900] = 0.0            # homozygous deletion
    x[1500:1503] = 0.0          # short N-gap
    x[n - 40:] = 0.0
    return x


CASES = {
    "nb_steps": lambda: nb_steps(1),
    "zero_runs": lambda: zero_runs(2),
    "all_zero": lambda: np.zeros(400),
    "two_bins": lambda: np.array([3.0, 9.0]),
    "ragged": lambda: nb_steps(3, 1_237),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decompose_tree_equal_bit_for_bit(case):
    x = CASES[case]()
    tree, smooth = wavelets.decompose(x)
    want_tree, want_smooth = jax_wavelets.decompose(x)
    assert smooth == want_smooth
    assert len(tree) == len(want_tree)
    for level, want in zip(tree, want_tree):
        np.testing.assert_array_equal(level, want)


def _coverage(seed: int) -> dict[str, np.ndarray]:
    """Several contigs, the short ones 1-11 bins long."""
    cov = {"chr1": nb_steps(seed), "chr2": zero_runs(seed + 1),
           "chr3": np.zeros(300)}
    rng = np.random.default_rng(seed)
    for n in range(1, 12):
        cov[f"chrS{n}"] = _nb(rng, 100.0, n)
    return cov


@pytest.mark.parametrize("germline", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_segment_coverage_breakpoints_equal(germline, seed):
    cov = _coverage(seed)
    cv = metrics.coverage_variability(cov, 100)
    cmads = metrics.factor_of_three_cmads(cov)
    got = wavelets.segment_coverage(cov, germline, cv, cmads)
    want = jax_wavelets.segment_coverage(
        cov, germline, jax_metrics.coverage_variability(cov, 100),
        jax_metrics.factor_of_three_cmads(cov))
    assert got == want
    assert len(got["chr1"]) > 2 and got["chrS5"] == []


@pytest.mark.parametrize("germline", [True, False])
def test_haar_wavelets_steps_equal(germline):
    """Each step of haar_wavelets on its own, with the MAD variability."""
    x = zero_runs(7)
    cmads = metrics.factor_of_three_cmads({"c": x})
    assert cmads == jax_metrics.factor_of_three_cmads({"c": x})
    tree, smooth = wavelets.decompose(x)
    jtree, jsmooth = jax_wavelets.decompose(x)
    wavelets.hard_threshold(tree, 30.0, germline)
    jax_wavelets.hard_threshold(jtree, 30.0, germline)
    for a, b in zip(tree, jtree):
        np.testing.assert_array_equal(a, b)
    rec = wavelets.reconstruct(tree, smooth)
    np.testing.assert_array_equal(rec, jax_wavelets.reconstruct(jtree, jsmooth))
    prelim = wavelets.breakpoints_from_reconstruction(rec)
    healed = wavelets.heal_bad_splits(prelim, x, cmads)
    assert healed == jax_wavelets.heal_bad_splits(prelim, x, cmads)
    assert wavelets.refine_segments(healed, x) == \
        jax_wavelets.refine_segments(healed, x)
    assert wavelets.haar_wavelets(x, 0.05, 80.0, germline, 2.0, None, cmads) \
        == jax_wavelets.haar_wavelets(x, 0.05, 80.0, germline, 2.0, None,
                                      cmads)


def _long_coverage(seed: int) -> dict[str, np.ndarray]:
    """Two contigs long enough for the 10,000-bin evenness windows."""
    rng = np.random.default_rng(seed)
    a = _nb(rng, 60.0, 80_000)
    a[20_000:26_000] = _nb(rng, 90.0, 6_000)
    b = _nb(rng, 60.0, 52_000)
    b[5_000:5_400] = 0.0
    return {"chr1": a, "chr2": b}


@pytest.mark.parametrize("window", [1_000, 12_000])
def test_coverage_variability_equal(window):
    """Above 10,000 bins the window's quartile gate runs as well."""
    cov = _long_coverage(11)
    got = metrics.coverage_variability(cov, window)
    assert got is not None
    assert got == jax_metrics.coverage_variability(cov, window)


def test_coverage_variability_too_few_bins():
    cov = {"chr1": nb_steps(4, 900)}
    assert metrics.coverage_variability(cov, 100) is None
    assert jax_metrics.coverage_variability(cov, 100) is None


@pytest.mark.parametrize("seed", [0, 3])
def test_factor_of_three_cmads_equal(seed):
    cov = _coverage(seed)
    got = metrics.factor_of_three_cmads(cov)
    assert got == jax_metrics.factor_of_three_cmads(cov)
    assert len(got) == 9


@pytest.mark.parametrize("window", [10_000, 25_000])
def test_evenness_score_equal(window):
    cov = _long_coverage(13)
    got = metrics.evenness_score(cov, window)
    assert np.isfinite(got)
    assert got == jax_metrics.evenness_score(cov, window)


def test_evenness_score_raises_alike_without_windows():
    """Coverage shorter than the 10,000-bin window has no scores, so no
    quartiles: both packages raise alike, which Somatic-WGS turns into a
    missing evenness."""
    cov = {"chr1": nb_steps(6)}
    with pytest.raises(IndexError):
        jax_metrics.evenness_score(cov)
    with pytest.raises(IndexError):
        metrics.evenness_score(cov)
