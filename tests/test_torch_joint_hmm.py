"""The joint multi-sample HMM (CanvasPartition -m HMM) in canvas_tpu_torch
against canvas_tpu on the CPU: genotype combinations, the
genotype-permutation emission (bit for bit), the batched joint decode's
paths and breakpoints, the per-contig segment_coverage API, and the trio
through SmallPedigree-WGS with -m HMM (equal VCF bodies).

canvas_tpu's joint decode is its XLA chunked Viterbi (no Pallas), so the
large cases run at full speed on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from canvas_tpu.ops import hmm as jax_hmm
from canvas_tpu.pipeline import cli as jax_cli
from canvas_tpu_torch.ops import hmm
from canvas_tpu_torch.pipeline import cli
from tests.test_pipeline import make_bam, reference_dir  # noqa: F401
from tests.test_torch_pipeline import PLANS, TYPES, _body

torch.set_num_threads(1)

HMM_PARAM = ["--custom-parameters", "CanvasPartition,-m HMM"]


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_genotype_combinations_match_canvas_tpu(D):
    for state in range(hmm.N_STATES):
        assert hmm.genotype_combinations(D, state) == \
            jax_hmm.genotype_combinations(D, state)


def test_multivariate_poisson_likelihood_matches_canvas_tpu():
    rng = np.random.default_rng(3)
    for _ in range(20):
        means = rng.uniform(0.5, 200.0, 3)
        x = rng.poisson(means * rng.uniform(0.5, 1.5, 3)).astype(float)
        assert hmm.multivariate_poisson_likelihood(means, x) == \
            jax_hmm.multivariate_poisson_likelihood(means, x)
    # the reference's non-finite guard
    assert hmm.multivariate_poisson_likelihood([np.nan, 5.0], [3, 4]) == 0.0


def _emission_case(D, seed=7, T=600):
    rng = np.random.default_rng(seed + D)
    cov = rng.poisson(100.0, (T, D)).astype(np.float64)
    cov[100:220, 0] *= 1.5
    cov[300:380, -1] *= 0.5
    cov[450:470] = 0.0
    return jax_hmm.build_emission_tables(cov)


@pytest.mark.parametrize("use_all_states", [True, False])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_emission_log_probs_bit_equal_to_canvas_tpu(D, use_all_states):
    """Bit for bit (int32 views equal); both within 1e-5 (absolute and
    relative) of the float64 host oracle, whose sums round differently."""
    tables, _, clamped = _emission_case(D)
    T = clamped.shape[0]
    mask = np.ones((1, T), bool)
    mask[0, T - 50:] = False
    x = clamped.astype(np.float32)[None]
    want = np.asarray(jax_hmm.emission_log_probs(
        jnp.asarray(x), tables, jnp.asarray(mask),
        use_all_states=use_all_states))
    got = hmm.emission_log_probs(torch.as_tensor(x), tables,
                                 torch.as_tensor(mask),
                                 use_all_states=use_all_states).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    oracle = hmm._emission_log_probs_np(clamped, tables, use_all_states)
    np.testing.assert_allclose(oracle, jax_hmm._emission_log_probs_np(
        clamped, tables, use_all_states), rtol=0, atol=0)
    np.testing.assert_allclose(got[0, :T - 50], oracle[:T - 50], rtol=1e-5,
                               atol=1e-5)
    if not use_all_states:
        # the grouped tables tie states 0/1 and 3/4 in every bin
        assert np.array_equal(got[..., 0], got[..., 1])
        assert np.array_equal(got[..., 3], got[..., 4])


def _test_hmm_joint_input():
    """tests/test_hmm.py::test_joint_batched_matches_percontig's input."""
    rng = np.random.default_rng(1234)
    cov = {}
    for i in range(3):
        T = 400 + 100 * i
        base = rng.poisson(100, size=(T, 2)).astype(np.float64)
        base[120:200] *= 1.6   # shared gain
        cov[f"chr{i}"] = base
    return cov


def _test_hmm_1d_input():
    """tests/test_hmm.py::test_joint_batched_accepts_1d_input's input."""
    cov1 = np.random.default_rng(1234).poisson(100, size=500).astype(
        np.float64)
    cov1[100:200] *= 2
    return {"chr1": cov1}


def _multichunk_input():
    """Four contigs of a trio, 2,000-9,000 bins (up to 36 chunks of 256),
    with shared and private gains and losses, a homozygous deletion and a
    contig too short to decode."""
    rng = np.random.default_rng(21)
    cov = {}
    for i, T in enumerate((9_000, 4_500, 6_001, 2_000)):
        c = rng.poisson(100.0, (T, 3)).astype(np.float64)
        for s in rng.integers(0, T - 400, 6):
            who = rng.integers(0, 3, int(rng.integers(1, 4)))
            c[s:s + int(rng.integers(30, 300)), who] *= rng.choice(
                [0.5, 1.5, 2.0])
        c[T // 2:T // 2 + 40] = 0.0
        cov[f"chr{i + 1}"] = c
    cov["chrM"] = rng.poisson(100.0, (8, 3)).astype(np.float64)
    return cov


JOINT_INPUTS = {"test_hmm_joint": _test_hmm_joint_input,
                "test_hmm_1d": _test_hmm_1d_input,
                "multichunk_trio": _multichunk_input}


@pytest.mark.parametrize("case", sorted(JOINT_INPUTS))
def test_joint_batched_matches_canvas_tpu(case):
    cov = JOINT_INPUTS[case]()
    got = hmm.segment_coverage_joint_batched(cov, device="cpu")
    want = jax_hmm.segment_coverage_joint_batched(cov)
    assert got == want
    assert any(len(b) >= 2 for b in got.values())


def test_joint_paths_match_canvas_tpu_decode():
    """The multi-chunk trio's paths: the port's emissions and decode (plain
    B2/B3 and the sequential chunk scan) against canvas_tpu's emissions and
    its chunked decode (an associative scan over chunks), lane for lane."""
    cov = _multichunk_input()
    live, lengths, em, mask, lt, li = hmm.joint_emissions(cov, device="cpu")
    assert em.shape == (4, 16_384, 5) and len(live) == 4
    want_em = np.zeros(em.shape, np.float32)
    for b, n in enumerate(live):
        tables, _, clamped = jax_hmm.build_emission_tables(cov[n])
        want_em[b, :lengths[n]] = np.asarray(jax_hmm.emission_log_probs(
            jnp.asarray(clamped, jnp.float32)[None], tables,
            jnp.ones((1, lengths[n]), bool), use_all_states=False))[0]
    np.testing.assert_array_equal(em.numpy().view(np.int32),
                                  want_em.view(np.int32))
    got = hmm.viterbi_decode_chunked(em, mask, lt, li).numpy()
    want = np.asarray(jax_hmm.viterbi_decode_chunked(
        jnp.asarray(want_em), jnp.asarray(lt), jnp.asarray(li),
        jnp.asarray(mask.numpy())))
    np.testing.assert_array_equal(got, want)
    # tied states: the first of each pair wins everywhere
    assert not np.isin(got[mask.numpy()], (1, 4)).any()


@pytest.mark.parametrize("per_sample", [True, False])
def test_segment_coverage_matches_canvas_tpu(per_sample):
    cov = _test_hmm_joint_input()
    cov["chrS"] = cov["chr0"][:9]          # at most min_size bins
    got = hmm.segment_coverage(cov, per_sample=per_sample, device="cpu")
    assert got == jax_hmm.segment_coverage(cov, per_sample=per_sample)
    assert got["chrS"] == [0]


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cov = _test_hmm_1d_input()
    for fn in (hmm.segment_coverage_joint_batched, hmm.joint_emissions):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(cov)
    with pytest.raises(RuntimeError, match="is_available"):
        hmm.segment_coverage({"c": cov["chr1"][:, None]})


@pytest.fixture(scope="module")
def hmm_trio(reference_dir, tmp_path_factory):  # noqa: F811
    """test_torch_pipeline.py's trio through the CLI of each package with
    -m HMM."""
    d = tmp_path_factory.mktemp("hmm_trio")
    bams = {}
    for name, plan in PLANS.items():
        bams[name] = d / f"{name}.bam"
        make_bam(bams[name], np.random.default_rng(11), plan)
    args = ["SmallPedigree-WGS", "--bams", *map(str, bams.values()),
            "--names", *bams, "--types", *[TYPES[n] for n in bams],
            "-r", str(reference_dir), *HMM_PARAM]
    assert jax_cli.main([*args, "-o", str(d / "jax")]) == 0
    assert cli.main([*args, "-o", str(d / "torch"), "--device", "cpu"]) == 0
    return d / "jax", d / "torch"


@pytest.mark.parametrize("vcf", ["CNV.vcf.gz", "father_CNV.vcf.gz",
                                 "mother_CNV.vcf.gz", "proband_CNV.vcf.gz"])
def test_hmm_trio_vcf_matches_canvas_tpu(hmm_trio, vcf):
    out_jax, out_torch = hmm_trio
    assert _body(out_torch / vcf) == _body(out_jax / vcf)


def test_hmm_trio_segments_are_shared(hmm_trio):
    """One joint segmentation serves every sample: the .partitioned files
    have the same segment boundaries, and the shared gain is called."""
    _, out_torch = hmm_trio
    bounds = {}
    for name in PLANS:
        rows = [ln.split("\t") for ln in
                (out_torch / "Checkpoints" / f"{name}.partitioned")
                .read_text().splitlines() if ln]
        bounds[name] = [(r[0], r[1], r[2], r[4]) for r in rows]
    assert bounds["father"] == bounds["mother"] == bounds["proband"]
    body = b"\n".join(_body(out_torch / "CNV.vcf.gz")).decode()
    assert "GAIN" in body
