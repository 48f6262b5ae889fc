"""PerSampleHMM decode in canvas_tpu_torch against canvas_tpu: the plain
chunked decode (the plain versions of kernels B2 and B3 plus the torch
glue) against the Pallas decode in interpret mode and the numpy oracles,
and segment_coverage_batched breakpoints against canvas_tpu's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from canvas_tpu.ops import hmm as jax_hmm
from canvas_tpu.ops.viterbi_pallas import viterbi_decode_pallas
from canvas_tpu_torch.ops import hmm

torch.set_num_threads(1)

S = 5


def _problem(seed, B, T, uniform, integer_em, lengths):
    rng = np.random.default_rng(seed)
    log_em = rng.normal(size=(B, T, S)).astype(np.float32)
    if integer_em:
        # integer-valued emissions make exact ties in the (max,+) chain
        log_em = np.round(log_em * 2).astype(np.float32)
    if uniform:
        lt = np.asarray(jax_hmm.log_transition(S), np.float32)
    else:
        lt = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    li = np.log(np.full(S, 0.2, np.float32))
    mask = np.zeros((B, T), dtype=bool)
    for b, n in enumerate(lengths):
        mask[b, :n] = True
    log_em = np.where(mask[..., None], log_em, 0).astype(np.float32)
    return log_em, lt, li, mask


CASES = [
    # (B, T, chunk, lengths) — the sizes of tests/test_viterbi_pallas.py
    (3, 300, 64, [300, 211, 37]),
    (4, 100, 16, [100, 73, 32, 1]),
    (2, 513, 128, [513, 0]),
]


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("integer_em", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_decode_matches_pallas_and_numpy(case, uniform, integer_em):
    B, T, chunk, lengths = case
    log_em, lt, li, mask = _problem(T + B, B, T, uniform, integer_em,
                                    lengths)
    got = hmm.viterbi_decode_chunked(
        torch.as_tensor(log_em), torch.as_tensor(mask), lt, li,
        chunk=chunk).numpy()
    assert got.dtype == np.int32
    pallas = np.asarray(viterbi_decode_pallas(
        jnp.asarray(log_em), lt, li, jnp.asarray(mask), chunk=chunk))
    np.testing.assert_array_equal(got[mask], pallas[mask])
    np.testing.assert_array_equal(
        got, jax_hmm.viterbi_decode_np_chunked(log_em, lt, li, mask,
                                               chunk=chunk))
    seq = jax_hmm.viterbi_decode_np(log_em, lt, li, mask)
    np.testing.assert_array_equal(got[mask], seq[mask])


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 8, 33])
def test_chunk_end_states_resolve_at_any_chunk_count(n_chunks):
    """Phase 4b composes the chunk boundary maps by pointer doubling; at
    chunk counts on and off powers of two the paths equal the sequential
    decode."""
    chunk = 8
    T = chunk * n_chunks
    lengths = [T, max(T - 5, 1), 1]
    log_em, lt, li, mask = _problem(n_chunks, 3, T, False, True, lengths)
    got = hmm.viterbi_decode_chunked(
        torch.as_tensor(log_em), torch.as_tensor(mask), lt, li,
        chunk=chunk).numpy()
    np.testing.assert_array_equal(
        got, jax_hmm.viterbi_decode_np_chunked(log_em, lt, li, mask,
                                               chunk=chunk))
    seq = jax_hmm.viterbi_decode_np(log_em, lt, li, mask)
    np.testing.assert_array_equal(got[mask], seq[mask])


def test_decode_rejects_non_prefix_masks():
    log_em, lt, li, mask = _problem(0, 1, 50, True, False, [50])
    mask[0, 10] = False
    with pytest.raises(ValueError, match="prefix"):
        hmm.viterbi_decode_chunked(torch.as_tensor(log_em),
                                   torch.as_tensor(mask), lt, li, chunk=16)


def _coverage(seed, n_contigs=3):
    rng = np.random.default_rng(seed)
    cov = {}
    for i in range(n_contigs):
        T = int(rng.integers(400, 1500))
        c = rng.poisson(100.0, T).astype(np.float64)
        c[T // 4:T // 4 + 90] = rng.poisson(50.0, 90)
        c[T // 2:T // 2 + 120] = rng.poisson(150.0, 120)
        cov[f"chr{i + 1}"] = c
    cov["chrTiny"] = rng.poisson(100.0, 8).astype(np.float64)  # <= min_size
    return cov


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_coverage_batched_matches_canvas_tpu(seed):
    cov = _coverage(seed)
    want = jax_hmm.segment_coverage_batched(cov, chunk=64)
    got = hmm.segment_coverage_batched(cov, chunk=64, device="cpu")
    assert got == want
    assert len(got["chr1"]) >= 3             # the planted segments split

