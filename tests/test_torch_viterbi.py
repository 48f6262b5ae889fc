"""PerSampleHMM decode in canvas_tpu_torch against canvas_tpu: the plain
chunked decode (the plain versions of kernels B2 and B3 plus the torch
glue) against the Pallas decode in interpret mode and the numpy oracles,
and segment_coverage_batched breakpoints against canvas_tpu's."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from canvas_tpu.ops import hmm as jax_hmm
from canvas_tpu.ops import viterbi_pallas
from canvas_tpu.ops.viterbi_pallas import viterbi_decode_pallas
from canvas_tpu_torch.ops import hmm, viterbi_cuda

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


def _lanes(seed, chunk, lengths, nC, uniform, neg_inf_em=False):
    """Lane-last B2 inputs: integer emissions (exact ties) em f32
    [chunk, S, L] for L = len(lengths) * nC chunk-lanes, each lane's
    chunk-start time and sequence length, and a uniform or Dirichlet
    model.  With neg_inf_em, a fifth of the emissions are -1e30."""
    rng = np.random.default_rng(seed)
    L = len(lengths) * nC
    em = np.round(rng.normal(size=(chunk, S, L)) * 2).astype(np.float32)
    if neg_inf_em:
        em[rng.random(em.shape) < 0.2] = viterbi_cuda.NEG_INF
    if uniform:
        lt = np.asarray(jax_hmm.log_transition(S), np.float32)
    else:
        lt = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    li = np.log(np.full(S, 0.2, np.float32))
    base = np.tile(np.arange(nC, dtype=np.int32) * chunk, len(lengths))
    lane_len = np.repeat(np.asarray(lengths, np.int32), nC)
    return em, base, lane_len, lt, li


def _pallas_chunk_matrices(em, base, lane_len, lt, li):
    """canvas_tpu's _chunk_matrix_kernel in interpret mode, one grid step
    over every lane, with the BlockSpecs of _viterbi_pallas_jit."""
    chunk, S_, L = em.shape
    em_spec = pl.BlockSpec((chunk, S_, L), lambda i: (0, 0, i),
                           memory_space=pltpu.VMEM)
    vec_spec = pl.BlockSpec((1, L), lambda i: (0, i),
                            memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        partial(viterbi_pallas._chunk_matrix_kernel, chunk=chunk, S=S_,
                log_trans=tuple(tuple(float(x) for x in r) for r in lt),
                log_init=tuple(float(x) for x in li)),
        grid=(1,), in_specs=[em_spec, vec_spec, vec_spec],
        out_specs=pl.BlockSpec((S_, S_, L), lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((S_, S_, L), jnp.float32),
        interpret=True,
    )(jnp.asarray(em), jnp.asarray(base)[None], jnp.asarray(lane_len)[None])
    return np.asarray(out)


def _b2_plain(em, base, lane_len, lt, li):
    return viterbi_cuda.chunk_matrices_plain(
        torch.as_tensor(em), torch.as_tensor(base), torch.as_tensor(lane_len),
        lt, li).numpy()


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("chunk", [16, 64])
def test_chunk_matrices_plain_equals_pallas_kernel(chunk, uniform):
    """B2's plain version, with its uniform and general chains, against
    canvas_tpu's _chunk_matrix_kernel (which takes the same two chains),
    bit for bit: ragged lengths 0, 1, chunk + 1 and longer, integer
    emissions that force ties."""
    lengths = [0, 1, chunk + 1, 3 * chunk - 5, 4 * chunk]
    args = _lanes(chunk + uniform, chunk, lengths, 4, uniform)
    assert (viterbi_cuda.uniform_transitions(args[3]) is not None) == uniform
    got = _b2_plain(*args)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_pallas_chunk_matrices(*args)))


@pytest.mark.parametrize("neg_inf_em", [False, True])
@pytest.mark.parametrize("chunk", [8, 32])
def test_uniform_chain_equals_general_chain(chunk, neg_inf_em, monkeypatch):
    """On a uniform model the collapsed chain gives the general chain's
    matrices bit for bit, with rows left at -1e30 by the identity start
    (short and empty lanes) and -1e30 emissions."""
    lengths = [0, 1, 2, chunk + 1, 5 * chunk]
    args = _lanes(chunk + 7 * neg_inf_em, chunk, lengths, 5, True,
                  neg_inf_em)
    uniform = _b2_plain(*args)
    assert (uniform <= viterbi_cuda.NEG_INF).any()
    monkeypatch.setattr(viterbi_cuda, "uniform_transitions",
                        lambda log_trans: None)
    general = _b2_plain(*args)
    np.testing.assert_array_equal(_bits(uniform), _bits(general))


def test_uniform_transitions_is_canvas_tpus_test():
    lt = np.asarray(jax_hmm.log_transition(S), np.float32)
    assert viterbi_cuda.uniform_transitions(lt) == \
        viterbi_pallas._uniform_trans(tuple(tuple(float(x) for x in r)
                                            for r in lt))
    assert viterbi_cuda.uniform_transitions(lt) is not None
    odd = lt.copy()
    odd[2, 3] = odd[2, 4] - 1.0
    flat = np.full((S, S), np.float32(-1.6))                # off == self
    swapped = np.where(np.eye(S, dtype=bool), lt[0, 1], lt[0, 0])
    for m in (odd, flat, swapped):
        assert viterbi_cuda.uniform_transitions(m) is None
        assert viterbi_pallas._uniform_trans(
            tuple(tuple(float(x) for x in r) for r in m)) is None


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

