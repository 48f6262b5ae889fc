"""The decode's phase 2 (kernel K5) and phase 4b (kernel K6) in
canvas_tpu_torch against canvas_tpu: chunk_scan_plain bit for bit against
the associative scan of canvas_tpu's decode (jax.lax.associative_scan of
_maxplus_combine) and to 1e-5 relative against a numpy transcription of
the sequential oracle's phase 2 (canvas_tpu/ops/hmm.py:
viterbi_decode_np_chunked), chunk_chase_plain against a transcription of
canvas_tpu's reverse chase (viterbi_pallas.py, p4b), and whole decodes at
1, 2, 3, 8 and 33 chunks with ragged lengths and -1e30 emissions, equal
to canvas_tpu's jitted chunked decode at every bin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canvas_tpu.ops import hmm as jax_hmm
from canvas_tpu_torch.ops import hmm, viterbi_cuda

torch.set_num_threads(1)

S = 5
CHUNK = 8
N_CHUNKS = [1, 2, 3, 8, 33]
NEG = np.float32(viterbi_cuda.NEG_INF)


def _lengths(nC):
    """Ragged row lengths: 0, 1, chunk + 1 (where it fits) and full."""
    T = nC * CHUNK
    return [0, 1, min(CHUNK + 1, T), T]


def _emissions(seed, nC, neg_inf_em):
    """log_em f32 [B, T, S] of integer values (exact ties), a fifth of the
    live ones -1e30 with neg_inf_em, zero past each row's length; the
    mask; and the decode's uniform model."""
    rng = np.random.default_rng(seed)
    lengths = _lengths(nC)
    B, T = len(lengths), nC * CHUNK
    log_em = np.round(rng.normal(size=(B, T, S)) * 2).astype(np.float32)
    if neg_inf_em:
        log_em[rng.random(log_em.shape) < 0.2] = NEG
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    log_em = np.where(mask[..., None], log_em, 0).astype(np.float32)
    lt = np.asarray(jax_hmm.log_transition(S), np.float32)
    li = np.log(np.full(S, 0.2, np.float32))
    return log_em, mask, lt, li


def _chunk_mats(log_em, mask, lt, li):
    """B2's plain version on the decode's lane-last layout: (mats f32
    [S, S, L], em, base, lane_len)."""
    B, T, _ = log_em.shape
    nC = T // CHUNK
    L = B * nC
    em = torch.as_tensor(log_em).reshape(B, nC, CHUNK, S) \
        .permute(2, 3, 0, 1).reshape(CHUNK, S, L).contiguous()
    base = (torch.arange(nC, dtype=torch.int32) * CHUNK).repeat(B)
    lane_len = torch.as_tensor(mask.sum(1).astype(np.int32)) \
        .repeat_interleave(nC)
    mats = viterbi_cuda.chunk_matrices_plain(em, base, lane_len, lt, li)
    return mats, em, base, lane_len


def _phase2_np(mats, B):
    """canvas_tpu/ops/hmm.py:viterbi_decode_np_chunked's phase 2, float32
    and sequential: (scores_end [B, nC, S], ss [S, L], last_end [B])."""
    mats = np.asarray(mats, np.float32)
    L = mats.shape[-1]
    nC = L // B
    eye = np.where(np.eye(S, dtype=bool), np.float32(0.0), NEG)
    cm = np.transpose(mats.reshape(S, S, B, nC), (2, 3, 0, 1))
    scores_end = np.empty((B, nC, S), np.float32)
    running = np.broadcast_to(eye[None], (B, S, S)).astype(np.float32).copy()
    for c in range(nC):
        running = (running[:, :, :, None]
                   + cm[:, c][:, None, :, :]).max(axis=2)
        scores_end[:, c] = running.max(axis=1)
    start = np.concatenate(
        [np.zeros((B, 1, S), np.float32), scores_end[:, :-1]], axis=1)
    ss = np.transpose(start, (2, 0, 1)).reshape(S, L)
    last_end = scores_end[:, -1].argmax(axis=-1).astype(np.int32)
    return scores_end, ss, last_end


def _phase2_jax(mats, B):
    """canvas_tpu's phase 2 as its decode runs it (hmm.py:346,
    viterbi_pallas.py:285): one associative scan of _maxplus_combine over
    the chunks, the max over rows; (scores_end [B, nC, S], ss [S, L],
    last_end [B], the first maximum as jnp.argmax takes it)."""
    L = mats.shape[-1]
    cm = jnp.transpose(jnp.asarray(np.asarray(mats)).reshape(S, S, B, L // B),
                       (2, 3, 0, 1))
    prefix = jax.lax.associative_scan(jax_hmm._maxplus_combine, cm, axis=1)
    scores_end = jnp.max(prefix, axis=-2)
    start = jnp.concatenate([jnp.zeros((B, 1, S)), scores_end[:, :-1]],
                            axis=1)
    ss = jnp.transpose(start, (2, 0, 1)).reshape(S, L).astype(jnp.float32)
    last_end = jnp.argmax(scores_end[:, -1], axis=-1).astype(jnp.int32)
    return np.asarray(scores_end), np.asarray(ss), np.asarray(last_end)


def _chase_jax(prev_end, last_end):
    """A transcription of canvas_tpu's phase 4b (viterbi_pallas.py:319-323,
    the reverse lax.scan p4b) on the same prev_end: chunk-end states as
    the int64 [L] lane selectors."""
    B = last_end.shape[0]
    L = prev_end.shape[-1]
    nC = L // B
    pe = jnp.transpose(jnp.asarray(np.asarray(prev_end), jnp.int32)
                       .reshape(S, B, nC), (2, 1, 0))         # [nC, B, S]

    def p4b(carry, pe_c):
        prev = jnp.take_along_axis(pe_c, carry[:, None], axis=-1)[:, 0]
        return prev, carry

    _, ces = jax.lax.scan(p4b, jnp.asarray(np.asarray(last_end)), pe,
                          reverse=True)
    return np.asarray(jnp.moveaxis(ces, 0, 1)).reshape(L).astype(np.int64)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _check_scan(mats, B):
    """chunk_scan_plain against canvas_tpu's associative scan, bit for
    bit, and against the sequential oracle to 1e-5 relative; returns its
    start scores and the oracle's (scores_end, ss)."""
    ss, last_end = viterbi_cuda.chunk_scan_plain(mats, B)
    assert ss.dtype == torch.float32 and last_end.dtype == torch.int32
    _, want_ss, want_last = _phase2_jax(mats, B)
    np.testing.assert_array_equal(_bits(ss.numpy()), _bits(want_ss))
    np.testing.assert_array_equal(last_end.numpy(), want_last)
    scores_end, oracle_ss, _ = _phase2_np(mats.numpy(), B)
    np.testing.assert_allclose(ss.numpy(), oracle_ss, rtol=1e-5, atol=0)
    return ss.numpy(), scores_end, oracle_ss


@pytest.mark.parametrize("neg_inf_em", [False, True])
@pytest.mark.parametrize("nC", N_CHUNKS)
def test_chunk_scan_plain_equals_sequential_oracle(nC, neg_inf_em):
    """K5's plain version gives the chunk-start scores and last end
    states of canvas_tpu's associative scan bit for bit (the same
    bracketing, one f32 add a term, exact maxima), on B2's chunk
    matrices of the decode's emissions; the sequential oracle brackets
    the adds otherwise, so it agrees only to 1e-5 relative."""
    log_em, mask, lt, li = _emissions(nC + 10 * neg_inf_em, nC, neg_inf_em)
    B = log_em.shape[0]
    mats = _chunk_mats(log_em, mask, lt, li)[0]
    scores_end = _check_scan(mats, B)[1]
    if neg_inf_em:
        assert (scores_end < -1e29).any()


@pytest.mark.parametrize("B,nC", [(32, 2048), (2, 5000), (3, 37)])
def test_chunk_scan_plain_equals_associative_scan_on_real_matrices(B, nC):
    """The same on f32 chunk matrices of real values (scaled normals, a
    tenth -1e30) at the production decode's 32 x 2,048 chunks, at more
    chunks than K5's shared memory holds and off the powers of two: here
    the two bracketings differ in the last bits of many start scores, so
    only the tree's own order gives canvas_tpu's."""
    rng = np.random.default_rng(B * nC)
    mats = (rng.normal(size=(S, S, B * nC)) * 30).astype(np.float32)
    mats[rng.random(mats.shape) < 0.1] = NEG
    ss, _, oracle_ss = _check_scan(torch.as_tensor(mats), B)
    assert (_bits(ss) != _bits(oracle_ss)).any()


@pytest.mark.parametrize("nC", N_CHUNKS)
def test_chunk_chase_plain_equals_reverse_chase(nC):
    """K6's plain version (pointer doubling) equals canvas_tpu's reverse
    chase exactly: on B3's prev_end for the decode's own start scores, and
    on random prev_end and last end states."""
    log_em, mask, lt, li = _emissions(nC + 20, nC, True)
    B = log_em.shape[0]
    mats, em, base, lane_len = _chunk_mats(log_em, mask, lt, li)
    ss, last_end = viterbi_cuda.chunk_scan_plain(mats, B)
    _, prev_end = viterbi_cuda.forward_backtrack_plain(em, base, lane_len, ss,
                                                       lt, li)
    rng = np.random.default_rng(nC)
    cases = [(prev_end, last_end),
             (torch.as_tensor(rng.integers(0, S, prev_end.shape,
                                           dtype=np.int8)),
              torch.as_tensor(rng.integers(0, S, B, dtype=np.int32)))]
    for pe, le in cases:
        got = viterbi_cuda.chunk_chase_plain(pe, le)
        assert got.dtype == torch.int64 and got.shape == (B * nC,)
        np.testing.assert_array_equal(got.numpy(), _chase_jax(pe, le))


@pytest.mark.parametrize("neg_inf_em", [False, True])
@pytest.mark.parametrize("nC", N_CHUNKS)
def test_decode_equals_canvas_tpu(nC, neg_inf_em):
    """The whole decode on CPU tensors (B2, K5, B3 and K6 plain) equals
    canvas_tpu's jitted chunked decode, the decode canvas_tpu returns,
    at every bin, and canvas_tpu's numpy oracle of the chunked decode.
    So does the port's numpy transcription of the decode, the host oracle
    of the card tests (hmm.viterbi_decode_np_chunked).

    With -1e30 emissions, scores near -1e30 absorb every smaller term
    (f32 keeps 7 digits), so ties decide the path and canvas_tpu's own two
    decodes differ: its associative scan against its sequential oracle at
    2 of 274 live bins at 33 chunks.  The port brackets phase 2 as the
    associative scan does, so there it may differ from the oracle as
    canvas_tpu's decode does, at the same bins."""
    log_em, mask, lt, li = _emissions(nC + 30 * neg_inf_em, nC, neg_inf_em)
    got = hmm.viterbi_decode_chunked(torch.as_tensor(log_em),
                                     torch.as_tensor(mask), lt, li,
                                     chunk=CHUNK).numpy()
    jitted = np.asarray(jax_hmm.viterbi_decode_chunked(
        jnp.asarray(log_em), lt, li, jnp.asarray(mask), chunk=CHUNK))
    np.testing.assert_array_equal(got, jitted)
    np.testing.assert_array_equal(
        hmm.viterbi_decode_np_chunked(log_em, lt, li, mask, chunk=CHUNK),
        jitted)
    oracle = jax_hmm.viterbi_decode_np_chunked(log_em, lt, li, mask,
                                               chunk=CHUNK)
    if neg_inf_em:
        differ = (got != oracle) & mask
        assert differ.sum() <= 2
        np.testing.assert_array_equal(differ, (jitted != oracle) & mask)
    else:
        np.testing.assert_array_equal(got, oracle)


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    log_em, mask, lt, li = _emissions(3, 8, True)
    B = log_em.shape[0]
    mats, em, base, lane_len = _chunk_mats(log_em, mask, lt, li)
    before = dict(viterbi_cuda.LAUNCHES)
    ss, last_end = viterbi_cuda.chunk_scan(mats, B)
    want_ss, want_last = viterbi_cuda.chunk_scan_plain(mats, B)
    assert torch.equal(ss.view(torch.int32), want_ss.view(torch.int32))
    assert torch.equal(last_end, want_last)
    _, prev_end = viterbi_cuda.forward_backtrack_plain(em, base, lane_len, ss,
                                                       lt, li)
    assert torch.equal(viterbi_cuda.chunk_chase(prev_end, last_end),
                       viterbi_cuda.chunk_chase_plain(prev_end, last_end))
    assert viterbi_cuda.LAUNCHES == before       # nothing was launched


@pytest.mark.parametrize("call", ["scan_lanes", "scan_shape", "chase_dtype",
                                  "chase_lanes"])
def test_wrappers_reject_bad_inputs(call):
    mats = torch.zeros((S, S, 12), dtype=torch.float32)
    pe = torch.zeros((S, 12), dtype=torch.int8)
    with pytest.raises(ValueError):
        if call == "scan_lanes":
            viterbi_cuda.chunk_scan(mats, 5)
        elif call == "scan_shape":
            viterbi_cuda.chunk_scan(mats[:4], 3)
        elif call == "chase_dtype":
            viterbi_cuda.chunk_chase(pe, torch.zeros((3, 1), dtype=torch.int32))
        else:
            viterbi_cuda.chunk_chase(pe, torch.zeros(5, dtype=torch.int32))


def test_prefix_lengths_checks_the_host_mask():
    mask = np.zeros((3, 10), dtype=bool)
    mask[0, :10] = mask[1, :4] = True
    np.testing.assert_array_equal(hmm.prefix_lengths(mask), [10, 4, 0])
    np.testing.assert_array_equal(hmm.prefix_lengths(torch.as_tensor(mask)),
                                  [10, 4, 0])
    mask[2, 5] = True
    with pytest.raises(ValueError, match="prefix"):
        hmm.prefix_lengths(mask)


def test_decode_rejects_lengths_that_differ_from_the_mask():
    log_em, mask, lt, li = _emissions(4, 3, False)
    lengths = hmm.prefix_lengths(mask)
    args = (torch.as_tensor(log_em), torch.as_tensor(mask), lt, li)
    got = hmm.viterbi_decode_chunked(*args, chunk=CHUNK, lengths=lengths)
    assert torch.equal(got, hmm.viterbi_decode_chunked(*args, chunk=CHUNK))
    with pytest.raises(ValueError, match="lengths"):
        hmm.viterbi_decode_chunked(*args, chunk=CHUNK, lengths=lengths + 1)
