"""canvas_tpu_torch's CUDA kernels against their plain torch versions, on
the card.  Every test here needs a CUDA device and skips without one.  The
file imports neither jax nor canvas_tpu, so it runs on a machine with a
card and no JAX:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from canvas_tpu_torch.models import pedigree as ped
from canvas_tpu_torch.ops import hmm, prefix_cuda, viterbi_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n_tiles,offset,real_len,cap,dense", [
    (4, 77, 3 * prefix_cuda.TILE + 1234, 10, False),
    (1, 0, prefix_cuda.TILE, 1, False),                  # exactly one tile
    (40, 4097, 40 * prefix_cuda.TILE - 5, 10, False),
    # offset and real_len inside the same tile
    (3, prefix_cuda.TILE + 100, prefix_cuda.TILE + 3000, 10, False),
    # look-back chains across several waves of blocks; ocum wraps past 2^31
    (6000, 1000, 6000 * prefix_cuda.TILE - 77, 255, True),
])
def test_prefix_kernel_matches_plain(dev, n_tiles, offset, real_len, cap,
                                     dense):
    rng = np.random.default_rng(n_tiles)
    Lp = n_tiles * prefix_cuda.TILE
    if dense:
        p = rng.choice(np.array([255, 254, 127], np.uint8), Lp // 8)
        o = rng.integers(200, 256, Lp, dtype=np.uint8)
    else:
        p = rng.integers(0, 256, Lp // 8, dtype=np.uint8)
        o = rng.integers(0, 16, Lp, dtype=np.uint8)
    g = rng.integers(0, 256, Lp // 8, dtype=np.uint8)
    p, o, g = (torch.as_tensor(x).to(dev) for x in (p, o, g))
    before = prefix_cuda.LAUNCHES["prefix_scan"]
    runs = [prefix_cuda.fused_prefix_sums(p, o, g, offset, real_len, cap)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert prefix_cuda.LAUNCHES["prefix_scan"] == before + 3
    want = prefix_cuda.fused_prefix_sums_plain(p, o, g, offset, real_len, cap)
    if dense:
        assert bool((want[1] < 0).any())          # ocum passed 2^31
    for got in runs:                               # the same on every launch
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_prefix_kernel_rejects_unpadded_length(dev):
    o = torch.zeros(prefix_cuda.TILE + 8, dtype=torch.uint8, device=dev)
    p = torch.zeros(o.shape[0] // 8, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        prefix_cuda.fused_prefix_sums(p, o, p, 0, 10, 10)


def _decode_problem(seed, B, T, lengths, model="dirichlet"):
    rng = np.random.default_rng(seed)
    log_em = np.round(rng.normal(size=(B, T, 5)) * 2).astype(np.float32)
    if model == "uniform":
        lt = hmm.log_transition()
    else:
        lt = np.log(rng.dirichlet(np.ones(5), size=5)).astype(np.float32)
    li = np.log(np.full(5, 0.2, np.float32))
    mask = np.zeros((B, T), dtype=bool)
    for b, n in enumerate(lengths):
        mask[b, :n] = True
    log_em = np.where(mask[..., None], log_em, 0).astype(np.float32)
    return log_em, lt, li, mask


@pytest.mark.parametrize("model", ["uniform", "dirichlet"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_viterbi_kernels_match_plain(dev, chunk, model):
    log_em, lt, li, mask = _decode_problem(
        chunk, 6, 3000, [3000, 2999, 1500, 257, 1, 0], model)
    em_t = torch.as_tensor(log_em, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    lengths = hmm.prefix_lengths(mask)
    before = dict(viterbi_cuda.LAUNCHES)
    chains = dict(viterbi_cuda.CHAINS)
    got = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=chunk,
                                     lengths=lengths)
    torch.cuda.synchronize()
    chain = "uniform" if model == "uniform" else "general"
    assert viterbi_cuda.CHAINS[chain] == chains[chain] + 1
    for k in viterbi_cuda.LAUNCHES:
        assert viterbi_cuda.LAUNCHES[k] == before[k] + 1
    want = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=chunk,
                                      plain=True, lengths=lengths)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        hmm.viterbi_decode_np_chunked(log_em, lt, li, mask, chunk=chunk))


@pytest.mark.parametrize("chunk,ties", [(64, False), (64, True),
                                        (256, False), (256, True),
                                        (512, True)])
def test_forward_backtrack_kernel_matches_plain(dev, chunk, ties):
    """B3 alone, bit for bit: ragged lengths (0, 1, chunk + 1, ...), and
    integer emissions, transitions and start scores that force ties."""
    rng = np.random.default_rng(chunk + ties)
    lengths = [0, 1, chunk + 1, chunk, 3 * chunk - 7, 37 * chunk + 5]
    B, nC, S = len(lengths), 40, viterbi_cuda.N_STATES
    L = B * nC
    em = rng.normal(size=(chunk, S, L)) * 2
    lt = rng.normal(size=(S, S)) - 2
    start = rng.normal(size=(S, L)) * 10
    if ties:
        em, lt, start = np.round(em), np.round(lt), np.round(start)
    li = np.log(np.full(S, 0.2, np.float32))
    em_t = torch.as_tensor(em, dtype=torch.float32, device=dev)
    start_t = torch.as_tensor(start, dtype=torch.float32, device=dev)
    base = (torch.arange(nC, dtype=torch.int32, device=dev) * chunk).repeat(B)
    lane_len = torch.as_tensor(lengths, dtype=torch.int32,
                               device=dev).repeat_interleave(nC)
    lt = lt.astype(np.float32)
    before = viterbi_cuda.LAUNCHES["forward_backtrack"]
    got = viterbi_cuda.forward_backtrack(em_t, base, lane_len, start_t, lt,
                                         li)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES["forward_backtrack"] == before + 1
    want = viterbi_cuda.forward_backtrack_plain(em_t, base, lane_len,
                                                start_t, lt, li)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int8
        assert torch.equal(a, b)


def _b2_lanes(dev, chunk, uniform):
    """B2 inputs at ragged lengths (0, 1, chunk + 1, ...) with integer
    emissions that force ties, on the card."""
    rng = np.random.default_rng(chunk + uniform)
    lengths = [0, 1, chunk + 1, chunk, 3 * chunk - 7, 37 * chunk + 5]
    B, nC, S = len(lengths), 40, viterbi_cuda.N_STATES
    em = np.round(rng.normal(size=(chunk, S, B * nC)) * 2)
    if uniform:
        lt = hmm.log_transition()
    else:
        lt = np.round(rng.normal(size=(S, S)) - 2).astype(np.float32)
    li = np.log(np.full(S, 0.2, np.float32))
    em_t = torch.as_tensor(em, dtype=torch.float32, device=dev)
    base = (torch.arange(nC, dtype=torch.int32, device=dev) * chunk).repeat(B)
    lane_len = torch.as_tensor(lengths, dtype=torch.int32,
                               device=dev).repeat_interleave(nC)
    return em_t, base, lane_len, lt, li


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("chunk", [8, 64, 256, 1000])
def test_chunk_matrix_kernel_matches_plain(dev, chunk, uniform):
    """B2 alone, bit for bit, on both chains: ragged lengths and integer
    emissions (and, for the general chain, integer transitions)."""
    args = _b2_lanes(dev, chunk, uniform)
    assert (viterbi_cuda.uniform_transitions(args[3]) is not None) == uniform
    chain = "uniform" if uniform else "general"
    before = viterbi_cuda.CHAINS[chain]
    got = viterbi_cuda.chunk_matrices(*args)
    torch.cuda.synchronize()
    assert viterbi_cuda.CHAINS[chain] == before + 1
    want = viterbi_cuda.chunk_matrices_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _scan_inputs(dev, n_seq, n_chunks, seed, identity_rows=()):
    """K5's chunk matrices f32 [S, S, L] of integer values (exact ties),
    a fifth -1e30, and the identity (B2's output for an all-masked lane)
    for the sequences in identity_rows; K6's prev_end int8 [S, L] and last
    end states int32 [n_seq]."""
    rng = np.random.default_rng(seed)
    S, L = viterbi_cuda.N_STATES, n_seq * n_chunks
    mats = np.round(rng.normal(size=(S, S, L)) * 4).astype(np.float32)
    mats[rng.random(mats.shape) < 0.2] = viterbi_cuda.NEG_INF
    eye = np.where(np.eye(S, dtype=bool), np.float32(0),
                   np.float32(viterbi_cuda.NEG_INF))
    for b in identity_rows:
        mats[:, :, b * n_chunks:(b + 1) * n_chunks] = eye[:, :, None]
    pe = rng.integers(0, S, (S, L), dtype=np.int8)
    last = rng.integers(0, S, n_seq, dtype=np.int32)
    return (torch.as_tensor(mats, device=dev), torch.as_tensor(pe, device=dev),
            torch.as_tensor(last, device=dev))


# (sequences, chunks): the production decode's 32 x 2,048; one chunk; a
# chunk count off the powers of two; more chunks than K6's shared-memory
# tile holds, whose two lowest levels of K5's tree do not fit in shared
# memory; one past a power of two; four levels in K5's scratch and five
# K6 tiles
SCAN_SHAPES = [(32, 2048), (4, 1), (3, 37), (2, 5000), (5, 2049),
               (3, 20000)]


@pytest.mark.parametrize("n_seq,n_chunks", SCAN_SHAPES)
def test_chunk_scan_and_chase_kernels_match_plain(dev, n_seq, n_chunks):
    """K5 and K6 alone, bit for bit (int32 views): integer chunk matrices
    with ties and -1e30 entries, an all-masked sequence (identity
    matrices), and K6 on K5's last end states and on random ones."""
    mats, pe, last = _scan_inputs(dev, n_seq, n_chunks, n_seq + n_chunks,
                                  identity_rows=(n_seq - 1,))
    before = dict(viterbi_cuda.LAUNCHES)
    ss, last_end = viterbi_cuda.chunk_scan(mats, n_seq)
    sel = viterbi_cuda.chunk_chase(pe, last_end)
    sel_random = viterbi_cuda.chunk_chase(pe, last)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES["chunk_scan"] == before["chunk_scan"] + 1
    assert viterbi_cuda.LAUNCHES["chunk_chase"] == before["chunk_chase"] + 2
    want_ss, want_last = viterbi_cuda.chunk_scan_plain(mats, n_seq)
    assert torch.equal(ss.view(torch.int32), want_ss.view(torch.int32))
    assert last_end.dtype == torch.int32
    assert torch.equal(last_end, want_last)
    for got, le in ((sel, last_end), (sel_random, last)):
        assert got.dtype == torch.int64
        assert torch.equal(got, viterbi_cuda.chunk_chase_plain(pe, le))


@pytest.mark.parametrize("n_seq,n_chunks", [(32, 2048), (5, 2049),
                                             (3, 20000)])
def test_chunk_scan_kernel_matches_plain_on_real_matrices(dev, n_seq,
                                                          n_chunks):
    """K5 on f32 chunk matrices of real values (scaled normals, a tenth
    -1e30), bit for bit: there every bracketing of the adds gives its own
    bits, so this holds the tree to the plain version's order, which is
    canvas_tpu's associative scan."""
    rng = np.random.default_rng(n_seq * n_chunks)
    S, L = viterbi_cuda.N_STATES, n_seq * n_chunks
    mats = (rng.normal(size=(S, S, L)) * 30).astype(np.float32)
    mats[rng.random(mats.shape) < 0.1] = viterbi_cuda.NEG_INF
    mats = torch.as_tensor(mats, device=dev)
    ss, last_end = viterbi_cuda.chunk_scan(mats, n_seq)
    want_ss, want_last = viterbi_cuda.chunk_scan_plain(mats, n_seq)
    assert torch.equal(ss.view(torch.int32), want_ss.view(torch.int32))
    assert torch.equal(last_end, want_last)


def test_decode_makes_no_synchronising_call(dev):
    """The decode on the card is a fixed sequence of launches: under
    CUDA's sync debug mode set to "error" it makes no synchronising call
    up to the caller's read of the path."""
    log_em, lt, li, mask = _decode_problem(
        12, 6, 3000, [3000, 2999, 1500, 257, 1, 0], "uniform")
    em_t = torch.as_tensor(log_em, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    lengths = hmm.prefix_lengths(mask)
    want = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, lengths=lengths)
    torch.cuda.synchronize()                 # the kernels are built
    before = dict(viterbi_cuda.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li,
                                         lengths=lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for k in viterbi_cuda.LAUNCHES:
        assert viterbi_cuda.LAUNCHES[k] == before[k] + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="lengths"):
        hmm.viterbi_decode_chunked(em_t, mask_t, lt, li)


def test_lane_split_decode_reads_once_a_group(dev, monkeypatch):
    """Six contigs over [cuda:0] * 4: the lane groups' decodes make one
    synchronising call each, the copy of the group's path to the host,
    so every group is queued before the first read."""
    import warnings

    decode_lanes = hmm._decode_lanes
    syncs = []

    def counted(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = decode_lanes(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchronizing" in str(w.message) for w in caught))
        return out

    monkeypatch.setattr(hmm, "_decode_lanes", counted)
    cov = _coverage(5, 6)
    split = hmm.segment_coverage_batched(
        cov, devices=[torch.device("cuda", 0)] * 4)
    assert syncs == [4]
    assert split == hmm.segment_coverage_batched(cov, device="cpu")


def test_chunk_kernels_launch_on_the_tensors_device(dev):
    """K5 and K6 on cuda:1 while cuda:0 is current: results on cuda:1,
    equal to the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    # 5,000 chunks: K5's two lowest levels go to its scratch, on cuda:1
    for n_seq, n_chunks in ((6, 300), (2, 5000)):
        mats, pe, last = _scan_inputs(d1, n_seq, n_chunks, 2)
        ss, last_end = viterbi_cuda.chunk_scan(mats, n_seq)
        sel = viterbi_cuda.chunk_chase(pe, last_end)
        assert ss.device == last_end.device == sel.device == d1
        want_ss, want_last = viterbi_cuda.chunk_scan_plain(mats, n_seq)
        assert torch.equal(ss.view(torch.int32), want_ss.view(torch.int32))
        assert torch.equal(last_end, want_last)
        assert torch.equal(sel, viterbi_cuda.chunk_chase_plain(pe, last_end))
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0


def test_segment_coverage_batched_on_card_equals_cpu(dev):
    rng = np.random.default_rng(4)
    cov = {}
    for i in range(5):
        c = rng.poisson(100.0, int(rng.integers(500, 5000))).astype(float)
        c[100:300] = rng.poisson(50.0, 200)
        cov[f"chr{i + 1}"] = c
    assert hmm.segment_coverage_batched(cov, device=dev) == \
        hmm.segment_coverage_batched(cov, device="cpu")


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("use_all_states", [True, False])
def test_joint_emission_on_card_equals_cpu(dev, D, use_all_states):
    """The genotype-permutation emission: gathers, adds in sample order and
    maxima, bit-equal on the card and on the CPU."""
    rng = np.random.default_rng(10 + D)
    cov = rng.poisson(100.0, (3_000, D)).astype(np.float64)
    cov[500:900, 0] *= 1.5
    tables, _, clamped = hmm.build_emission_tables(cov)
    x = torch.as_tensor(clamped.astype(np.float32))[None]
    mask = torch.ones((1, 3_000), dtype=torch.bool)
    mask[0, 2_500:] = False
    got = hmm.emission_log_probs(x.to(dev), tables, mask.to(dev),
                                 use_all_states=use_all_states)
    want = hmm.emission_log_probs(x, tables, mask,
                                  use_all_states=use_all_states)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_joint_decode_on_card_equals_plain(dev):
    """The joint decode of a trio's contigs: kernels B2 and B3 against their
    plain versions on the card, breakpoints against the CPU run; states
    0/1 and 3/4 tie in every bin."""
    rng = np.random.default_rng(6)
    cov = {}
    for i in range(5):
        c = rng.poisson(100.0, (int(rng.integers(500, 9_000)), 3)).astype(
            float)
        c[100:300, 1:] = rng.poisson(150.0, (200, 2))
        c[400:480, 2] = rng.poisson(50.0, 80)
        cov[f"chr{i + 1}"] = c
    live, lengths, em, mask, lt, li = hmm.joint_emissions(cov, device=dev)
    assert torch.equal(em[..., 0], em[..., 1])
    assert torch.equal(em[..., 3], em[..., 4])
    n = hmm._lane_lengths(live, lengths, em.shape[0])
    before = dict(viterbi_cuda.LAUNCHES)
    got = hmm.viterbi_decode_chunked(em, mask, lt, li, lengths=n)
    torch.cuda.synchronize()
    for k in viterbi_cuda.LAUNCHES:
        assert viterbi_cuda.LAUNCHES[k] == before[k] + 1
    want = hmm.viterbi_decode_chunked(em, mask, lt, li, plain=True,
                                      lengths=n)
    assert torch.equal(got, want)
    assert hmm.segment_coverage_joint_batched(cov, device=dev) == \
        hmm.segment_coverage_joint_batched(cov, device="cpu")


def test_batched_joint_likelihood_on_card_equals_cpu(dev):
    rng = np.random.default_rng(5)
    for n_children in (1, 2):
        pl = rng.random((32, 2, ped.MAX_COPY_NUMBER)) + 1e-6
        cl = rng.random((32, n_children, ped.MAX_COPY_NUMBER)) + 1e-6
        got = ped.pedigree_joint_likelihood_batched(
            pl, cl, ped.transition_matrix(), device=dev)
        want = ped.pedigree_joint_likelihood_batched(
            pl, cl, ped.transition_matrix(), device="cpu")
        for a, b in zip(got, want):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _arc_rows(seed, npad, B):
    """Cumsums f32 [B, npad] of centred noise with planted steps, their
    lengths and sums of squares."""
    rng = np.random.default_rng(seed)
    cs = np.zeros((B, npad), np.float32)
    n = np.zeros(B, np.int32)
    tss = np.zeros(B, np.float32)
    for i in range(B):
        L = int(rng.integers(npad // 2 + 1, npad + 1))
        r = rng.normal(0, 1, L)
        if i % 2 == 0:
            s = int(rng.integers(0, L // 2))
            r[s:s + L // 4] += 1.0
        r -= r.mean()
        cs[i, :L] = np.cumsum(r)
        n[i] = L
        tss[i] = np.sum(r * r)
    return cs, n, tss


@pytest.mark.parametrize("npad,B", [(8, 3), (256, 4), (4096, 16),
                                    (32768, 2)])
def test_arc_scan_kernel_matches_plain(dev, npad, B):
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device

    cs, n, tss = _arc_rows(npad, npad, B)
    csd = torch.as_tensor(cs, device=dev)
    nd = torch.as_tensor(n, device=dev)
    before = arc_scan_cuda.LAUNCHES["arc_scan"]
    got = cbs_device.tmax_batch(csd, nd, torch.as_tensor(tss, device=dev),
                                npad, 2)
    torch.cuda.synchronize()
    assert arc_scan_cuda.LAUNCHES["arc_scan"] == before + 1
    want = cbs_device.tmax_batch(torch.as_tensor(cs), torch.as_tensor(n),
                                 torch.as_tensor(tss), npad, 2)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _arc_scan_both(cs, n, npad):
    """(kernel, plain) (best, bl0) of B4 on the rows cs f32 [B, npad]."""
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device

    out = []
    for d in (torch.device("cuda"), torch.device("cpu")):
        cs_d = torch.as_tensor(cs, device=d)
        n_d = torch.as_tensor(n, device=d)
        seed, lag_hi, psd2, _ti0, _tj0 = cbs_device.arc_scan_inputs(
            cs_d, n_d, npad, 2)
        out.append([x.cpu() for x in arc_scan_cuda.arc_scan(
            cs_d, n_d, lag_hi, seed, psd2, 2)])
    return out


def test_arc_scan_kernel_at_the_panels_top_level(dev):
    """One segment of 19,930 bins in a 32,768 bucket, as the enrichment
    panel's top frontier level gives B4."""
    cs, n, _tss = _arc_rows(11, 32768, 1)
    n[0] = 19930
    cs[0, 19930:] = 0.0
    (best_k, bl0_k), (best_p, bl0_p) = _arc_scan_both(cs, n, 32768)
    assert torch.equal(best_k.view(torch.int32), best_p.view(torch.int32))
    assert torch.equal(bl0_k, bl0_p)


def test_arc_scan_kernel_ties_across_blocks(dev):
    """Integer cumsums whose best term ties across lag blocks: a spike of
    height V at n - 2 pairs with position n - 4 at lag 2 (block 0) and
    with position 0 at lag n - 2 (the last block), and w(2) = w(n - 2)
    bit for bit; a shallow valley mid-row keeps the extrema seed below
    them.  The walk keeps the first strict maximum, bl0 = 0.  Lengths are
    not multiples of the 1,024-position tile; one more row is an integer
    random walk."""
    npad = 2048
    n = np.array([1500, 2000, 2047, 1999], np.int32)
    cs = np.zeros((4, npad), np.float32)
    for r in range(3):
        cs[r, n[r] - 2] = 40.0
        cs[r, n[r] // 2] = -1.0
    rng = np.random.default_rng(3)
    cs[3, :n[3]] = np.cumsum(rng.integers(-1, 2, n[3]))
    (best_k, bl0_k), (best_p, bl0_p) = _arc_scan_both(cs, n, npad)
    assert torch.equal(best_k.view(torch.int32), best_p.view(torch.int32))
    assert torch.equal(bl0_k, bl0_p)
    assert bl0_p[:3].tolist() == [0, 0, 0]


def _cbs_panel(seed=5, n=3000):
    rng = np.random.default_rng(seed)
    cov = {}
    for c in range(3):
        r = rng.normal(0, 1, n)
        r[500:900] += 2.0
        r[2000:2100] -= 3.0
        r[2400:2460] += 0.7
        cov[f"chr{c}"] = r
    return cov


def test_frontier_engine_on_card_equals_cpu(dev):
    from canvas_tpu_torch.ops import cbs_device

    cov = _cbs_panel()
    got = cbs_device.run_cbs_device(cov, n_perm=1000, device=dev)
    want = cbs_device.run_cbs_device(cov, n_perm=1000, device="cpu")
    for k in cov:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("npad", [1 << k for k in range(10, 17)])
def test_arc_scan_kernel_at_every_mega_tier(dev, npad):
    """B4 as the whole-recursion engine calls it: 32 rows at a tier width,
    three of them in the tier (lengths in (npad/2, npad], one with a
    planted step), the rest zeroed (n = 2, cs = 0).  The kernel against
    its plain version on the card, bit for bit, and tmax_batch on the card
    against tmax_batch on the CPU."""
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device

    rng = np.random.default_rng(npad)
    W = 32
    cs = np.zeros((W, npad), np.float32)
    n = np.full(W, 2, np.int64)
    tss = np.zeros(W, np.float32)
    for r in (0, 7, 31):
        L = int(rng.integers(npad // 2 + 1, npad + 1))
        x = rng.normal(0, 1, L)
        if r == 7:
            x[L // 3:L // 2] += 0.8
        x -= x.mean()
        cs[r, :L] = np.cumsum(x)
        n[r] = L
        tss[r] = np.sum(x * x)
    csd, nd, tssd = (torch.as_tensor(a, device=dev) for a in (cs, n, tss))
    seed, lag_hi, psd2, _ti0, _tj0 = cbs_device.arc_scan_inputs(
        csd, nd, npad, 2)
    args = (csd, nd.to(torch.int32), lag_hi, seed, psd2, 2)
    before = arc_scan_cuda.LAUNCHES["arc_scan"]
    best_k, bl0_k = arc_scan_cuda.arc_scan(*args)
    assert arc_scan_cuda.LAUNCHES["arc_scan"] == before + 1
    best_p, bl0_p = arc_scan_cuda.arc_scan_plain(*args)
    assert torch.equal(best_k.view(torch.int32), best_p.view(torch.int32))
    assert torch.equal(bl0_k, bl0_p)
    assert (best_k.cpu()[torch.as_tensor(n == 2)] == 0).all()
    a = cbs_device.tmax_batch(csd, nd, tssd, npad, 2)
    b = cbs_device.tmax_batch(*(t.cpu() for t in (csd, nd, tssd)), npad, 2)
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)


def test_mega_engine_on_card_equals_cpu(dev):
    """The whole-recursion engine on CUDA tensors (its kernels, the level
    replayed from a CUDA graph) and on CPU tensors (their plain versions):
    equal segments, walks and edge tests on both, one launch of K7 and of
    K8 a replayed level, and at most 2 reads from the card a run: under
    CUDA's sync debug mode the run's synchronising calls are its SYNCS
    reads and its four set-up copies, so nothing in a level reads."""
    import warnings

    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_mega, cbs_mega_cuda

    cov = _cbs_panel()
    counts = {"cuda": {}, "cpu": {}}
    cbs_mega.run_cbs_mega(cov, n_perm=1000, device=dev)    # the capture
    before = arc_scan_cuda.LAUNCHES["arc_scan"]
    r0 = cbs_mega.GRAPHS["replays"]
    k_before = dict(cbs_mega_cuda.LAUNCHES)
    s0 = cbs_mega.SYNCS["cbs_mega"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = cbs_mega.run_cbs_mega(cov, n_perm=1000, device=dev,
                                        counts=counts["cuda"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = cbs_mega.SYNCS["cbs_mega"] - s0
    launches = arc_scan_cuda.LAUNCHES["arc_scan"] - before
    replays = cbs_mega.GRAPHS["replays"] - r0
    want = cbs_mega.run_cbs_mega(cov, n_perm=1000, device="cpu",
                                 counts=counts["cpu"])
    for k in cov:
        np.testing.assert_array_equal(got[k], want[k])
        assert len(got[k]) >= 3
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"]["walk_chunks"] >= 1
    levels = counts["cuda"]["levels"]
    assert replays >= levels >= 2
    assert launches == replays * len(cbs_mega._tiers(4096))
    for k in ("walk", "edge"):
        assert cbs_mega_cuda.LAUNCHES[k] - k_before[k] == replays
    assert syncs <= 2
    hidden = [str(w.message) for w in caught
              if "synchronizing" in str(w.message)]
    assert len(hidden) == syncs + 4, (syncs, hidden[:3])


_BOUNDARY: dict = {}


def _sbdry(dev, n_perm, alpha=0.01):
    """The CBS stopping boundary, int64 on the card."""
    from canvas_tpu_torch.ops import cbs

    if (n_perm, alpha) not in _BOUNDARY:
        _BOUNDARY[n_perm, alpha] = np.asarray(
            cbs.compute_boundary(n_perm, alpha, cbs.DEFAULT_ETA), np.int64)
    return torch.as_tensor(_BOUNDARY[n_perm, alpha], device=dev)


def _walk_inputs(dev, lengths, seed, n_min=200, quantiles=None):
    """K7's inputs for rows of the given lengths at Tmax, the widest
    row's tier: centred noise with a weak step, a random level key and
    rows' (contig, start), every row walking, ostat at a quantile of the
    row's chunk-0 statistics (from the plain version) so that walks take
    several chunks, nrejc 20."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    rng = np.random.default_rng(seed)
    W = len(lengths)
    Tmax = max(mc.tier_width(n) for n in lengths)
    x = np.zeros((W, Tmax), np.float32)
    for r, L in enumerate(lengths):
        v = rng.normal(0, 1, L)
        v[L // 3:L // 2] += 0.3
        x[r, :L] = v - v.mean()
    n = np.asarray(lengths, np.int64)
    inp = {"x": torch.as_tensor(x, device=dev),
           "n": torch.as_tensor(n, device=dev),
           "tss": torch.as_tensor((x.astype(np.float64) ** 2).sum(1)
                                  .astype(np.float32), device=dev),
           "key0": torch.as_tensor(rng.integers(0, 2 ** 32, 2), device=dev),
           "seg_c": torch.as_tensor(rng.integers(0, 192, W), device=dev),
           "seg_lo": torch.as_tensor(rng.integers(0, 60000, W), device=dev),
           "walking": torch.ones(W, dtype=torch.bool, device=dev),
           "hybrid": torch.as_tensor(n > n_min, device=dev),
           "ostat": torch.zeros(W, dtype=torch.float32, device=dev),
           "nrejc": torch.full((W,), 20, dtype=torch.int64, device=dev)}
    stats = torch.zeros((W, mc.P_CHUNK), dtype=torch.float32, device=dev)
    mc.walk_plain(**inp, sbdry=_sbdry(dev, 512), n_perm=512, al0=2,
                  kmax=25, n_min=n_min, stats=stats)
    q = quantiles or [0.99]
    inp["ostat"] = torch.as_tensor(
        [float(np.quantile(stats[r].cpu().numpy(), q[r % len(q)]))
         for r in range(W)], dtype=torch.float32, device=dev)
    return inp


def _walk_both(dev, inp, n_perm=2048, n_min=200):
    """K7 and its plain version on the same inputs: (accepted, chunks,
    chunk-0 statistics) of each."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    W = inp["x"].shape[0]
    args = dict(inp, sbdry=_sbdry(dev, n_perm), n_perm=n_perm, al0=2,
                kmax=25, n_min=n_min)
    out = []
    for fn in (mc.walk, mc.walk_plain):
        stats = torch.full((W, mc.P_CHUNK), -1.0, device=dev)
        acc, chunks = fn(**args, stats=stats)
        out.append((acc, chunks, stats))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("npad", [1 << k for k in range(10, 17)])
def test_walk_kernel_matches_plain(dev, npad):
    """K7 against its plain version at every tier width of the engine:
    rows of that tier (hybrid), and at 1,024 also full-arc rows (n <=
    n_min) and rows of the next tier down; and in the same launch a row
    of every narrower tier, so rows worked by 8, 5, 3 and 1 groups a
    block (two buffers, one, or the slab) share iterations.  Equal flags
    and chunk counts, chunk 0's statistics bit for bit."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    lengths = [npad // 2 + 1 + 37 * npad // 1024, npad - 3]
    if npad == 1024:
        lengths += [150, 200, 40]
    elif npad <= 4096:
        lengths += [npad // 4 + 5]
    lengths += [w // 2 + 11 for w in (1 << k for k in range(11, 17))
                if w < npad]
    inp = _walk_inputs(dev, lengths, seed=npad,
                       quantiles=[0.99, 0.995, 0.97])
    before = mc.LAUNCHES["walk"]
    (acc_k, ch_k, st_k), (acc_p, ch_p, st_p) = _walk_both(dev, inp)
    assert mc.LAUNCHES["walk"] == before + 1
    assert torch.equal(st_k.view(torch.int32), st_p.view(torch.int32))
    assert torch.equal(acc_k, acc_p)
    assert torch.equal(ch_k, ch_p)
    assert int(ch_p.max()) >= 2


def test_walk_kernel_full_arcs_at_every_lag(dev):
    """p_method other than hybrid: every row full-arc, every lag up to
    n - al0 (n_min = 2^30), at tiers 1,024 and 2,048."""
    inp = _walk_inputs(dev, [1500, 700, 1024], seed=9, n_min=1 << 30)
    (acc_k, ch_k, st_k), (acc_p, ch_p, st_p) = _walk_both(
        dev, inp, n_perm=1024, n_min=1 << 30)
    assert torch.equal(st_k.view(torch.int32), st_p.view(torch.int32))
    assert torch.equal(acc_k, acc_p) and torch.equal(ch_k, ch_p)


def test_walk_kernel_sort_ties(dev):
    """Key collisions for the sort: at n = 4,096 most permutations draw
    some uniform twice (checked here), and the tie resolves by index;
    the values are all distinct, so another order would change the
    cumsum."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc
    from canvas_tpu_torch.ops import threefry

    inp = _walk_inputs(dev, [4096, 3000], seed=21)
    keys = mc.seg_keys(inp["key0"], inp["seg_c"], inp["seg_lo"], inp["n"])
    u = threefry.uniform(threefry.fold_in(keys[:1], 0),
                         (mc.P_CHUNK, 4096))[0]
    dup = (torch.sort(u, dim=1).values.diff(dim=1) == 0).any(dim=1)
    assert int(dup.sum()) > 100
    (acc_k, ch_k, st_k), (acc_p, ch_p, st_p) = _walk_both(dev, inp)
    assert torch.equal(st_k.view(torch.int32), st_p.view(torch.int32))
    assert torch.equal(acc_k, acc_p) and torch.equal(ch_k, ch_p)


def _edge_inputs(dev, wns, m1s, seed, n_perm=2048, alpha=0.01, edges=1):
    """K8's inputs for lanes of window lengths wns and subset sizes m1s at
    Tmax, the widest lane's tier: noise with a weak step, a random level
    key and (contig, start, length) of len(wns) / edges rows, ostat at a
    quantile of the lane's chunk-0 statistics (from the plain version),
    limit alpha * n_perm in f32."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    rng = np.random.default_rng(seed)
    L = len(wns)
    Tmax = max(mc.tier_width(w) for w in wns)
    xw = np.zeros((L, Tmax), np.float32)
    for r, w in enumerate(wns):
        v = rng.normal(0, 1, w)
        v[:m1s[r]] += 0.2
        xw[r, :w] = v
    xwt = torch.as_tensor(xw, device=dev)
    wn = torch.as_tensor(np.asarray(wns, np.int64), device=dev)
    inp = {"xw": xwt, "wn": wn,
           "m1": torch.as_tensor(np.asarray(m1s, np.int64), device=dev),
           "xbar": xwt.double().sum(1).float() / wn.to(torch.float32),
           "ostat": torch.zeros(L, dtype=torch.float32, device=dev),
           "active": torch.ones(L, dtype=torch.bool, device=dev),
           "key0": torch.as_tensor(rng.integers(0, 2 ** 32, 2), device=dev),
           **{k: torch.as_tensor(rng.integers(0, hi, L // edges), device=dev)
              for k, hi in (("seg_c", 192), ("seg_lo", 60000),
                            ("seg_n", 65536))},
           "limit": torch.tensor(alpha, device=dev) * n_perm}
    sums = torch.zeros((L, mc.P_CHUNK), dtype=torch.float32, device=dev)
    mc.edge_counts_plain(**dict(inp, limit=torch.tensor(1e9, device=dev)),
                         n_perm=512, sums=sums)
    pstat = (sums / inp["m1"].to(torch.float32)[:, None]
             - inp["xbar"][:, None]).abs()
    q = [0.985, 0.995, 0.97]
    inp["ostat"] = torch.as_tensor(
        [float(np.quantile(pstat[r].cpu().numpy(), q[r % 3]))
         for r in range(L)], dtype=torch.float32, device=dev)
    return inp


@pytest.mark.parametrize("npad", [1 << k for k in range(10, 17)])
def test_edge_kernel_matches_plain(dev, npad):
    """K8 against its plain version at every tier width: equal counts
    and chunk counts, chunk 0's subset sums bit for bit.  Besides the
    tier's lanes, subsets on both sides of the warp's limit (m1 = 1, 2,
    32 and 33) and a lane of a narrower tier, so warp items and group
    units of several tiers share iterations; two edges of four rows."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    wns = [npad - 1, npad // 2 + 3, max(20, npad // 3)]
    m1s = [2, npad // 4, max(10, npad // 7)]
    wns += [npad - 5, npad // 2 + 9, 700, max(70, npad // 5),
            max(1024, npad // 2) - 1]
    m1s += [1, 32, 33, 2, 33]
    n_perm = 2048
    inp = _edge_inputs(dev, wns, m1s, seed=npad, n_perm=n_perm, edges=2)
    L = len(wns)
    out = []
    before = mc.LAUNCHES["edge"]
    for fn in (mc.edge_counts, mc.edge_counts_plain):
        sums = torch.full((L, mc.P_CHUNK), -1.0, device=dev)
        count, cnt = fn(**inp, n_perm=n_perm, sums=sums)
        out.append((count, cnt, sums))
    torch.cuda.synchronize()
    assert mc.LAUNCHES["edge"] == before + 1
    (c_k, n_k, s_k), (c_p, n_p, s_p) = out
    assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
    assert torch.equal(c_k, c_p) and torch.equal(n_k, n_p)
    assert int(n_p.max()) >= 2


@pytest.mark.parametrize("m1", [1, 2, 31, 32, 33, 34, 200])
def test_edge_kernel_small_subset_limit(dev, m1):
    """K8 on both sides of the subsets a warp streams (m1 <= 32): lanes
    of tiers 1,024 to 65,536 with the same m1 in one launch, equal to the
    plain version, chunk 0's sums bit for bit."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    wns = [1000, 2047, 4000, 8000, 16000, 32000, 65000, 3 * m1 + 10]
    n_perm = 1024
    inp = _edge_inputs(dev, wns, [m1] * len(wns), seed=m1, n_perm=n_perm)
    L = len(wns)
    out = []
    for fn in (mc.edge_counts, mc.edge_counts_plain):
        sums = torch.full((L, mc.P_CHUNK), -1.0, device=dev)
        count, cnt = fn(**inp, n_perm=n_perm, sums=sums)
        out.append((count, cnt, sums))
    torch.cuda.synchronize()
    (c_k, n_k, s_k), (c_p, n_p, s_p) = out
    assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
    assert torch.equal(c_k, c_p) and torch.equal(n_k, n_p)


def test_kernel_keys_equal_fold_in_chains(dev):
    """The chunk keys K7 and K8 derive on the card equal ops/threefry.py's
    chains bit for bit: fold_in(seg_keys, chunk) for the walks and
    fold_in(edge_keys, chunk) for two edges of each row, with data words
    at and above 2^31 and chunk numbers 0, 1 and 19."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc
    from canvas_tpu_torch.ops import threefry

    rng = np.random.default_rng(3)
    R = 37
    key0 = torch.as_tensor(rng.integers(0, 2 ** 32, 2), device=dev)
    c, lo, n = (torch.as_tensor(rng.integers(0, hi, R), device=dev)
                for hi in (192, 2 ** 32, 65537))
    for chunk in (0, 1, 19):
        wk, ek = mc.device_keys(key0, c, lo, n, 2 * R, chunk)
        assert torch.equal(wk, threefry.fold_in(mc.seg_keys(key0, c, lo, n),
                                                chunk))
        assert torch.equal(ek, threefry.fold_in(
            mc.edge_keys(key0, c, lo, n, 2 * R), chunk))


def test_device_threefry_equals_torch_above_2_32(dev):
    """The kernels' fold_in, bits and uniforms equal ops/threefry.py's at
    counters 2^32 + 1,000 onwards (a high counter word of 1)."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc
    from canvas_tpu_torch.ops import threefry

    rng = np.random.default_rng(2)
    keys = torch.as_tensor(rng.integers(0, 2 ** 32, (5, 2)), device=dev)
    data = torch.as_tensor(rng.integers(0, 2 ** 32, 5), device=dev)
    off, count = 1000, 3000
    folded, bits, unif = mc.device_draws(keys, data, (1 << 32) + off, count)
    assert torch.equal(folded, threefry.fold_in(keys, data))
    shape = (2, 1 << 32)
    want_bits = threefry.random_bits(keys, shape, off + count)[:, 1, off:]
    want_unif = threefry.uniform(keys, shape, off + count)[:, 1, off:]
    assert torch.equal(bits, want_bits)
    assert torch.equal(unif.view(torch.int32), want_unif.view(torch.int32))


def _bits_equal(a, b) -> bool:
    """Equal tensors, floats bit for bit."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


def _differ(a, b) -> list:
    """The first entries where a and b differ, as (index, a, b)."""
    a, b = a.cpu(), b.cpu()
    bad = (a != b) if a.dtype not in (torch.float32, torch.float64) else \
        (a.view(torch.int32 if a.dtype == torch.float32 else torch.int64)
         != b.view(torch.int32 if b.dtype == torch.float32 else torch.int64))
    idx = torch.nonzero(bad)[:5]
    return [(tuple(i.tolist()), a[tuple(i)].item(), b[tuple(i)].item())
            for i in idx]


def _stat_rows(npad, seed):
    """Cumsum rows f32 [8, npad] as the engines give K9 and K10, with
    their lengths int64 and sums of squares: noise with a planted step;
    an integer random walk (ties among the extrema and the terms); two
    equal spikes at n - 2 and n - 10 over a valley (the best term ties
    at three positions of one lag); a row zeroed outside its tier (n =
    2); a constant row (psdiff 0); a row of length npad; and a short
    one."""
    rng = np.random.default_rng(seed)
    cs = np.zeros((8, npad), np.float32)
    n = np.full(8, 2, np.int64)
    top = min(npad, 8)
    lens = [max(top, int(rng.integers(npad // 2 + 1, npad + 1))),
            max(top, npad - 1), npad, 2, max(2, npad // 2 + 1), npad,
            min(npad, 5), max(top, npad - 3)]
    for r, L in enumerate(lens):
        n[r] = L
        if r == 0 or r == 5:
            x = rng.normal(0, 1, L)
            x[L // 3:L // 2] += 0.8
            cs[r, :L] = np.cumsum(x - x.mean())
        elif r in (1, 6, 7):
            cs[r, :L] = np.cumsum(rng.integers(-1, 2, L))
        elif r == 2:
            cs[r, L - 2] = 40.0
            if L > 12:
                cs[r, L - 10] = 40.0
                cs[r, L // 2] = -1.0
    tss = (np.diff(cs, axis=1, prepend=0) ** 2).sum(1).astype(np.float32)
    return cs, n, tss


@pytest.mark.parametrize("npad", [8, 64, 512] + [1 << k for k in
                                                 range(10, 17)])
def test_arc_inputs_and_refine_kernels_match_plain(dev, npad):
    """K9 and K10 against their plain versions on the card, bit for bit,
    at frontier buckets 8, 64 and 512 and every whole-recursion tier, n
    int64 and int32, on rows with ties (_stat_rows); one launch each;
    and tmax_batch on the card (K9, B4, K10) equal to tmax_batch on the
    CPU."""
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cs, n, tss = _stat_rows(npad, npad)
    csd, tssd = torch.as_tensor(cs, device=dev), torch.as_tensor(tss,
                                                                 device=dev)
    for nd in (torch.as_tensor(n, device=dev),
               torch.as_tensor(n.astype(np.int32), device=dev)):
        before = dict(st.LAUNCHES)
        k9 = st.arc_inputs(csd, nd, npad, 2)
        p9 = (*st.arc_scan_inputs_plain(csd, nd, npad, 2),
              nd.to(torch.int32))
        for name, a, b in zip(("seed", "lag_hi", "psd2", "ti0", "tj0",
                               "n32"), k9, p9):
            assert _bits_equal(a, b), (name, _differ(a, b))
        seed, lag_hi, psd2, ti0, tj0, n32 = k9
        best, bl0 = arc_scan_cuda.arc_scan(csd, n32, lag_hi, seed, psd2, 2)
        if npad >= 64:
            assert bool((bl0 >= 0).any()) and bool((bl0 < 0).any())
        refine_args = (csd, nd, tssd, lag_hi, best, bl0, ti0, tj0, npad, 2)
        k10 = st.refine(*refine_args)
        p10 = st.refine_plain(*refine_args)
        torch.cuda.synchronize()
        assert st.LAUNCHES["arc_inputs"] == before["arc_inputs"] + 1
        assert st.LAUNCHES["refine"] == before["refine"] + 1
        for name, a, b in zip(("t2", "ti", "tj"), k10, p10):
            assert _bits_equal(a, b), (name, bl0.tolist(), _differ(a, b))
        a = cbs_device.tmax_batch(csd, nd, tssd, npad, 2)
        b = cbs_device.tmax_batch(csd.cpu(), nd.cpu(), tssd.cpu(), npad, 2)
        for name, x, y in zip(("t2", "ti", "tj"), a, b):
            assert _bits_equal(x.cpu(), y), ("cpu", name, _differ(x, y))


@pytest.mark.parametrize("npad", [4096, 16384, 32768, 65536])
def test_arc_scan_kernel_with_racing_floors(dev, npad):
    """B4 on eight rows (_stat_rows, six seeds) whose early lag blocks
    raise the floors of the later ones while those start: every thread of
    a thread block takes the same admission, so none skips its share of
    the staged cumsum (before, some read another thread block's stale
    shared memory, and the garbage maxima pruned the block holding the
    best term).  Bit for bit against the plain version."""
    from canvas_tpu_torch.ops import arc_scan_cuda
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    for seed in range(6):
        cs, n, _tss = _stat_rows(npad, npad + 1000 * seed)
        csd, nd = torch.as_tensor(cs, device=dev), torch.as_tensor(n,
                                                                   device=dev)
        seedv, lag_hi, psd2, _ti0, _tj0, n32 = st.arc_inputs(csd, nd, npad, 2)
        args = (csd, n32, lag_hi, seedv, psd2, 2)
        for _ in range(3):
            best_k, bl0_k = arc_scan_cuda.arc_scan(*args)
            best_p, bl0_p = arc_scan_cuda.arc_scan_plain(*args)
            assert _bits_equal(best_k, best_p), (seed, _differ(best_k,
                                                               best_p))
            assert torch.equal(bl0_k, bl0_p)


def test_tail_kernel_matches_plain(dev):
    """K11 against its plain version on the card at a level's batch, 32
    rows x 100 grid points: b of 0 and 1e-3 (every x <= 0.01), x past the
    9.0 clamp, n from 4 to 65,536 (delta clamped at 0.45 and not); n
    int64 and int32.  Bit for bit: both call the CUDA math library's
    erfc, exp, log and sqrt, and add in the same trees."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    rng = np.random.default_rng(14)
    R = 32
    b = rng.uniform(0.05, 7.0, R)
    b[:3] = [0.0, 1e-3, 1e-3]
    n = rng.integers(4, 65537, R)
    n[:6] = [10000, 10000, 4, 30, 57, 65536]
    bd = torch.as_tensor(b, device=dev)
    for nd in (torch.as_tensor(n, device=dev),
               torch.as_tensor(n.astype(np.int32), device=dev)):
        before = st.LAUNCHES["tail_p"]
        got = st.tail_p(bd, nd, 25, 100)
        want = st.tail_p_plain(bd, nd, 25, 100)
        torch.cuda.synchronize()
        assert st.LAUNCHES["tail_p"] == before + 1
        assert _bits_equal(got, want), float(
            ((got - want).abs() / want.abs().clamp(min=1e-300)).max())
        assert bool(torch.isfinite(got).all()) and float(got[0]) == 0.0


def test_kernel_erfc_equals_torch_erfc(dev):
    """K11's erfc (the CUDA math library's) equals torch.special.erfc on
    the card bit for bit over the arguments the tail probability takes,
    0 to past 27 (where it underflows), and negative ones."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    x = torch.cat([torch.linspace(-6, 30, 200_001, dtype=torch.float64),
                   torch.tensor([0.0, 1e-300, 5e-324, 26.5, 27.3],
                                dtype=torch.float64)]).to(dev)
    assert _bits_equal(st.device_erfc(x), torch.special.erfc(x))


# --- K10 and K11 across thread blocks ---------------------------------------

_TILE = 512          # K10's positions a thread block (csrc/cbs_stats.cu)


def _refine_inputs(dev, cs, n, bl0, al0=2):
    """K10's arguments for cumsum rows cs [B, npad] with lengths n and
    sub-blocks bl0 (-1: none): lag_hi = min(n - al0, n - 1) as K9 gives
    it, best and tss from a seed, the seed's split (1, 2)."""
    B, npad = cs.shape
    rng = np.random.default_rng(B + npad)
    n = np.asarray(n, np.int64)
    return (torch.as_tensor(cs, device=dev), torch.as_tensor(n, device=dev),
            torch.as_tensor(rng.uniform(50, 90, B).astype(np.float32),
                            device=dev),
            torch.as_tensor(np.minimum(n - al0, n - 1).astype(np.int32),
                            device=dev),
            torch.as_tensor(rng.uniform(1, 40, B).astype(np.float32),
                            device=dev),
            torch.as_tensor(np.asarray(bl0, np.int32), device=dev),
            torch.ones(B, dtype=torch.int32, device=dev),
            torch.full((B,), 2, dtype=torch.int32, device=dev), npad, al0)


def _step_row(rng, npad, n, starts, lag):
    """A row of n values on integer levels: -lag and noise of -1, 0 or 1
    (ties everywhere), rising at each start s in a ramp of 2 a position
    from exactly -lag - 1 at s to lag + 1 at s + lag, 20 positions up
    there, then falling over lag + 8 positions.  Its best pairs are the
    ramps' (s, s + lag), equal terms: no other pair has as large a
    difference at as short a lag."""
    row = np.zeros(npad, np.float32)
    level = np.full(n, -float(lag))
    for s in starts:
        level[s:s + lag + 1] = -lag + 2 * np.arange(lag + 1)
        level[s + lag:s + lag + 21] = lag
        down = s + lag + 21 + np.arange(lag + 8)
        down = down[down < n]
        level[down] = lag - 2 * lag * (np.arange(len(down)) + 1) / (lag + 8)
    row[:n] = np.round(level) + rng.integers(-1, 2, n)
    for s in starts:
        row[s + 1:s + lag] = level[s + 1:s + lag]
        row[s], row[s + lag] = -lag - 1, lag + 1
    return row


@pytest.mark.parametrize("npad", [2048, 32768])
@pytest.mark.parametrize("where", ["first", "last", "halo"])
def test_refine_kernel_winner_at_a_tiles_edges(dev, npad, where):
    """K10 with the winning pair at a tile's first position, at its last,
    and with i + lag in the 32 positions past the tile's window (its halo),
    in the first, a middle and the last tile of 4 rows: bit for bit
    against the plain version, and the planted (ti, tj)."""
    rng = np.random.default_rng(npad + len(where))
    tiles = [0, npad // _TILE // 2, npad // _TILE - 1, 1]
    cs, n, bl0, want = [], [], [], []
    for r, tile in enumerate(tiles):
        b0 = 32 * (r + 1) if npad > 2048 else 32 * r
        lag = b0 + {"first": 3, "last": 17, "halo": 31}[where]
        i = tile * _TILE + {"first": 0, "last": _TILE - 1,
                            "halo": 500}[where]
        while i + lag + 30 > npad:
            i -= _TILE
        length = min(npad, i + lag + 30 + int(rng.integers(0, 200)))
        cs.append(_step_row(rng, npad, length, [i], lag))
        n.append(length)
        bl0.append(b0)
        want.append((i + 1, i + lag + 1))
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    args = _refine_inputs(dev, np.stack(cs), n, bl0)
    got, plain = st.refine(*args), st.refine_plain(*args)
    for name, x, y in zip(("t2", "ti", "tj"), got, plain):
        assert _bits_equal(x, y), (name, _differ(x, y))
    assert list(zip(got[1].tolist(), got[2].tolist())) == want


@pytest.mark.parametrize("npad", [512, 2048, 32768])
def test_refine_kernel_ties_across_tiles_and_rows(dev, npad):
    """K10 on 32 rows, each with a sub-block: equal maxima at two positions
    in two tiles (the first wins), the same row twice (equal maxima in two
    rows), lengths that are not a multiple of the tile, an integer random
    walk (ties among lags and positions), rows without an admissible pair
    (the empty row: position 0, lag bl0) and rows of length 1 and 0; ten
    calls back to back each bit for bit against the plain version (the row
    counters and keys are reset), then one under CUDA's sync debug mode
    set to "error"."""
    rng = np.random.default_rng(npad)
    B = 32
    cs = np.zeros((B, npad), np.float32)
    n = np.zeros(B, np.int64)
    bl0 = np.zeros(B, np.int32)
    ties = []
    for r in range(B):
        length = int(rng.integers(npad // 2, npad + 1))
        if r % 4 == 1:
            length = min(npad, (length // _TILE) * _TILE + 77)
        n[r] = max(length, 40)
        b0 = 32 * int(rng.integers(0, min(n[r] // 128, 8) + 1))
        bl0[r] = b0
        kind = r % 8
        if kind in (0, 1):      # equal maxima at two positions, two tiles
            lag = b0 + 5
            i1 = int(rng.integers(0, 40))
            i2 = min(i1 + 2 * _TILE, int(n[r]) - lag - 30)
            starts = [i1, i2] if i2 > i1 + 2 * lag + 40 else [i1]
            cs[r] = _step_row(rng, npad, int(n[r]), starts, lag)
            ties.append((r, i1, lag))
        elif kind in (2, 3):    # an integer random walk
            cs[r, :n[r]] = np.cumsum(rng.integers(-1, 2, n[r]))
        elif kind == 4:         # no admissible pair: lags past lag_hi
            bl0[r] = (max(npad, 64) - 32) // 32 * 32
            n[r] = min(n[r], bl0[r])
            cs[r, :n[r]] = rng.integers(-2, 3, n[r])
        elif kind == 5:
            n[r] = [1, 0, 1, 0][r // 8]
            cs[r, :n[r]] = 3.0
        else:                   # noise with a step
            x = rng.normal(0, 1, n[r])
            x[n[r] // 3:n[r] // 2] += 0.7
            cs[r, :n[r]] = np.cumsum(x - x.mean())
    cs[9], n[9], bl0[9] = cs[8], n[8], bl0[8]       # the same row twice
    ties = [t for t in ties if t[0] != 9]
    args = _refine_inputs(dev, cs, n, bl0)
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    want = st.refine_plain(*args)
    got = [st.refine(*args) for _ in range(10)]
    torch.cuda.synchronize()
    for out in got:
        for name, a, b in zip(("t2", "ti", "tj"), out, want):
            assert _bits_equal(a, b), (name, _differ(a, b))
    ti, tj = want[1].tolist(), want[2].tolist()
    assert (ti[8], tj[8]) == (ti[9], tj[9])
    assert all((ti[r], tj[r]) == (i + 1, i + lag + 1) for r, i, lag in ties)
    empty = [r for r in range(B) if r % 8 in (4, 5)]
    assert all((ti[r], tj[r]) == (1, int(bl0[r]) + 1) for r in empty)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = st.refine(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(_bits_equal(a, b) for a, b in zip(again, want))


def _grid_x(b, n, n_grid, g):
    """x at grid point g of rows b at n bins (kmax 25), as K11 places it."""
    dincr = (0.5 - np.clip(26.0 / n, 0.0, 0.45)) / n_grid
    ts = 0.5 + (g + 0.5) * dincr
    return b / np.sqrt(n) / np.sqrt(ts * (1 - ts))


def _live_batch(R, n_grid, seed):
    """A level's batch b [R] in [0.05, 7) at n bins (4 to 65,536), every
    row with a grid point at x > 0.01, the rows of small b / sqrt(n) with
    dead points (x <= 0.01, no series) before their live ones."""
    rng = np.random.default_rng(seed)
    b, n = np.zeros(R), np.zeros(R, np.int64)
    for r in range(R):
        while True:
            b[r] = rng.uniform(0.05, 7.0)
            u = np.exp(rng.uniform(np.log(0.002), np.log(0.5)))
            n[r] = min(65536, max(4, int((b[r] / u) ** 2)))
            if _grid_x(b[r], n[r], n_grid, n_grid - 1) > 0.01:
                break
    return b, n


@pytest.mark.parametrize("R", [1, 32, 257])
@pytest.mark.parametrize("n_grid", [1, 100, 128])
def test_tail_kernel_all_rows_live(dev, R, n_grid):
    """K11 with every row live (b 0.05-7, n 4 to 65,536; rows with dead
    grid points before their live ones among them), at n_grid 1, 100 and
    128 and R 1, 32 and 257: bit for bit against the plain version, one
    launch."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    b, n = _live_batch(R, n_grid, 1000 * R + n_grid)
    bd, nd = torch.as_tensor(b, device=dev), torch.as_tensor(n, device=dev)
    if R > 1 and n_grid > 1:
        assert (_grid_x(b, n, n_grid, 0) <= 0.01).any()
    before = st.LAUNCHES["tail_p"]
    got = st.tail_p(bd, nd, 25, n_grid)
    want = st.tail_p_plain(bd, nd, 25, n_grid)
    torch.cuda.synchronize()
    assert st.LAUNCHES["tail_p"] == before + 1
    assert _bits_equal(got, want), _differ(got, want)
    assert bool(torch.isfinite(got).all())


def test_tail_kernel_repeats_and_does_not_synchronise(dev):
    """K11 ten times back to back on a level of 32 rows, live and dead,
    each bit for bit against the plain version (its count of live points
    is reset), then once under CUDA's sync debug mode set to "error", and
    once on a level without a live grid point."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    b, n = _live_batch(32, 100, 15)
    b[:4] = [0.0, 1e-3, 0.05, 2.0]
    n[:4] = [10000, 10000, 65536, 30]
    bd, nd = torch.as_tensor(b, device=dev), torch.as_tensor(n, device=dev)
    want = st.tail_p_plain(bd, nd, 25, 100)
    got = [st.tail_p(bd, nd, 25, 100) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(_bits_equal(g, want) for g in got)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = st.tail_p(bd, nd, 25, 100)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _bits_equal(again, want)
    dead = bd * 1e-4                      # no live grid point at all
    assert _bits_equal(st.tail_p(dead, nd, 25, 100),
                       st.tail_p_plain(dead, nd, 25, 100))


def test_tail_kernel_series_terms_equal_plain(dev):
    """K11's series terms, from its table of sqrt(k) and 2 / k and with its
    division by 2 made a multiplication by 0.5, equal nu_plain's terms
    bit for bit at every k = 1..8,192, for x of 0.0101 to 30 and x whose
    products fall to subnormals."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    xs = torch.tensor([0.0101, 0.3, 1.0, 4.0, 30.0, 3e-308, 1e-320],
                      dtype=torch.float64, device=dev)
    K = st.NU_SERIES_TERMS
    x = xs.repeat_interleave(K)
    k = torch.arange(1, K + 1, device=dev).double().repeat(len(xs))
    two = torch.full((), 2.0, dtype=torch.float64, device=dev)
    sqrt2 = torch.full((), float(np.sqrt(2.0)), dtype=torch.float64,
                       device=dev)
    want = torch.special.erfc(x * torch.sqrt(k) / two / sqrt2) * 0.5 \
        * (two / k)
    got = st.device_series_terms(x)
    assert _bits_equal(got, want), _differ(got, want)


def _perm_rows(dev, npad, seed, S):
    """K12's inputs for S rows of a bucket of width npad: centred noise
    of lengths in (npad / 2, npad] (and 150 at widths above 256, a
    full-arc row), hybrid where n > 200, random chunk keys, about two
    thirds of the rows under the mask."""
    rng = np.random.default_rng(seed)
    x = np.zeros((S, npad), np.float32)
    n = rng.integers(npad // 2 + 1, npad + 1, S).astype(np.int64)
    if npad > 256:
        n[1::3] = 150
    n = np.maximum(n, min(npad, 4))
    for r in range(S):
        v = rng.normal(0, 1, n[r])
        v[: n[r] // 3] += 0.3
        x[r, :n[r]] = v - v.mean()
    mask = rng.random(S) < 0.67
    mask[:2] = True
    return {"x": torch.as_tensor(x, device=dev),
            "n": torch.as_tensor(n, device=dev),
            "tss": torch.as_tensor((x.astype(np.float64) ** 2).sum(1)
                                   .astype(np.float32), device=dev),
            "keys": torch.as_tensor(rng.integers(0, 2 ** 32, (S, 2)),
                                    device=dev),
            "mask": torch.as_tensor(mask, device=dev),
            "hybrid": torch.as_tensor(n > 200, device=dev)}


@pytest.mark.parametrize("npad", [8, 64, 512] + [1 << k for k in
                                                 range(10, 17)])
def test_perm_kernel_matches_plain(dev, npad):
    """K12 against its plain version on the card at frontier buckets 8,
    64 and 512 and widths 1,024 to 65,536 (the slab): P = 768 where the
    frontier takes it (npad <= 8,192) and 512, hybrid and full-arc rows
    (lags bounded by max_len = 200) under a mask, zero elsewhere; one
    launch; statistics bit for bit."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    S = 12 if npad <= 4096 else 4
    inp = _perm_rows(dev, npad, npad, S)
    for P in ((768, 512) if npad <= 8192 else (512,)):
        before = mc.LAUNCHES["perm"]
        got = mc.perm_stats(**inp, P=P, al0=2, kmax=25, max_len=200)
        want = mc.perm_stats_plain(**inp, P=P, al0=2, kmax=25, max_len=200)
        torch.cuda.synchronize()
        assert mc.LAUNCHES["perm"] == before + 1
        assert _bits_equal(got, want)
        assert bool((got[~inp["mask"]] == 0).all())
        assert bool((got[inp["mask"]] > 0).any())


def test_perm_kernel_full_arcs_without_a_bound(dev):
    """p_method other than hybrid: every row full-arc with max_len 2^30
    (the frontier's n_min then), and a walk's continuation chunk: every
    row under the mask, max_len the longest row."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    inp = _perm_rows(dev, 512, 3, 6)
    inp["hybrid"] = torch.zeros_like(inp["hybrid"])
    for max_len in (1 << 30, int(inp["n"].max())):
        args = dict(inp, P=512, al0=2, kmax=25, max_len=max_len)
        assert _bits_equal(mc.perm_stats(**args), mc.perm_stats_plain(**args))
    inp["mask"] = torch.ones_like(inp["mask"])
    args = dict(inp, P=512, al0=2, kmax=25, max_len=int(inp["n"].max()))
    assert _bits_equal(mc.perm_stats(**args), mc.perm_stats_plain(**args))


@pytest.mark.parametrize("npad", [4096, 8192])
@pytest.mark.parametrize("rows", [1, 2, 33, 1024])
@pytest.mark.parametrize("P", [768, 512])
def test_perm_kernel_across_its_group_rule(dev, npad, rows, P):
    """K12 with 1, 2, 33 and 1,024 masked rows at the frontier's widths
    4,096 and 8,192, P 768 and 512: launches whose items step K12's group
    rule (groups a block, two buffers or one) across its range; the
    layout the card chose is the Python mirror's, one launch a call, the
    statistics bit for bit against the plain version."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    S = min(mc.MAX_ROWS, rows + 2)
    inp = _perm_rows(dev, npad, npad + rows + P, S)
    mask = torch.zeros(S, dtype=torch.bool, device=dev)
    mask[:rows] = True
    inp["mask"] = mask
    grid = mc.perm_grid(dev)
    items = rows * P
    assert mc.device_perm_layout(npad, items, grid) == {
        k: v for k, v in mc.perm_layout(npad, items, grid).items()
        if k in ("groups", "buffers", "bytes", "double_bytes")}
    before = mc.LAUNCHES["perm"]
    got = mc.perm_stats(**inp, P=P, al0=2, kmax=25, max_len=200)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["perm"] == before + 1
    want = mc.perm_stats_plain(**inp, P=P, al0=2, kmax=25, max_len=200)
    assert _bits_equal(got, want), _differ(got, want)
    assert bool((got[rows:] == 0).all()) and bool((got[:rows] > 0).all())


def test_perm_kernel_without_a_masked_row(dev):
    """A K12 launch with no row under its mask writes zeros over its
    output (which starts as whatever torch.empty held) and nothing else."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    inp = _perm_rows(dev, 4096, 9, 8)
    inp["mask"] = torch.zeros_like(inp["mask"])
    before = mc.LAUNCHES["perm"]
    got = [mc.perm_stats(**inp, P=768, al0=2, kmax=25, max_len=200)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert mc.LAUNCHES["perm"] == before + 2
    for g in got:
        assert g.shape == (8, 768) and bool((g == 0).all())


def test_perm_kernel_ten_launches_back_to_back(dev):
    """Ten K12 launches in a row on one stream, alternating widths, masks
    and chunk sizes, each bit for bit against its plain version."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    cases = []
    for i in range(10):
        npad = (1024, 4096, 8192)[i % 3]
        inp = _perm_rows(dev, npad, 100 + i, 5)
        cases.append(dict(inp, P=(768, 512)[i % 2], al0=2, kmax=25,
                          max_len=200))
    got = [mc.perm_stats(**c) for c in cases]
    torch.cuda.synchronize()
    for g, c in zip(got, cases):
        want = mc.perm_stats_plain(**c)
        assert _bits_equal(g, want), _differ(g, want)


def _k9_tie_rows(npad, seed):
    """K9's inputs whose extrema tie across its tiles: integer random-walk
    cumsum rows with the maximum planted on the last position of every
    odd tile and the first of the next, the minimum likewise after the
    even ones (in a row of one tile, twice inside it), at n = 1, 2, a
    tile's width - 1, + 1 and itself, and npad (those that fit), and
    values past n that would win if they counted."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    rng = np.random.default_rng(seed)
    T = min(npad, st.K9_TILE)
    tiles = npad // T
    lens = sorted({L for L in (1, 2, T - 1, T, T + 1, npad - 1, npad)
                   if 1 <= L <= npad})
    cs = np.zeros((len(lens), npad), np.float32)
    for r, L in enumerate(lens):
        w = np.cumsum(rng.integers(-3, 4, npad)).astype(np.float32)
        top, low = w[:L].max() + 5, w[:L].min() - 5
        if tiles > 1:
            for k in range(1, tiles):
                w[k * T - 1] = w[k * T] = top if k % 2 else low
        elif npad >= 8:
            w[T // 3] = w[T // 2] = top
            w[T // 5] = w[T // 4] = low
        w[L:] = np.where(np.arange(npad - L) % 2, top + 9, low - 9)
        cs[r] = w
    return cs, np.asarray(lens, np.int64)


@pytest.mark.parametrize("npad", [8, 64, 512] + [1 << k for k in
                                                 range(10, 17)])
def test_arc_inputs_kernel_ties_across_tiles(dev, npad):
    """K9 at the frontier's buckets 8, 64, 512 and every whole-recursion
    tier, its rows split over tiles of 8,192 positions, on rows whose equal
    extrema lie in different tiles and on a tile's first and last
    position, n = 1, 2, the tile's width - 1, + 1 and itself, and npad:
    one launch, every output bit for bit against the plain version."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cs, n = _k9_tie_rows(npad, npad + 1)
    csd, nd = torch.as_tensor(cs, device=dev), torch.as_tensor(n, device=dev)
    before = st.LAUNCHES["arc_inputs"]
    got = st.arc_inputs(csd, nd, npad, 2)
    want = (*st.arc_scan_inputs_plain(csd, nd, npad, 2), nd.to(torch.int32))
    torch.cuda.synchronize()
    assert st.LAUNCHES["arc_inputs"] == before + 1
    for name, a, b in zip(("seed", "lag_hi", "psd2", "ti0", "tj0", "n32"),
                          got, want):
        assert _bits_equal(a, b), (name, _differ(a, b))


def test_arc_inputs_kernel_ten_calls_back_to_back(dev):
    """Ten K9 calls in a row at widths of 4 and 8 tiles and one, each bit
    for bit against its plain version: the row counters the last tile
    leaves zero serve the next call."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cases = []
    for i in range(10):
        npad = (32768, 65536, 4096)[i % 3]
        cs, n = _k9_tie_rows(npad, 50 + i)
        cases.append((torch.as_tensor(cs, device=dev),
                      torch.as_tensor(n, device=dev), npad))
    got = [st.arc_inputs(cs, n, npad, 2) for cs, n, npad in cases]
    torch.cuda.synchronize()
    for g, (cs, n, npad) in zip(got, cases):
        want = (*st.arc_scan_inputs_plain(cs, n, npad, 2),
                n.to(torch.int32))
        for a, b in zip(g, want):
            assert _bits_equal(a, b), _differ(a, b)
    state = st._STATE[dev if dev.index is not None else
                      torch.device("cuda", torch.cuda.current_device())]
    assert int(state["k9_count"].abs().sum()) == 0


def test_k9_and_k12_make_no_synchronising_call(dev):
    """One K9 call (a row of 8 tiles) and one K12 call under CUDA's sync
    debug mode set to "error", after a first call has built the kernels
    and made their state."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cs, n = _k9_tie_rows(32768, 3)
    csd, nd = torch.as_tensor(cs, device=dev), torch.as_tensor(n, device=dev)
    inp = _perm_rows(dev, 4096, 4, 6)
    args = dict(inp, P=768, al0=2, kmax=25, max_len=200)
    st.arc_inputs(csd, nd, 32768, 2)
    mc.perm_stats(**args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k9 = st.arc_inputs(csd, nd, 32768, 2)
        k12 = mc.perm_stats(**args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = (*st.arc_scan_inputs_plain(csd, nd, 32768, 2), nd.to(torch.int32))
    assert all(_bits_equal(a, b) for a, b in zip(k9, want))
    assert _bits_equal(k12, mc.perm_stats_plain(**args))


def test_layout_mirrors_equal_the_source(dev):
    """cbs_mega_cuda's Python mirrors of K7's and K8's layouts and of K12's
    group rule equal what csrc/cbs_mega.cu computes, at every width from
    8 to 65,536 and item counts from 1 to 1,024 x 768 over this card's
    grid and others."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    grids = (mc.perm_grid(dev), 66, 1)
    keys = ("groups", "buffers", "bytes", "double_bytes")
    for k in range(3, 17):
        npad = 1 << k
        for edge in (False, True):
            assert mc.device_layout(npad, edge) == mc.layout(npad, edge)
        for items in (1, 512, 768, 2 * 768, 33 * 512, 1024 * 768):
            for grid in grids:
                mirror = mc.perm_layout(npad, items, grid)
                assert mc.device_perm_layout(npad, items, grid) == {
                    key: mirror[key] for key in keys}, (npad, items, grid)


def test_level_tile_layout_mirrors_the_source(dev):
    """cbs_level_cuda.tile_layout, the Python mirror of K13's and K15's
    tile rule, equals csrc/cbs_level.cu's tile_width at every Tmax from
    1,024 to 65,536 and every row count from 1 to 1,024."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    for k in range(10, 17):
        for rows in range(1, 1025):
            assert cl.device_layout(rows, 1 << k) == \
                cl.tile_layout(rows, 1 << k), (rows, 1 << k)


def _edge_table(Tmax, W, dev, seed=0):
    """A level's inputs whose rows' lengths sit at K13's tile edges, one
    below and one above them (the first with an infinity), beside a
    constant row, a row with a NaN, a short row and a slot not pending;
    the level's buffers."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    tile, tiles = cl.prologue_layout(W, Tmax)
    rng = np.random.default_rng(seed)
    lens = [m for k in range(1, tiles + 1)
            for m in (k * tile - 1, k * tile, k * tile + 1) if m <= Tmax]
    lens = (lens + list(rng.integers(4, Tmax + 1, W)))[:W - 4]
    n = lens + [900, 600, 3, 700]
    S = 2 * W
    lo = [int(rng.integers(0, Tmax - m + 1)) for m in n]
    contigs = rng.normal(0, 1, (len(n), Tmax)).astype(np.float32)
    contigs[-4, :] = 2.5
    contigs[-3, lo[-3] + 5] = np.nan
    contigs[0, lo[0] + 3] = -np.inf
    tab = torch.zeros(3 * S + cl.CTL, dtype=torch.int64)
    pending0 = torch.zeros(S, dtype=torch.bool)
    for s, (m, start) in enumerate(zip(n, lo)):
        tab[s], tab[S + s], tab[2 * S + s] = s, start, start + m
        pending0[s] = s != len(n) - 1
    tab[len(n):S] = -1
    tab[3 * S + cl.LIVE] = 1
    lv = cl.level_buffers(W, Tmax, len(cl.tier_widths(Tmax)), dev)
    return (torch.as_tensor(contigs, device=dev), tab.to(dev),
            pending0.to(dev), lv)


@pytest.mark.parametrize("Tmax,W", [(1024, 32), (4096, 32), (32768, 64),
                                    (65536, 512)])
def test_k13_k15_tiles_match_plain_at_tile_edges(dev, Tmax, W):
    """K13 and K15 on rows whose lengths, and splits, sit at their tiles'
    edges (one below, one above), beside a constant row and rows with a
    NaN and an infinity, which are not analyzable, bit for bit equal to
    their plain versions, three calls in a row; K15's arrival counters
    left zero."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    contigs, tab, pending0, lv = _edge_table(Tmax, W, dev, seed=Tmax + W)
    S = pending0.shape[0]
    for _ in range(3):
        cl.prologue(contigs, tab, pending0, lv, 2)
        _assert_bits(lv, cl.prologue_plain(contigs, tab, pending0, W, 2),
                     "K13")
    assert int(lv["analyzable"].sum()) == W - 5
    tile = cl.edge_layout(W, Tmax)[0]
    rng = np.random.default_rng(W)
    n = lv["n"].cpu().numpy()
    ti = np.array([min(max(1, tile * (r % 3) + r % 3 - 1), int(m) - 1)
                   for r, m in enumerate(n)])
    tj = np.array([min(int(m) - 1 if r % 2 else tile + 1, int(m))
                   for r, m in enumerate(n)])
    tj = np.maximum(tj, ti + 1)
    lv["ti"].copy_(torch.as_tensor(ti, dtype=torch.int32))
    lv["tj"].copy_(torch.as_tensor(tj, dtype=torch.int32))
    lv["trivial"].copy_(torch.as_tensor(rng.random(W) < 0.5))
    walked = torch.as_tensor(rng.random(W) < 0.5, device=dev)
    alpha = torch.tensor(0.01, dtype=torch.float32, device=dev)
    for _ in range(3):
        cl.edge_setup(tab, S, lv, walked, alpha, 1000)
        _assert_bits(lv, cl.edge_setup_plain(
            lv["x"], lv["n"], lv["ti"], lv["tj"], lv["trivial"], walked,
            alpha, 1000, Tmax), "K15")
        torch.cuda.synchronize()
        assert not bool(lv["k15_count"].any())


def test_statistics_wrappers_raise_on_bad_inputs(dev):
    """K9-K12's wrappers on the card raise on tensors of other types,
    and on devices other than cuda and cpu."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cs, n, tss = (torch.as_tensor(a, device=dev) for a in _stat_rows(64, 1))
    with pytest.raises(ValueError, match="float32"):
        st.arc_inputs(cs.double(), n, 64, 2)
    with pytest.raises(ValueError, match="int32 or int64"):
        st.arc_inputs(cs, n.float(), 64, 2)
    seed, lag_hi, psd2, ti0, tj0, _n32 = st.arc_inputs(cs, n, 64, 2)
    best = seed.clone()
    bl0 = torch.full_like(lag_hi, -1)
    with pytest.raises(ValueError, match="bl0"):
        st.refine(cs, n, tss, lag_hi, best, bl0.long(), ti0, tj0, 64, 2)
    with pytest.raises(ValueError, match="float64"):
        st.tail_p(best, n, 25, 100)
    with pytest.raises(ValueError, match="n_grid"):
        st.tail_p(best.double(), n, 25, 129)
    inp = _perm_rows(dev, 64, 2, 4)
    with pytest.raises(ValueError, match="keys"):
        mc.perm_stats(**dict(inp, keys=inp["keys"].int()), P=512, al0=2,
                      kmax=25, max_len=200)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        st.arc_inputs(cs.to(meta), n.to(meta), 64, 2)
    with pytest.raises(ValueError, match="device"):
        st.tail_p(best.double().to(meta), n.to(meta), 25, 100)
    with pytest.raises(ValueError, match="device"):
        mc.perm_stats(**{k: v.to(meta) for k, v in inp.items()}, P=512,
                      al0=2, kmax=25, max_len=200)


def test_frontier_level_reads_nothing_before_its_output(dev):
    """One frontier level on the card (K9, B4, K10, K11 and K12 for chunk
    0) under CUDA's sync debug mode set to "error": no synchronising call
    up to the caller's read of its output, which equals the level on CPU
    tensors (the tail probability within 1e-12: the CPU's erfc is not the
    card's)."""
    from canvas_tpu_torch.ops import cbs_device

    cov = _cbs_panel(n=1200)
    mat = np.stack([cov[k] for k in cov]).astype(np.float32)
    c, lo, nn = [0, 1, 2, 0], [0, 0, 100, 600], [1200, 1000, 900, 150]
    keys = cbs_device._seg_keys_np(5, c, lo, nn, 0).astype(np.int64)
    host = (torch.as_tensor(mat), torch.as_tensor(c), torch.as_tensor(lo),
            torch.as_tensor(nn), torch.as_tensor(keys))
    rest = (0.01, 2048, 768, 2, 25, 200, 100, True)
    want = cbs_device._level(*host, *rest)
    args = [t.to(dev) for t in host]
    cbs_device._level(*args, *rest)
    torch.cuda.synchronize()                 # the kernels are built
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cbs_device._level(*args, *rest)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = got.cpu()
    assert bool(got[:, 5].any())             # a row took chunk 0
    keep = [0, 1, 2, 4, 5] + list(range(6, got.shape[1]))
    assert torch.equal(got[:, keep], want[:, keep])
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=1e-12, atol=0)


def test_engines_launch_the_statistics_kernels(dev):
    """On the card the whole-recursion engine's replayed level takes K9,
    B4 and K10 for every tier (a tier without a row returns at once) and
    K11 once, in its variant that carries K14 (tail_decide); the frontier
    engine the same for every bucket, K11 without K14, and K12 for its
    permutation chunks."""
    from canvas_tpu_torch.ops import (arc_scan_cuda, cbs_device, cbs_mega,
                                      cbs_mega_cuda, cbs_stats_cuda)

    def counted(run):
        counts = (arc_scan_cuda.LAUNCHES, cbs_stats_cuda.LAUNCHES,
                  cbs_mega_cuda.LAUNCHES)
        before = [dict(c) for c in counts]
        out = run()
        torch.cuda.synchronize()
        diff = {}
        for c, b in zip(counts, before):
            diff.update({k: c[k] - b[k] for k in c})
        return out, diff

    cov = _cbs_panel()
    counts: dict = {}
    cbs_mega.run_cbs_mega(cov, n_perm=1000, device=dev)    # the capture
    r0 = cbs_mega.GRAPHS["replays"]
    _lens, d = counted(lambda: cbs_mega.run_cbs_mega(
        cov, n_perm=1000, device=dev, counts=counts))
    replays = cbs_mega.GRAPHS["replays"] - r0
    assert d["arc_inputs"] == d["refine"] == d["arc_scan"] \
        == replays * len(cbs_mega._tiers(4096))
    assert d["tail_decide"] == replays >= counts["levels"]
    assert d["tail_p"] == 0 and d["perm"] == 0
    levels: list = []
    _lens, d = counted(lambda: cbs_device.run_cbs_device(
        cov, n_perm=1000, device=dev, levels=levels))
    buckets = sum(lv["buckets"] for lv in levels)
    assert d["arc_inputs"] == d["refine"] == d["arc_scan"] == buckets
    assert d["tail_p"] == buckets and d["perm"] >= buckets
    assert d["tail_decide"] == 0


def test_run_cbs_engines_on_card(dev, monkeypatch):
    """run_cbs on cuda: the whole-recursion engine for the planted panel,
    the frontier engine where its table overflows, the host engine above
    65,536 bins."""
    from canvas_tpu_torch.ops import cbs, cbs_device, cbs_mega

    cov = _cbs_panel()
    got = cbs.run_cbs(cov, n_perm=1000, device=dev)
    assert cbs.last_engine() == "mega"
    want = cbs_mega.run_cbs_mega(cov, n_perm=1000, device="cpu")
    for k in cov:
        np.testing.assert_array_equal(got[k], want[k])

    r = np.random.default_rng(13).normal(0, 0.3, 480)
    r[np.arange(480) // 40 % 2 == 1] += 6.0
    monkeypatch.setattr(cbs_mega, "_MIN_SLOTS", 4)
    got = cbs.run_cbs({"chr1": r}, n_perm=500, device=dev)
    assert cbs.last_engine() == "frontier"
    want = cbs_device.run_cbs_device({"chr1": r}, n_perm=500, device=dev)
    np.testing.assert_array_equal(got["chr1"], want["chr1"])
    assert len(got["chr1"]) == 12

    big = {"chr1": np.random.default_rng(1).normal(0, 1, 65537)}
    big["chr1"][30000:31000] += 1.5
    got = cbs.run_cbs(big, n_perm=500, device=dev)
    assert cbs.last_engine() == "host"
    assert len(got["chr1"]) >= 3


@pytest.mark.parametrize("lengths,scale", [
    ((1, 999, 5_003, 200_017), 1.0),
    ((70_001, 3_333), 0.01),          # tiny weights: most values capped
    ((123_457,), 50.0),               # large weights: small fractions
])
def test_gc_weighted_bin_sample_on_card_equals_cpu(dev, lengths, scale):
    """GCContentWeighted binning on ragged contigs: starts, ends, GC and the
    rounded float32 row sums (position order) equal on the card and on the
    CPU."""
    from canvas_tpu_torch.ops import binning

    rng = np.random.default_rng(len(lengths))
    ratio = (rng.uniform(0.3, 3.0, 101) * scale).astype(np.float32)
    tracks = {f"c{i}": dict(possible=rng.random(n) < 0.8,
                            observed=rng.poisson(2.0, n).astype(np.uint8),
                            is_gc=rng.random(n) < 0.45,
                            offset=int(rng.integers(0, min(n, 500))),
                            gc_weights=ratio[rng.integers(0, 101, n)])
              for i, n in enumerate(lengths)}
    got = binning.bin_sample(tracks, 97, mode="GCContentWeighted", device=dev)
    want = binning.bin_sample(tracks, 97, mode="GCContentWeighted",
                              device="cpu")
    assert set(got) == set(want)
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)
    whole_bins = sum(int(t["possible"][t["offset"]:].sum()) // 97
                     for t in tracks.values())
    assert sum(len(v[0]) for v in want.values()) == whole_bins > 500


@pytest.mark.parametrize("clusters", [False, True])
def test_evaluate_grid_on_card_equals_numpy(dev, clusters):
    """The float64 grid on the card: the numpy oracle's CN assignments and
    chosen model, floats within 1e-12 relative."""
    from canvas_tpu_torch.models import segment_model, somatic, somatic_grid

    rng = np.random.default_rng(8)
    n = 160
    infos = []
    for i in range(n):
        seg = segment_model.Segment("chr1", i * 100_000, (i + 1) * 100_000,
                                    np.full(10, 1.0, np.float32))
        cov = float(rng.choice([20.0, 30.0, 40.0, 50.0]) + rng.normal(0, 1))
        maf = float(rng.uniform(0.1, 0.5)) if i % 4 else -1.0
        infos.append(somatic.SegmentInfo(seg, cov, maf,
                                         float(rng.uniform(1, 5))))
    kw = {}
    if clusters:
        kw = dict(cluster_ids=rng.integers(1, 9, n), n_clusters=8,
                  mean_coverage=30.0)
    cov = np.repeat(np.arange(10.0, 60.0), 81)
    pur = np.tile(np.arange(20, 101) / 100.0, 50)
    args = (cov, pur, infos, somatic.initialize_ploidies(30.0), 0.02,
            3_000_000)
    got = somatic_grid.evaluate_grid(*args, device=dev, **kw)
    want = somatic_grid.evaluate_grid_numpy(*args, **kw)
    np.testing.assert_array_equal(got["cns"], want["cns"])
    assert int(np.argmin(got["deviation"])) == int(np.argmin(want["deviation"]))
    for k in want:
        if k != "cns":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                       err_msg=k)


# --- more than one device --------------------------------------------------

def test_kernels_launch_on_the_tensors_device(dev):
    """B1, B2, B3 and B4 on cuda:1 while cuda:0 is current: each launcher
    makes the tensors' device current around its C call, so stream,
    memsets and launch belong to cuda:1; results equal the plain
    versions."""
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(8)
    Lp = 40 * prefix_cuda.TILE
    p, o, g = (torch.as_tensor(x).to(d1) for x in (
        rng.integers(0, 256, Lp // 8, dtype=np.uint8),
        rng.integers(0, 16, Lp, dtype=np.uint8),
        rng.integers(0, 256, Lp // 8, dtype=np.uint8)))
    got = prefix_cuda.fused_prefix_sums(p, o, g, 77, Lp - 5, 10)
    want = prefix_cuda.fused_prefix_sums_plain(p, o, g, 77, Lp - 5, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    log_em, lt, li, mask = _decode_problem(
        3, 4, 2000, [2000, 1999, 700, 0], "uniform")
    em_t = torch.as_tensor(log_em, device=d1)
    mask_t = torch.as_tensor(mask, device=d1)
    n = hmm.prefix_lengths(mask)
    path = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=256,
                                      lengths=n)
    assert path.device == d1
    assert torch.equal(path, hmm.viterbi_decode_chunked(
        em_t, mask_t, lt, li, chunk=256, plain=True, lengths=n))
    cs, n, tss = _arc_rows(5, 4096, 4)
    args = (torch.as_tensor(cs, device=d1), torch.as_tensor(n, device=d1),
            torch.as_tensor(tss, device=d1), 4096, 2)
    before = arc_scan_cuda.LAUNCHES["arc_scan"]
    got = cbs_device.tmax_batch(*args)
    assert arc_scan_cuda.LAUNCHES["arc_scan"] == before + 1
    want = cbs_device.tmax_batch(*(a.cpu() if torch.is_tensor(a) else a
                                   for a in args))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0


def _coverage(seed, n_contigs):
    rng = np.random.default_rng(seed)
    cov = {}
    for i in range(n_contigs):
        c = rng.poisson(100.0, int(rng.integers(500, 5000))).astype(float)
        c[100:300] = rng.poisson(50.0, 200)
        cov[f"chr{i + 1}"] = c
    return cov


@pytest.mark.parametrize("joint", [False, True])
def test_lane_split_decode_on_a_virtual_mesh_equals_unsplit(dev, joint):
    """Six contigs (8 lanes) over [cuda:0] * 4: four B2 and four B3
    launches, breakpoints equal to the unsplit decode's on the card."""
    cov = _coverage(5, 6)
    if joint:
        rng = np.random.default_rng(6)
        cov = {c: np.stack([v, rng.poisson(100.0, len(v)), v], axis=1)
               for c, v in cov.items()}
        fn = hmm.segment_coverage_joint_batched
    else:
        fn = hmm.segment_coverage_batched
    whole = fn(cov, device=torch.device("cuda", 0))
    before = dict(viterbi_cuda.LAUNCHES)
    split = fn(cov, devices=[torch.device("cuda", 0)] * 4)
    torch.cuda.synchronize()
    for k in viterbi_cuda.LAUNCHES:
        assert viterbi_cuda.LAUNCHES[k] == before[k] + 4
    assert split == whole
    assert all(len(b) >= 2 for b in split.values())


def test_round_robin_bin_sample_on_a_virtual_mesh_equals_unsplit(dev):
    """Four contigs over [cuda:0] * 4: one B1 launch a contig, bins equal
    to the unsplit run's and to bin_contig_np."""
    from canvas_tpu_torch.ops import binning

    rng = np.random.default_rng(9)
    tracks = {}
    for i, L in enumerate((70_001, 123_457, 4_096, 300_000)):
        possible = rng.random(L) < 0.8
        observed = rng.poisson(0.5, size=L).astype(np.uint8)
        observed[~possible] = 0
        tracks[f"chr{i}"] = dict(possible=possible, observed=observed,
                                 is_gc=rng.random(L) < 0.4, offset=i * 11)
    whole = binning.bin_sample(tracks, 64, device=torch.device("cuda", 0))
    before = prefix_cuda.LAUNCHES["prefix_scan"]
    split = binning.bin_sample(tracks, 64,
                               devices=[torch.device("cuda", 0)] * 4)
    assert prefix_cuda.LAUNCHES["prefix_scan"] == before + 4
    for name, t in tracks.items():
        host = binning.bin_contig_np(t["possible"], t["observed"],
                                     t["is_gc"], 64, t["offset"],
                                     "TruncatedDynamicRange")
        for a, b, c in zip(split[name], whole[name], host):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(np.asarray(a, np.float64),
                                          np.asarray(c, np.float64))


@pytest.mark.parametrize("use_all_states", [True, False])
def test_segmentation_step_on_card_equals_cpu(dev, use_all_states):
    from canvas_tpu_torch import graft_entry
    from canvas_tpu_torch.pipeline import device_pipeline

    args = graft_entry._demo_segmentation_inputs(device=dev)
    before = dict(viterbi_cuda.LAUNCHES)
    got = device_pipeline.segmentation_step(
        *args, use_all_states=use_all_states)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES["chunk_matrix"] == \
        before["chunk_matrix"] + 1
    want = device_pipeline.segmentation_step(
        *(a.cpu() for a in args), use_all_states=use_all_states)
    assert torch.equal(got.cpu(), want)


def _cards():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("joint", [False, True])
def test_lane_split_decode_on_the_visible_cards_equals_unsplit(dev, joint):
    """An unindexed "cuda" splits the lanes over every visible card: one
    B2 and one B3 launch a card, breakpoints equal to cuda:0's alone."""
    cards = _cards()
    cov = _coverage(7, 2 * len(cards) - 1)
    fn = hmm.segment_coverage_joint_batched if joint else \
        hmm.segment_coverage_batched
    whole = fn(cov, device=cards[0])
    before = dict(viterbi_cuda.LAUNCHES)
    split = fn(cov, device="cuda")
    # canvas_tpu's rule: B = next_pow2(2n - 1), split when n divides it
    groups = len(cards) if hmm._next_pow2(len(cov)) % len(cards) == 0 \
        else 1
    for k in viterbi_cuda.LAUNCHES:
        assert viterbi_cuda.LAUNCHES[k] == before[k] + groups
    assert split == whole


def test_round_robin_bin_sample_on_the_visible_cards(dev):
    from canvas_tpu_torch.ops import binning

    cards = _cards()
    rng = np.random.default_rng(10)
    tracks = {f"chr{i}": dict(possible=rng.random(L) < 0.8,
                              observed=rng.poisson(0.5, L).astype(np.uint8),
                              is_gc=rng.random(L) < 0.4, offset=i)
              for i, L in enumerate(range(50_000, 50_000 + 9_999 *
                                          (len(cards) + 1), 9_999))}
    assert set(binning.contig_placement(tracks, cards).values()) == \
        set(cards)
    got = binning.bin_sample(tracks, 64, device="cuda")
    want = binning.bin_sample(tracks, 64, device=cards[0])
    for name in tracks:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)


def test_dryrun_on_the_visible_cards(dev, capsys):
    from canvas_tpu_torch import graft_entry

    cards = _cards()
    graft_entry.dryrun_multichip(len(cards))
    assert "split == single-device" in capsys.readouterr().out


def test_statistics_kernels_keep_their_state_per_card(dev):
    """K10 and K11 on cuda:1 while cuda:0 is current, in turns with calls
    on cuda:0: each card makes and keeps its own series table, grid and
    zeroed counters, and every result equals the plain version."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cards = _cards()[:2]
    torch.cuda.set_device(0)
    b, n = _live_batch(32, 100, 16)
    b[:3] = 0.0
    cs, nn, tss = _stat_rows(4096, 4096)
    for d in (cards[1], cards[0], cards[1], cards[0]):
        bd, nd = torch.as_tensor(b, device=d), torch.as_tensor(n, device=d)
        assert _bits_equal(st.tail_p(bd, nd, 25, 100),
                           st.tail_p_plain(bd, nd, 25, 100))
        args = _refine_inputs(d, cs, nn, [32 * r for r in range(8)])
        for x, y in zip(st.refine(*args), st.refine_plain(*args)):
            assert _bits_equal(x, y), _differ(x, y)
        torch.cuda.synchronize(d)
    states = [st._STATE[d] for d in cards]
    assert states[0] is not states[1]
    for d, state in zip(cards, states):
        assert all(state[k].device == d for k in ("table", "count", "key"))
    assert torch.cuda.current_device() == 0


# --- the whole-recursion engine's level body (K13-K16) and its graph ------

def _bench_cbs(B=24, T=16 * 1024):
    """bench.py's CBS workload: B contigs of T bins of N(0, 1) from
    default_rng(1), +1.5 on [T/4, T/3) and -1.2 on [T/2, T/2 + 600)."""
    rng = np.random.default_rng(1)
    cov = {}
    for b in range(B):
        c = rng.normal(0.0, 1.0, size=T)
        c[T // 4: T // 3] += 1.5
        c[T // 2: T // 2 + 600] -= 1.2
        cov[f"chr{b}"] = c
    return cov


_LEVEL_WRAPPERS = ("prologue", "tail_decide", "edge_setup", "keep_table")


def _run_mega(cov, dev, graph=True, **kw):
    """run_cbs_mega over cov on dev; graph=False runs its levels eagerly
    (the engine's _mega_recurse bound with graph=False for the call)."""
    import functools

    from canvas_tpu_torch.ops import cbs_mega

    orig = cbs_mega._mega_recurse
    if not graph:
        cbs_mega._mega_recurse = functools.partial(orig, graph=False)
    try:
        return cbs_mega.run_cbs_mega(cov, device=dev, **kw)
    finally:
        cbs_mega._mega_recurse = orig


def _clone(a):
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, dict):
        return {k: v.clone() for k, v in a.items()}
    return a


def _level_records(cov, dev, **kw):
    """The arguments (cloned) of every call of K13-K16's wrappers during
    an eager run of the whole-recursion engine on the card, by wrapper."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    recs = {k: [] for k in _LEVEL_WRAPPERS}
    orig = {k: getattr(cl, k) for k in _LEVEL_WRAPPERS}

    def recorder(name):
        def call(*args):
            recs[name].append([_clone(a) for a in args])
            return orig[name](*args)
        return call

    for k in _LEVEL_WRAPPERS:
        setattr(cl, k, recorder(k))
    try:
        _run_mega(cov, dev, graph=False, **kw)
    finally:
        for k in _LEVEL_WRAPPERS:
            setattr(cl, k, orig[k])
    return recs


def _assert_bits(got: dict, want: dict, what: str):
    for k, v in want.items():
        assert _bits_equal(got[k], v), f"{what}: {k}"


@pytest.mark.parametrize("which", ["panel", "bench"])
def test_level_kernels_match_plain(dev, which):
    """K13-K16 on every level of an eager engine run on the card (the
    card tests' panel, bench.py's CBS workload), each on its recorded
    inputs, bit for bit equal to its plain versions on the same inputs
    (K14 carried by K11's launch, K15's keep flags and K16 one launch)."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    cov = _cbs_panel() if which == "panel" else _bench_cbs()
    recs = _level_records(cov, dev, n_perm=1000)
    assert all(len(v) >= 2 for v in recs.values()), \
        {k: len(v) for k, v in recs.items()}
    for contigs, tab, pending0, lv, al0 in recs["prologue"]:
        W = lv["x"].shape[0]
        cl.prologue(contigs, tab, pending0, lv, al0)
        _assert_bits(lv, cl.prologue_plain(contigs, tab, pending0, W, al0),
                     "K13")
    for tab, S, lv, alpha, kmax, n_grid, n_perm, n_min in \
            recs["tail_decide"]:
        cl.tail_decide(tab, S, lv, alpha, kmax, n_grid, n_perm, n_min)
        _assert_bits(lv, cl.tail_decide_plain(lv, alpha, kmax, n_grid,
                                              n_perm, n_min), "K11 with K14")
    for tab, S, lv, walked, alpha, n_perm in recs["edge_setup"]:
        cl.edge_setup(tab, S, lv, walked, alpha, n_perm)
        _assert_bits(lv, cl.edge_setup_plain(
            lv["x"], lv["n"], lv["ti"], lv["tj"], lv["trivial"], walked,
            alpha, n_perm, lv["x"].shape[1]), "K15")
    for args in recs["keep_table"]:
        tab, pending0, lv = args[:3]
        if int(tab[3 * pending0.shape[0] + cl.LIVE]):
            want_lv, want_tab, want_pending = cl.keep_table_plain(*args)
        else:       # a level after the run's end: nothing changes
            want_lv, want_tab, want_pending = (
                {k: lv[k].clone() for k in ("keep1", "keep2", "echunks")},
                tab.clone(), pending0.clone())
        cl.keep_table(*args)
        _assert_bits(lv, want_lv, "K15 keep")
        assert torch.equal(tab, want_tab)
        assert torch.equal(pending0, want_pending)
    torch.cuda.synchronize()


def _wide_level(C=192, seed=9):
    """C contigs of 1,200-2,000 bins with a step each, from the seed: a
    table of 1,024 slots and 512 rows a level, the engine's widest W, at
    Tmax 2,048."""
    rng = np.random.default_rng(seed)
    cov = {}
    for c in range(C):
        n = int(rng.integers(1200, 2001))
        r = rng.normal(0, 1, n)
        r[n // 3:n // 2] += rng.choice([0.0, 0.6, 2.5])
        cov[f"chr{c}"] = r
    return cov


@pytest.mark.parametrize("which", ["panel", "bench", "widest"])
def test_fused_level_kernels_match_chains(dev, which):
    """K11 carrying K14 and keep_table (K15's keep flags with K16), each
    one launch, on every level of an eager engine run on the card (the
    card tests' panel, W 32; bench.py's CBS workload, W 64; 192 contigs,
    W 512), bit for bit equal to the chains of plain versions they
    replaced on the same inputs; dead levels after the run's end left
    untouched; one launch each a level."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    cov = {"panel": _cbs_panel, "bench": _bench_cbs,
           "widest": _wide_level}[which]()
    recs = _level_records(cov, dev, n_perm=1000)
    W = recs["tail_decide"][0][2]["t2"].shape[0]
    assert W == {"panel": 32, "bench": 64, "widest": 512}[which]
    live_levels = 0
    for tab, S, lv, alpha, kmax, n_grid, n_perm, n_min in \
            recs["tail_decide"]:
        before = {k: v.clone() for k, v in lv.items()}
        want = cl.tail_decide_plain(lv, alpha, kmax, n_grid, n_perm, n_min)
        n0 = st.LAUNCHES["tail_decide"]
        cl.tail_decide(tab, S, lv, alpha, kmax, n_grid, n_perm, n_min)
        assert st.LAUNCHES["tail_decide"] == n0 + 1
        if int(tab[3 * S + cl.LIVE]):
            live_levels += 1
            _assert_bits(lv, want, "K11 with K14")
        else:
            _assert_bits(lv, before, "K11 with K14, dead")
    assert live_levels >= 2
    for args in recs["keep_table"]:
        tab, pending0, lv = args[:3]
        S = pending0.shape[0]
        live = int(tab[3 * S + cl.LIVE])
        want = cl.keep_table_plain(*args) if live else (
            {k: lv[k].clone() for k in ("keep1", "keep2", "echunks")},
            tab.clone(), pending0.clone())
        n0 = cl.LAUNCHES["keep_table"]
        cl.keep_table(*args)
        assert cl.LAUNCHES["keep_table"] == n0 + 1
        _assert_bits(lv, want[0], "K15 keep")
        assert torch.equal(tab, want[1]) and torch.equal(pending0, want[2])
    torch.cuda.synchronize()


def test_fused_level_kernels_leave_a_dead_level(dev):
    """With live 0 in the table's control words, K11 carrying K14 and
    keep_table write nothing: every level tensor, the table and the
    pending flags keep their values (sentinels here)."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    recs = _level_records(_cbs_panel(), dev, n_perm=1000)
    tab, S, lv, alpha, kmax, n_grid, n_perm, n_min = recs["tail_decide"][0]
    args = list(recs["keep_table"][0])
    tab = tab.clone()
    tab[3 * S + cl.LIVE] = 0
    for v in lv.values():
        if v.dtype == torch.bool:
            v.fill_(True)
        else:
            v.fill_(-7)
    before = {k: v.clone() for k, v in lv.items()}
    cl.tail_decide(tab, S, lv, alpha, kmax, n_grid, n_perm, n_min)
    args[0], args[2] = tab, lv
    pending0 = args[1].clone()
    cl.keep_table(*args)
    torch.cuda.synchronize()
    _assert_bits(lv, before, "dead level")
    assert int(tab[3 * S + cl.LIVE]) == 0
    assert torch.equal(args[1], pending0)


def _largest_shape(C=192, T=1 << 16, seed=3):
    """The whole-recursion engine's largest shape: C contigs of T bins of
    N(0, 1) from default_rng(seed), a table of 1,024 slots, 512 rows a
    level, tiers 1,024 to 65,536 (chip_smoke.py's largest_coverage)."""
    rng = np.random.default_rng(seed)
    return {f"chr{c}": rng.normal(0.0, 1.0, size=T) for c in range(C)}


@pytest.mark.parametrize("which", ["panel", "largest"])
def test_keep_table_tallies_arc_pairs(dev, which):
    """K16's arc-pair word, the tally's last, on every live level of an
    eager engine run on the card (the card tests' panel; the engine's
    largest shape), each on its recorded inputs: it adds n (n + 1) / 2 of
    the level's pending analysable rows, as table_update_plain does, and
    every other control word is the plain version's."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    cov = _cbs_panel() if which == "panel" else _largest_shape()
    recs = _level_records(cov, dev, n_perm=1000)
    live = 0
    for args in recs["keep_table"]:
        tab, pending0, lv = args[:3]
        S = pending0.shape[0]
        if not int(tab[3 * S + cl.LIVE]):
            continue
        live += 1
        want = cl.keep_table_plain(*args)[1][3 * S:]
        before = int(tab[-1])
        cl.keep_table(*args)
        assert cl.TALLY_WORDS[-1] == "arc_pairs"
        assert torch.equal(tab[3 * S:], want)
        assert int(tab[-1]) - before == int(cl.arc_pairs(lv)) > 0
    assert live >= 2 if which == "panel" else live >= 1
    torch.cuda.synchronize()


def test_tail_variants_cooperative_grids(dev):
    """Each K11 variant's cooperative grid comes from its own occupancy:
    both at least a block an SM and a multiple of the SMs, and the
    captured level keeps 3 cooperative kernel nodes (K7, K8 and K11
    carrying K14) with K14's two and K15's keep's launches gone."""
    from canvas_tpu_torch.ops import cbs_mega
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    state = st._device_state(dev, 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k in ("grid", "grid_decide"):
        assert state[k] >= sms and state[k] % sms == 0, (k, state[k])
    cbs_mega._ENGINES.clear()
    cbs_mega.run_cbs_mega(_cbs_panel(), n_perm=1000, device=dev)
    eng = next(reversed(cbs_mega._ENGINES.values()))
    assert eng.nodes["cooperative"] == 3
    per_level = eng.launches_a_level()
    assert per_level["tail_decide"] == 1 and "tail_p" not in per_level
    assert per_level["keep_table"] == 1 and per_level["edge_setup"] == 1
    assert eng.nodes["kernels"] == sum(per_level.values()) + len(eng.tiers)


def test_tier_masked_tmax_equals_copied_tier(dev):
    """K9, B4 and K10 under a tier's row mask, reading the [W, Tmax]
    cumsum at its row stride and writing t2, ti, tj in place: the rows in
    the tier equal the call on the tier's zeroed copy (the engine's
    earlier form), the other rows are untouched; on every level of the
    card tests' panel and at every tier."""
    from canvas_tpu_torch.ops import cbs_device
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    recs = _level_records(_cbs_panel(), dev, n_perm=1000)
    live = torch.ones((), dtype=torch.int64, device=dev)
    tiers_hit = set()
    for contigs, tab, pending0, lv, al0 in recs["prologue"]:
        cl.prologue(contigs, tab, pending0, lv, al0)
        Tmax = lv["x"].shape[1]
        for t, w in enumerate(cl.tier_widths(Tmax)):
            in_tier = lv["in_tier"][t]
            want = cbs_device.tmax_batch(
                torch.where(in_tier[:, None], lv["cs"][:, :w], 0.0),
                torch.where(in_tier, lv["n_eff"], 2),
                torch.where(in_tier, lv["tss"], 0.0), w, al0)
            init = [torch.full_like(lv["t2"], -7.0),
                    torch.full_like(lv["ti"], -7),
                    torch.full_like(lv["tj"], -7)]
            out = [v.clone() for v in init]
            cbs_device.tmax_batch(lv["cs"][:, :w], lv["n_eff"], lv["tss"], w,
                                  al0, mask=in_tier, out=out, live=live)
            for got, ref, before in zip(out, want, init):
                assert _bits_equal(got[in_tier], ref[in_tier])
                assert _bits_equal(got[~in_tier], before[~in_tier])
            if bool(in_tier.any()):
                tiers_hit.add(w)
    assert len(tiers_hit) >= 2


@pytest.mark.parametrize("which", ["panel", "bench"])
def test_graph_replay_equals_eager(dev, which):
    """The engine's captured level replayed in batches gives the same
    segments, counts and final table (the device buffer, control words
    included) as the same levels run eagerly; at most 2 reads a run, and
    the level count from the device's tally."""
    from canvas_tpu_torch.ops import cbs_mega

    cov = _cbs_panel() if which == "panel" else _bench_cbs()
    runs = {}
    cbs_mega.run_cbs_mega(cov, n_perm=1000, device=dev)    # the capture
    c0 = cbs_mega.GRAPHS["captures"]
    for graph in (True, False, True):
        counts: dict = {}
        s0 = cbs_mega.SYNCS["cbs_mega"]
        r0 = cbs_mega.GRAPHS["replays"]
        lens = _run_mega(cov, dev, graph=graph, n_perm=1000, counts=counts)
        eng = next(reversed(cbs_mega._ENGINES.values()))
        runs.setdefault(graph, []).append(
            (lens, counts, eng.tab.clone(), eng.pending0.clone(),
             cbs_mega.SYNCS["cbs_mega"] - s0,
             cbs_mega.GRAPHS["replays"] - r0))
    assert cbs_mega.GRAPHS["captures"] == c0      # one capture a shape
    (g_lens, g_counts, g_tab, g_pend, g_reads, g_replays) = runs[True][1]
    (e_lens, e_counts, e_tab, e_pend, e_reads, e_replays) = runs[False][0]
    for k in cov:
        np.testing.assert_array_equal(g_lens[k], e_lens[k])
    assert g_counts == e_counts
    assert torch.equal(g_tab, e_tab) and torch.equal(g_pend, e_pend)
    assert g_reads == e_reads <= 2 and e_replays == 0
    assert g_replays >= g_counts["levels"] >= 2
    assert runs[True][0][1] == g_counts


def test_level_after_the_end_changes_nothing(dev):
    """After a run, live is 0: replays of the captured level and an eager
    level leave the table, its control words and the pending flags as
    they are."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl
    from canvas_tpu_torch.ops import cbs_mega

    cbs_mega.run_cbs_mega(_cbs_panel(), n_perm=1000, device=dev)
    eng = next(reversed(cbs_mega._ENGINES.values()))
    tab, pend = eng.tab.clone(), eng.pending0.clone()
    assert int(tab[3 * eng.S + cl.LIVE]) == 0
    for _ in range(3):
        eng.replay()
    eng.level()
    torch.cuda.synchronize()
    assert torch.equal(eng.tab, tab) and torch.equal(eng.pending0, pend)
