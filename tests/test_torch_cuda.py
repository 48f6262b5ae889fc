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
    before = dict(viterbi_cuda.LAUNCHES)
    chains = dict(viterbi_cuda.CHAINS)
    got = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=chunk)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES["chunk_matrix"] == before["chunk_matrix"] + 1
    chain = "uniform" if model == "uniform" else "general"
    assert viterbi_cuda.CHAINS[chain] == chains[chain] + 1
    assert viterbi_cuda.LAUNCHES["forward_backtrack"] == \
        before["forward_backtrack"] + 1
    want = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=chunk,
                                      plain=True)
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


def test_segment_coverage_batched_on_card_equals_cpu(dev):
    rng = np.random.default_rng(4)
    cov = {}
    for i in range(5):
        c = rng.poisson(100.0, int(rng.integers(500, 5000))).astype(float)
        c[100:300] = rng.poisson(50.0, 200)
        cov[f"chr{i + 1}"] = c
    assert hmm.segment_coverage_batched(cov, device=dev) == \
        hmm.segment_coverage_batched(cov, device="cpu")


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


def test_frontier_engine_on_card_equals_cpu(dev):
    from canvas_tpu_torch.ops import cbs, cbs_device

    rng = np.random.default_rng(5)
    cov = {}
    for c in range(3):
        r = rng.normal(0, 1, 3000)
        r[500:900] += 2.0
        r[2000:2100] -= 3.0
        cov[f"chr{c}"] = r
    got = cbs.run_cbs(cov, n_perm=1000, device=dev)
    assert cbs.last_engine() == "frontier"
    want = cbs_device.run_cbs_device(cov, n_perm=1000, device="cpu")
    for k in cov:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("lengths,scale", [
    ((1, 999, 5_003, 200_017), 1.0),
    ((70_001, 3_333), 0.01),          # tiny weights: most values capped
    ((123_457,), 50.0),               # large weights: small fractions
])
def test_gc_weighted_bin_sample_on_card_equals_cpu(dev, lengths, scale):
    """GCContentWeighted binning on ragged contigs: starts, ends, GC and the
    rounded float64 row sums equal on the card and on the CPU."""
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
