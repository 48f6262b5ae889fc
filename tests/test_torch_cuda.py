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


@pytest.mark.parametrize("L,offset,cap", [
    (3 * prefix_cuda.TILE + 1234, 77, 10),
    (prefix_cuda.TILE, 0, 1),
    (40 * prefix_cuda.TILE - 5, 4097, 10),
])
def test_prefix_kernel_matches_plain(dev, L, offset, cap):
    rng = np.random.default_rng(L)
    Lp = L + (-L) % prefix_cuda.TILE
    p = torch.as_tensor(rng.integers(0, 256, Lp // 8, dtype=np.uint8)).to(dev)
    g = torch.as_tensor(rng.integers(0, 256, Lp // 8, dtype=np.uint8)).to(dev)
    o = torch.as_tensor(rng.integers(0, 16, Lp, dtype=np.uint8)).to(dev)
    before = prefix_cuda.LAUNCHES["prefix_scan"]
    got = prefix_cuda.fused_prefix_sums(p, o, g, offset, L, cap)
    torch.cuda.synchronize()
    assert prefix_cuda.LAUNCHES["prefix_scan"] == before + 1
    want = prefix_cuda.fused_prefix_sums_plain(p, o, g, offset, L, cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_prefix_kernel_rejects_unpadded_length(dev):
    o = torch.zeros(prefix_cuda.TILE + 8, dtype=torch.uint8, device=dev)
    p = torch.zeros(o.shape[0] // 8, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        prefix_cuda.fused_prefix_sums(p, o, p, 0, 10, 10)


def _decode_problem(seed, B, T, lengths):
    rng = np.random.default_rng(seed)
    log_em = np.round(rng.normal(size=(B, T, 5)) * 2).astype(np.float32)
    lt = np.log(rng.dirichlet(np.ones(5), size=5)).astype(np.float32)
    li = np.log(np.full(5, 0.2, np.float32))
    mask = np.zeros((B, T), dtype=bool)
    for b, n in enumerate(lengths):
        mask[b, :n] = True
    log_em = np.where(mask[..., None], log_em, 0).astype(np.float32)
    return log_em, lt, li, mask


@pytest.mark.parametrize("chunk", [64, 256])
def test_viterbi_kernels_match_plain(dev, chunk):
    log_em, lt, li, mask = _decode_problem(
        chunk, 6, 3000, [3000, 2999, 1500, 257, 1, 0])
    em_t = torch.as_tensor(log_em, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    before = dict(viterbi_cuda.LAUNCHES)
    got = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=chunk)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES["chunk_matrix"] == before["chunk_matrix"] + 1
    assert viterbi_cuda.LAUNCHES["forward_backtrack"] == \
        before["forward_backtrack"] + 1
    want = hmm.viterbi_decode_chunked(em_t, mask_t, lt, li, chunk=chunk,
                                      plain=True)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        hmm.viterbi_decode_np_chunked(log_em, lt, li, mask, chunk=chunk))


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
