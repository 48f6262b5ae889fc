"""Kernel B4 (the CBS arc scan) on the CPU: its plain torch version against
canvas_tpu's Pallas kernel in interpret mode, bit for bit, and the port's
tmax_batch against canvas_tpu's _tmax_batch_pallas, its _tmax_one and the
host oracle cbs.tmax_o."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from canvas_tpu.ops import cbs as jax_cbs
from canvas_tpu.ops import cbs_device as jdev
from canvas_tpu_torch.ops import arc_scan_cuda
from canvas_tpu_torch.ops import cbs_device as tdev

torch.set_num_threads(1)

AL0 = 2


def _rows(seed: int, npad: int, B: int, planted: bool):
    """B centred f32 rows of lengths in (npad/2, npad], every other one
    with a planted step when `planted`; their cumsums zero-padded to npad
    (accumulated in float64, as the port's engine does), lengths and
    float64 sums of squares."""
    rng = np.random.default_rng(seed)
    rows = []
    cs = np.zeros((B, npad), np.float32)
    n = np.zeros(B, np.int32)
    tss = np.zeros(B, np.float32)
    for i in range(B):
        L = int(rng.integers(npad // 2 + 1, npad + 1))
        r = rng.normal(0, 1, L).astype(np.float32)
        if planted and i % 2 == 0:
            s = int(rng.integers(0, L // 2))
            r[s:s + L // 4] += 2.5
        r = r - r.mean()
        rows.append(r)
        cs[i, :L] = np.cumsum(r.astype(np.float64)).astype(np.float32)
        n[i] = L
        tss[i] = float(np.sum(r.astype(np.float64) ** 2))
    return rows, cs, n, tss


def _pallas_inputs(cs, n, npad):
    """seed, lag_hi, psdiff and psd2 exactly as _tmax_batch_pallas builds
    them for the Pallas kernel."""
    csj, nj = jnp.asarray(cs), jnp.asarray(n)
    valid = jnp.arange(npad)[None, :] < nj[:, None]
    big = jnp.finfo(jnp.float32).max
    imin = jnp.argmin(jnp.where(valid, csj, big), axis=1)
    imax = jnp.argmax(jnp.where(valid, csj, -big), axis=1)
    psdiff = (jnp.take_along_axis(csj, imax[:, None], 1)[:, 0]
              - jnp.take_along_axis(csj, imin[:, None], 1)[:, 0])
    nf = nj.astype(jnp.float32)
    rjs = jnp.maximum(jnp.abs(imax - imin), 1).astype(jnp.float32)
    seed = jnp.where(psdiff > 0, nf / (rjs * (nf - rjs)) * psdiff * psdiff,
                     0.0).astype(jnp.float32)
    lag_hi = jnp.minimum(nj - AL0, nj - 1).astype(jnp.int32)
    psd2 = jdev._block_d2_bound(csj, psdiff, npad, min(512, npad))
    return seed, lag_hi, psdiff, psd2


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


CASES = [(256, True), (256, False), (512, True), (512, False)]
# four 512-lag blocks per row: later blocks pruned against the running
# best, the walk B4 replays in its second phase
MULTI_BLOCK = [(2048, True), (2048, False)]


def _pruned_by_running_best(cs, n, lag_hi, seed, psd2) -> int:
    """Blocks that the seed admits but the running best before them rejects
    (the running best before block k is the scan with blocks k.. zeroed)."""
    blk, _sub, nblk, _nsub = arc_scan_cuda.geometry(cs.shape[1])
    count = 0
    for k in range(1, nblk):
        cut = psd2.clone()
        cut[:, k:] = 0.0
        before, _ = arc_scan_cuda.arc_scan(cs, n, lag_hi, seed, cut, AL0)
        in_range, gate = arc_scan_cuda._block_gate(k, blk, n, lag_hi, psd2,
                                                   AL0)
        count += int((in_range & (gate > seed) & (gate <= before)).sum())
    return count


@pytest.mark.parametrize("npad,planted", CASES + MULTI_BLOCK)
def test_plain_arc_scan_equals_pallas_interpret(npad, planted):
    _rows_, cs, n, _tss = _rows(npad + planted, npad, 4, planted)
    seed, lag_hi, psdiff, psd2 = _pallas_inputs(cs, n, npad)
    csj = jnp.asarray(cs)
    best_j, bl0_j = jdev._arc_scan_pallas(
        jnp.pad(csj, ((0, 0), (0, npad))), csj, jnp.asarray(n), lag_hi,
        seed, psd2, npad, AL0, min(512, npad), True)
    psd2_t = tdev._block_d2_bound(torch.as_tensor(cs),
                                  torch.as_tensor(np.array(psdiff)), npad,
                                  min(512, npad))
    np.testing.assert_array_equal(_bits(psd2_t.numpy()), _bits(psd2))
    args = (torch.as_tensor(cs), torch.as_tensor(n),
            torch.as_tensor(np.array(lag_hi)), torch.as_tensor(np.array(seed)))
    best_t, bl0_t = arc_scan_cuda.arc_scan(*args, psd2_t, AL0)
    np.testing.assert_array_equal(_bits(best_t.numpy()), _bits(best_j))
    np.testing.assert_array_equal(bl0_t.numpy(), np.asarray(bl0_j))
    if planted:
        assert (bl0_t.numpy() >= 0).any()
    if (npad, planted) in MULTI_BLOCK:
        assert _pruned_by_running_best(*args, psd2_t) > 0


@pytest.mark.parametrize("npad,planted", CASES)
def test_tmax_batch_equals_pallas_interpret(npad, planted):
    _rows_, cs, n, tss = _rows(npad + planted, npad, 4, planted)
    t2j, tij, tjj = jdev._tmax_batch_pallas(
        jnp.asarray(cs), jnp.asarray(n), jnp.asarray(tss), npad, AL0,
        interpret=True)
    t2, ti, tj = tdev.tmax_batch(torch.as_tensor(cs), torch.as_tensor(n),
                                 torch.as_tensor(tss), npad, AL0)
    np.testing.assert_allclose(t2.numpy(), np.asarray(t2j), rtol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(tij))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(tjj))


@pytest.mark.parametrize("npad", [8, 64, 128, 256, 1024])
def test_tmax_batch_matches_host_oracle(npad):
    """Every bucket size, including those under 256 where canvas_tpu runs
    _tmax_one instead of the Pallas kernel: the statistic and split of
    cbs.tmax_o (as tests/test_cbs_device.py:38-55 holds the JAX engine)."""
    rows, cs, n, tss = _rows(npad, npad, 4, planted=True)
    t2, ti, tj = tdev.tmax_batch(torch.as_tensor(cs), torch.as_tensor(n),
                                 torch.as_tensor(tss), npad, AL0)
    for i, r in enumerate(rows):
        x = r.astype(np.float64)
        want_t2, want_ti, want_tj = jax_cbs.tmax_o(x, float(tss[i]), AL0)
        assert float(t2[i]) == pytest.approx(want_t2, rel=2e-4)
        assert (int(ti[i]), int(tj[i])) == (want_ti, want_tj)


@pytest.mark.parametrize("npad", [64, 128])
def test_tmax_batch_matches_tmax_one(npad):
    """Buckets under 256: the same statistic as canvas_tpu's _tmax_one."""
    _rows_, cs, n, tss = _rows(npad + 1, npad, 3, planted=True)
    t2, ti, tj = tdev.tmax_batch(torch.as_tensor(cs), torch.as_tensor(n),
                                 torch.as_tensor(tss), npad, AL0)
    for i in range(len(n)):
        t2w, tiw, tjw = jdev._tmax_one(
            jnp.asarray(cs[i]), jnp.asarray(n[i]), jnp.asarray(tss[i]),
            npad, AL0, jdev._tb_for(npad))
        assert float(t2[i]) == pytest.approx(float(t2w), rel=1e-6)
        assert (int(ti[i]), int(tj[i])) == (int(tiw), int(tjw))


def test_arc_scan_rejects_bad_shapes():
    cs = torch.zeros((2, 96))
    n = torch.full((2,), 90, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        arc_scan_cuda.arc_scan(cs, n, n, torch.zeros(2), torch.zeros(2, 1),
                               AL0)
    with pytest.raises(ValueError, match="psd2"):
        arc_scan_cuda.arc_scan(torch.zeros((2, 64)), n, n, torch.zeros(2),
                               torch.zeros(2, 3), AL0)


def test_geometry():
    assert arc_scan_cuda.geometry(65536) == (512, 32, 128, 16)
    assert arc_scan_cuda.geometry(256) == (256, 32, 1, 8)
    assert arc_scan_cuda.geometry(8) == (8, 8, 1, 1)


@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    _rows_, cs, n, tss = _rows(7, 4096, 16, planted=True)
    csd = torch.as_tensor(cs, device=dev)
    nd = torch.as_tensor(n, device=dev)
    t_cpu = tdev.tmax_batch(torch.as_tensor(cs), torch.as_tensor(n),
                            torch.as_tensor(tss), 4096, AL0)
    t_gpu = tdev.tmax_batch(csd, nd, torch.as_tensor(tss, device=dev), 4096,
                            AL0)
    for a, b in zip(t_cpu, t_gpu):
        assert torch.equal(a, b.cpu())
