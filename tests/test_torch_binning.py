"""CanvasBin in canvas_tpu_torch against canvas_tpu: kernel B1's plain
version against the Pallas prefix kernel (interpret mode) and numpy, and
bin_sample BinSets on the fused and the host paths."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from canvas_tpu.ops import binning as jax_binning
from canvas_tpu.ops.prefix_pallas import LANES, ROWS, fused_prefix_sums
from canvas_tpu_torch.ops import binning, prefix_cuda

torch.set_num_threads(1)

BLOCK = ROWS * LANES      # the Pallas kernel's positions per grid step


def _packed(p, obs, gc, pad_to=8):
    """Tracks in the port's layout, zero-padded to a multiple of pad_to."""
    L = len(obs)
    pad = (-L) % pad_to
    return (torch.as_tensor(prefix_cuda.pack_bits(np.pad(p, (0, pad)))),
            torch.as_tensor(np.pad(np.asarray(obs, np.uint8), (0, pad))),
            torch.as_tensor(prefix_cuda.pack_bits(np.pad(gc, (0, pad)))))


def _tracks(rng, L, p_rate=0.4, lam=1.2):
    p = rng.random(L) < p_rate
    obs = rng.poisson(lam, L).astype(np.uint8)
    gc = rng.random(L) < 0.45
    return p, obs, gc


@pytest.mark.parametrize("L,cap", [
    (int(BLOCK * 2.5), 10),     # the Pallas carry crosses two blocks
    (BLOCK - 3, 1),             # Binary cap, ragged tail
    (1000, 10),                 # far below one block: padding
])
def test_prefix_plain_matches_pallas(L, cap):
    rng = np.random.default_rng(L)
    p, obs, gc = _tracks(rng, L)
    want = fused_prefix_sums(
        jnp.asarray(p.astype(np.uint8)), jnp.asarray(obs),
        jnp.asarray(gc.astype(np.uint8)), cap=cap, interpret=True)
    got = prefix_cuda.fused_prefix_sums(*_packed(p, obs, gc), 0, L, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[:L], np.asarray(w)[:L])


def test_prefix_plain_live_range_and_constant_tail():
    L, offset, real_len = 5000, 173, 4321
    rng = np.random.default_rng(3)
    p, obs, gc = _tracks(rng, L)
    pcum, ocum, gccum = prefix_cuda.fused_prefix_sums(
        *_packed(p, obs, gc), offset, real_len, 10)
    live = p & (np.arange(L) >= offset) & (np.arange(L) < real_len)
    np.testing.assert_array_equal(pcum.numpy()[:L], np.cumsum(live))
    np.testing.assert_array_equal(
        ocum.numpy()[:L], np.cumsum(np.minimum(obs, 10) * live))
    np.testing.assert_array_equal(gccum.numpy()[:L], np.cumsum(gc))
    # constant past real_len: searchsorted-safe
    assert np.all(pcum.numpy()[real_len:] == pcum.numpy()[real_len - 1])


def test_prefix_plain_wraps_modulo_2_32_and_bins_stay_exact():
    """ocum passes 2^31 (the chr1-at-cap-10 case, reached here with cap
    255): the prefixes wrap as int32 and the per-bin differences stay
    exact."""
    L = 8_500_000
    p = np.ones(L, dtype=bool)
    obs = np.full(L, 255, np.uint8)
    gc = np.zeros(L, dtype=bool)
    pb, ob, gb = _packed(p, obs, gc)
    _, ocum, _ = prefix_cuda.fused_prefix_sums(pb, ob, gb, 0, L, 255)
    want = (np.arange(1, L + 1, dtype=np.uint64) * 255 % 2 ** 32) \
        .astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(ocum.numpy(), want)
    assert int(ocum[-1]) < 0                         # it did wrap
    bin_size = 500_000
    packed = binning.bin_contig_device_fused(
        pb, ob, gb, 0, L, bin_size, L // bin_size, cap=255).numpy()
    assert packed[4].all()
    np.testing.assert_array_equal(packed[3], np.full(L // bin_size,
                                                     255 * bin_size))


def _sample_tracks(seed):
    rng = np.random.default_rng(seed)
    tracks = {}
    for i, (L, off) in enumerate([(BLOCK + 4321, 173), (20_000, 0),
                                  (7_777, 50)]):
        p = rng.random(L) < 0.35 + 0.1 * i
        obs = rng.poisson(0.6 + i, L).astype(np.uint8)
        obs[~p] = 0
        gc = rng.random(L) < 0.42
        p[:off] = False
        tracks[f"c{i}"] = dict(possible=p, observed=obs, is_gc=gc,
                               offset=off)
    return tracks


@pytest.mark.parametrize("mode", ["TruncatedDynamicRange", "Binary"])
@pytest.mark.parametrize("force_fused", [True, None])
def test_bin_sample_matches_canvas_tpu(mode, force_fused):
    tracks = _sample_tracks(11)
    want = jax_binning.bin_sample(tracks, 97, mode=mode,
                                  force_fused=force_fused)
    got = binning.bin_sample(tracks, 97, mode=mode, force_fused=force_fused,
                             device="cpu")
    assert list(got) == list(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_bin_sample_gc_weighted_not_ported():
    """GCContentWeighted binning is ported now: the sample's bins, GC and
    counts equal canvas_tpu's (its non-fused pass on the CPU)."""
    tracks = _sample_tracks(1)
    rng = np.random.default_rng(1)
    for t in tracks.values():
        t["gc_weights"] = rng.uniform(0.5, 2.0, len(t["possible"])).astype(
            np.float32)
    got = binning.bin_sample(tracks, 97, mode="GCContentWeighted",
                             device="cpu")
    want = jax_binning.bin_sample(tracks, 97, mode="GCContentWeighted")
    assert set(got) == set(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)

