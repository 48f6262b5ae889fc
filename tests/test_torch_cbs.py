"""CBS on the CPU: the port's host path against canvas_tpu's exactly, its
threefry draws against jax.random bit for bit, and its frontier engine on
CPU tensors (kernel B4's plain version) against canvas_tpu's frontier
engine."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from canvas_tpu.ops import cbs as jax_cbs
from canvas_tpu.ops import cbs_device as jdev
from canvas_tpu_torch.ops import cbs, threefry
from canvas_tpu_torch.ops import cbs_device as tdev

torch.set_num_threads(1)


def _planted(seed: int, n_contigs: int = 3, n: int = 2000) -> dict:
    """tests/test_cbs_device.py:106-118: two strong steps per contig."""
    rng = np.random.default_rng(seed)
    cov = {}
    for c in range(n_contigs):
        r = rng.normal(0, 1, n)
        r[400:700] += 4.0
        r[1200:1300] -= 5.0
        cov[f"chr{c}"] = r
    return cov


def _noisy(seed: int) -> dict:
    """Unplanted noise with a weak step: decisions rest on the permutation
    walks and the tail probability, not on trivially large statistics."""
    rng = np.random.default_rng(seed)
    cov = {f"chr{c}": rng.normal(0, 1, 700 + 150 * c) for c in range(3)}
    cov["chr1"][200:320] += 0.6
    return cov


# --- host path ------------------------------------------------------------

@pytest.mark.parametrize("data", ["planted", "noisy"])
@pytest.mark.parametrize("undo", ["none", "sdundo", "prune"])
def test_host_path_equals_canvas_tpu(data, undo):
    cov = _planted(1, n=900) if data == "planted" else _noisy(2)
    want = jax_cbs._run_cbs_host(cov, 0.01, 500, undo, 3)
    got = cbs.run_cbs(cov, n_perm=500, undo_method=undo, seed=3,
                      device="cpu")
    assert cbs.last_engine() == "host"
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_host_pool_watchdog_falls_back_to_serial(monkeypatch):
    """A pool child that hangs mid-work trips the watchdog; the serial path
    gives the identical result."""
    cov = _noisy(4)
    want = cbs.run_cbs(cov, n_perm=200, seed=1, device="cpu")
    assert cbs._LAST_ENGINE["host_workers"] == min(3, cbs._host_cbs_workers(3))
    monkeypatch.setenv("CANVAS_TPU_TEST_CBS_CHILD_HANG_S", "30")
    monkeypatch.setenv("CANVAS_TPU_CBS_POOL_TIMEOUT_S", "1")
    got = cbs.run_cbs(cov, n_perm=200, seed=1, device="cpu")
    assert cbs._LAST_ENGINE["host_workers"] == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --- tail probabilities ---------------------------------------------------

def test_nu_matches_canvas_tpu():
    x = np.array([0.005, 0.011, 0.02, 0.05, 0.2, 0.7, 2.0, 5.0])
    want = np.asarray(jdev._nu_dev(jnp.asarray(x, jnp.float32)))
    got = tdev._nu_dev(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tail_p_matches_canvas_tpu():
    b = np.array([1.5, 2.5, 3.2, 4.0, 5.5], np.float32)
    n = np.array([250, 400, 1000, 3000, 20000], np.int32)
    want = np.asarray(jdev._tail_p_batch_dev(jnp.asarray(b), jnp.asarray(n),
                                             25, 100))
    got = tdev._tail_p_batch_dev(torch.as_tensor(b.astype(np.float64)),
                                 torch.as_tensor(n), 25, 100).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # and the host OU integral the reference computes
    for i in range(len(b)):
        host = jax_cbs.tail_p(float(b[i]), 26.0 / n[i], int(n[i]))
        assert got[i] == pytest.approx(host, rel=5e-3)


# --- permutations ---------------------------------------------------------

KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (3, 7), (0x9E3779B9, 0x243F6A88)]


@pytest.mark.parametrize("shape", [(1,), (5, 3), (64, 256), (768, 33)])
def test_threefry_uniform_equals_jax(shape):
    keys = np.array(KEYS, np.uint32)
    got = threefry.uniform(torch.as_tensor(keys.astype(np.int64)), shape)
    for i, k in enumerate(keys):
        want = np.asarray(jax.random.uniform(jnp.asarray(k), shape,
                                             dtype=jnp.float32))
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_seg_keys_equal_canvas_tpu():
    contig, lo = np.array([0, 3, 17]), np.array([0, 4096, 123])
    n, chunk = np.array([2000, 511, 9]), np.array([0, 1, 5])
    np.testing.assert_array_equal(tdev._seg_keys_np(42, contig, lo, n, chunk),
                                  jdev._seg_keys_np(42, contig, lo, n, chunk))


@pytest.mark.parametrize("n,npad,full", [(300, 512, False), (90, 128, True),
                                         (40, 64, True)])
def test_perm_stats_equal_canvas_tpu(n, npad, full):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, n).astype(np.float32)
    x -= x.mean()
    tss = float(np.sum(x.astype(np.float64) ** 2))
    key = jdev._seg_keys_np(5, 1, 0, n, 0)
    P = 64
    px_j, st_j = jdev._debug_perm_stats(x, n, tss, jnp.asarray(key), npad,
                                        P, 2, 25, full)
    px_t, st_t = tdev._debug_perm_stats(x, n, tss, key, npad, P, 2, 25, full)
    np.testing.assert_array_equal(px_t, np.asarray(px_j))
    np.testing.assert_allclose(st_t, np.asarray(st_j), rtol=2e-4)
    oracle = (jax_cbs.tmax_p_batch(px_t[:, :n].astype(np.float64), tss, 2)
              if full else
              jax_cbs.htmax_p_batch_np(px_t[:, :n].astype(np.float64), tss,
                                       2, 25))
    np.testing.assert_allclose(st_t, oracle, rtol=2e-4)


# --- the frontier engine on CPU tensors -----------------------------------

def _jax_frontier(monkeypatch, cov, **kw) -> dict:
    """canvas_tpu's run_cbs with its frontier engine forced on the CPU; it
    falls back to its host engine on any device error, so the engine that
    ran is checked."""
    monkeypatch.setenv("CANVAS_TPU_CBS_FRONTIER", "1")
    monkeypatch.setenv("CANVAS_TPU_CBS_MEGA", "0")
    out = jax_cbs.run_cbs(cov, **kw)
    assert jax_cbs.last_engine() == "frontier"
    return out


def test_frontier_planted_equals_canvas_tpu(monkeypatch):
    cov = _planted(7)
    want = _jax_frontier(monkeypatch, cov, n_perm=1000)
    levels = []
    got = tdev.run_cbs_device(cov, n_perm=1000, device="cpu", levels=levels)
    for k in cov:
        np.testing.assert_array_equal(got[k], want[k])
    assert [lv["level"] for lv in levels] == list(range(len(levels)))
    assert all(lv["buckets"] >= 1 and lv["seconds"] >= 0 for lv in levels)


def test_frontier_deterministic_and_equal(monkeypatch):
    """Weak steps: a split here rests on a permutation walk that counts
    permuted statistics at or above the observed one, so equal segments need
    the port's threefry draws to be canvas_tpu's.  Same length and n_perm as
    the planted case, so canvas_tpu reuses most of its compiled levels."""
    rng = np.random.default_rng(22)
    cov = {f"chr{c}": rng.normal(0, 1, 2000) for c in range(2)}
    cov["chr0"][300:600] += 0.3
    cov["chr1"][900:1000] -= 0.45
    walks = []
    init = tdev._PermWalk.__init__

    def _record(self, *a, **kw):
        init(self, *a, **kw)
        walks.append(self)

    monkeypatch.setattr(tdev._PermWalk, "__init__", _record)
    a = tdev.run_cbs_device(cov, n_perm=1000, device="cpu")
    assert any(w.nrejc >= 1 and w.nrej >= 1 for w in walks)
    assert {w.accepted for w in walks} == {True, False}
    b = tdev.run_cbs_device(cov, n_perm=1000, device="cpu")
    want = _jax_frontier(monkeypatch, cov, n_perm=1000)
    for k in cov:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], want[k])
    assert len(a["chr0"]) > 1


def test_frontier_undo_and_edges_equal_canvas_tpu(monkeypatch):
    r = np.random.default_rng(31).normal(0, 1, 1200)
    r[500:800] += 4.0
    cov = {"chr1": r, "empty": np.array([]), "tiny": np.array([1.0, 2.0])}
    want = _jax_frontier(monkeypatch, cov, n_perm=500, undo_method="sdundo")
    got = tdev.run_cbs_device(cov, n_perm=500, undo_method="sdundo",
                              device="cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert int(np.sum(got["chr1"])) == 1200 and len(got["chr1"]) >= 3
    assert list(got["tiny"]) == [2] and list(got["empty"]) == [0]
    assert tdev.run_cbs_device({"a": np.array([])}, device="cpu") == {}


def test_run_cbs_takes_the_host_path_on_cpu():
    cov = _planted(3, n_contigs=1, n=600)
    got = cbs.run_cbs(cov, n_perm=300, device=torch.device("cpu"))
    assert cbs.last_engine() == "host"
    want = jax_cbs._run_cbs_host(cov, 0.01, 300, "none", 0)
    np.testing.assert_array_equal(got["chr0"], want["chr0"])
