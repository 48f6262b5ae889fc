"""canvas_tpu_torch's device pipeline steps against canvas_tpu's on the CPU
(tests/test_device_pipeline.py's inputs): states, called copy numbers,
bin starts, ends, GC counts and valid flags exactly equal, bin counts
equal, rates within 1e-7 relative; the steps on a [cpu] * n mesh equal
to the unsplit steps; the multichip dryrun and the entry step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from canvas_tpu.ops import hmm as jax_hmm
from canvas_tpu.pipeline import device_pipeline as jax_dp
from canvas_tpu_torch import graft_entry
from canvas_tpu_torch.parallel.mesh import make_mesh
from canvas_tpu_torch.pipeline import device_pipeline as dp

CPU = torch.device("cpu")


def _t(*xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


def _caller_cases():
    """tests/test_device_pipeline.py's two caller inputs."""
    T = 120
    cov = np.full((2, T), 100.0, np.float32)
    cov[0, :40] = 50.0
    cov[1, 60:] = 200.0
    states = np.full((2, T), 2, np.int32)
    states[0, :40] = 1
    states[1, 60:] = 4
    yield states, cov, np.ones((2, T), bool)
    T = 64
    cov = np.full((1, T), 80.0, np.float32)
    cov[0, 32:] = 9999.0
    valid = np.zeros((1, T), bool)
    valid[0, :32] = True
    yield np.zeros((1, T), np.int32), cov, valid


@pytest.mark.parametrize("case", [0, 1])
def test_caller_step_equals_canvas_tpu(case):
    states, cov, valid = list(_caller_cases())[case]
    want = np.asarray(jax_dp.caller_step(jnp.asarray(states),
                                         jnp.asarray(cov),
                                         jnp.asarray(valid)))
    got = dp.caller_step(*_t(states, cov, valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_caller_step_noisy_runs_equal_canvas_tpu():
    """Non-integer coverage over many short runs: the segment means and
    the diploid mean in float32, the nearest model the same."""
    rng = np.random.default_rng(3)
    states = np.cumsum(rng.random((3, 500)) < 0.05, axis=1).astype(np.int32) % 5
    cov = rng.gamma(20.0, 5.0, (3, 500)).astype(np.float32)
    valid = rng.random((3, 500)) < 0.9
    want = np.asarray(jax_dp.caller_step(*map(jnp.asarray,
                                              (states, cov, valid))))
    got = dp.caller_step(*_t(states, cov, valid)).numpy()
    np.testing.assert_array_equal(got, want)


def _tracks(C=2, L=4096, seed=0):
    rng = np.random.default_rng(seed)
    possible = rng.random((C, L)) < 0.8
    observed = rng.poisson(0.5, size=(C, L)).astype(np.float32)
    observed[~possible] = 0.0
    is_gc = rng.random((C, L)) < 0.4
    return possible, observed, is_gc


def _log_model(S=5, V=64):
    means = np.maximum(np.arange(S)[:, None], 0.1) * 50.0
    tables = jax_hmm.negative_binomial_table(means, np.full((S, 1), 400.0), V)
    logt = np.where(tables > 0, np.log(np.maximum(tables, 1e-300)),
                    jax_hmm.NEG_INF).astype(np.float32)
    return (logt, np.asarray(jax_hmm.log_transition(S), np.float32),
            np.log(np.full(S, 1.0 / S, np.float32)))


def _assert_bins_equal(got, want):
    for name, g, w in zip(("start", "end", "gc", "count", "valid"), got,
                          want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_binning_step_equals_canvas_tpu(weighted):
    """Integer capped counts (full_pipeline_step's) and float32 weighted
    values with leading offsets: every output equal, the counts as
    float32 sums in position order."""
    possible, observed, is_gc = _tracks(C=3, L=5000, seed=4)
    if weighted:
        w = np.random.default_rng(5).uniform(0.5, 2.0, observed.shape)
        capped = np.where(possible, np.minimum(observed / w, 10.0),
                          0.0).astype(np.float32)
        offsets = np.array([0, 37, 1001], np.int32)
    else:
        capped = np.where(possible, np.minimum(observed, 10.0),
                          0.0).astype(np.float32)
        offsets = np.zeros(3, np.int32)
    for bin_size, max_bins in ((16, 256), (33, 64)):
        want = jax_dp.binning_step(*map(jnp.asarray, (possible, capped,
                                                      is_gc, offsets)),
                                   bin_size, max_bins)
        got = dp.binning_step(*_t(possible, capped, is_gc, offsets),
                              bin_size, max_bins)
        _assert_bins_equal(got, want)


def test_rate_step_equals_canvas_tpu():
    possible, observed, _ = _tracks(C=4)
    possible[3] = False
    want = np.asarray(jax_dp.rate_step(jnp.asarray(possible),
                                       jnp.asarray(observed)))
    got = dp.rate_step(*_t(possible, observed))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("use_all_states", [True, False])
def test_segmentation_step_equals_canvas_tpu(use_all_states):
    """The entry step's inputs (8 x 512 x 1, S = 5): equal paths."""
    args = jax_entry._demo_segmentation_inputs()
    want = np.asarray(jax_dp.segmentation_step(
        *args, use_all_states=use_all_states, n_dim=1))
    got = dp.segmentation_step(*_t(*args), use_all_states=use_all_states,
                               n_dim=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 2


def test_full_pipeline_step_equals_canvas_tpu():
    possible, observed, is_gc = _tracks()
    offsets = np.zeros(2, np.int32)
    logt, lt, li = _log_model()
    want = jax_dp.full_pipeline_step(
        *map(jnp.asarray, (possible, observed, is_gc, offsets)), 16, 256,
        *map(jnp.asarray, (logt, lt, li)))
    got = dp.full_pipeline_step(*_t(possible, observed, is_gc, offsets),
                                16, 256, *_t(logt, lt, li))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _assert_bins_equal(got[2], want[2])
    valid = got[2][4].numpy()
    vals, counts = np.unique(got[1].numpy()[valid], return_counts=True)
    assert vals[np.argmax(counts)] == 2


@pytest.mark.parametrize("n", [2, 4])
def test_steps_on_a_mesh_equal_unsplit(n):
    """Four lanes on a [cpu] * n mesh: the same outputs as one device."""
    possible, observed, is_gc = _tracks(C=4, seed=2)
    offsets = np.array([0, 5, 0, 100], np.int32)
    logt, lt, li = _log_model()
    args = (*_t(possible, observed, is_gc, offsets), 16, 256,
            *_t(logt, lt, li))
    m = make_mesh(n, devices=[CPU] * n)
    whole = dp.full_pipeline_step(*args)
    split = dp.full_pipeline_step(*args, mesh=m)
    for a, b in zip((*whole[:2], *whole[2]), (*split[:2], *split[2])):
        assert torch.equal(a, b)
    rates = dp.rate_step(*_t(possible, observed))
    assert torch.equal(dp.rate_step(*_t(possible, observed), mesh=m), rates)


def test_entry_step_equals_canvas_tpu():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(fn(*args).numpy(), np.asarray(jfn(*jargs)))


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    graft_entry.dryrun_multichip(4, devices=[CPU] * 4)
    out = capsys.readouterr().out
    assert "synthetic step OK" in out
    assert "split == single-device" in out


def test_dryrun_multichip_needs_enough_devices():
    with pytest.raises(ValueError, match="4 devices"):
        graft_entry.dryrun_multichip(4, devices=[CPU] * 3)
