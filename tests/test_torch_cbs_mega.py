"""The whole-recursion CBS engine on the CPU: the port's ops/cbs_mega.py on
CPU tensors (kernel B4's plain version) against canvas_tpu's
ops/cbs_mega.py, called directly.  Segment lengths must be equal contig by
contig, which needs the port's threefry streams, tier widths, walks and
edge tests to be canvas_tpu's.  canvas_tpu runs its non-Pallas arc scan
(_tmax_one) on the CPU; the inputs have no exact float ties, where the two
scans may pick different arcs (tests/test_torch_arc_scan.py).

Every canvas_tpu call here uses eight contigs, S = 64 slots and Tmax =
2,048 bins, so that XLA compiles one shape of its recursion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canvas_tpu.ops import cbs_mega as jmega
from canvas_tpu_torch.ops import cbs_mega as tmega
from canvas_tpu_torch.ops import threefry

torch.set_num_threads(1)

N_PERM = 500


def _planted(rng, n=1000, events=((200, 400, 4.0), (700, 800, -5.0))):
    """tests/test_cbs_mega.py:39-44."""
    r = rng.normal(0, 1, n)
    for s, e, d in events:
        r[s:e] += d
    return r


def _step(seed, n, start, width, d):
    r = np.random.default_rng(seed).normal(0, 1, n)
    r[start:start + width] += d
    return r


def _both(cov, **kw):
    """(canvas_tpu's lengths, the port's lengths, the port's counts)."""
    want = jmega.run_cbs_mega(cov, n_perm=N_PERM, **kw)
    counts = {}
    s0 = tmega.SYNCS["cbs_mega"]
    got = tmega.run_cbs_mega(cov, n_perm=N_PERM, device="cpu",
                             counts=counts, **kw)
    counts["syncs"] = tmega.SYNCS["cbs_mega"] - s0
    assert want is not None and got is not None
    assert list(got) == list(want)
    return want, got, counts


@pytest.fixture(scope="module")
def run_all():
    """One run of both engines over eight contigs, each a case of its own;
    the port's run records the tier widths its arc scans ran at."""
    rng = np.random.default_rng(13)
    cov = {
        "planted": _planted(rng),
        # weak steps: the top split rests on a permutation walk that
        # accepts, a child's on one that rejects
        "weak": _step(0, 1000, 350, 60, 0.6),
        # a weak interior event: edge tests that draw permutations
        "interior": _step(0, 1000, 350, 300, 0.3),
        # a strong interior event, a change at the start and at the end
        "mid": _planted(rng, n=1000, events=((450, 650, 4.5),)),
        "start": np.concatenate([rng.normal(5, 1, 250),
                                 rng.normal(0, 1, 750)]),
        "end": np.concatenate([rng.normal(0, 1, 760),
                               rng.normal(-5, 1, 240)]),
        # 1,800 bins: the top level at width 2,048, the children at 1,024
        "long": _planted(np.random.default_rng(29), n=1800,
                         events=((500, 900, 3.5), (1300, 1500, -4.0))),
        "empty": np.array([]),
        "tiny": np.array([1.0, 2.0]),
    }
    tiers = []
    tmax = tmega.tmax_batch

    def record(cs, n, tss, npad, al0):
        tiers.append(npad)
        return tmax(cs, n, tss, npad, al0)

    tmega.tmax_batch = record
    try:
        want, got, counts = _both(cov)
    finally:
        tmega.tmax_batch = tmax
    counts["tiers"] = tiers
    return want, got, counts


def _equal(run, names):
    want, got, _counts = run
    for k in names:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- fold_in, keys and the walk -------------------------------------------

KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (3, 7), (0x9E3779B9, 0x243F6A88)]


@pytest.mark.parametrize("data", [0, 1, 7777, 123456, 0xFFFFFFFF])
def test_fold_in_equals_jax(data):
    keys = np.array(KEYS, np.uint32)
    d = np.array([data, data // 3, 5, data ^ 0xABCD], np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                   jnp.asarray(d)))
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 42))(
        jnp.asarray(want)))
    got = threefry.fold_in(torch.as_tensor(keys.astype(np.int64)),
                           torch.as_tensor(d.astype(np.int64)))
    got = threefry.fold_in(got, 42)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_seg_keys_equal_canvas_tpu():
    c = np.array([0, 3, 17, 191], np.int32)
    lo = np.array([0, 4096, 123, 65000], np.int32)
    n = np.array([2000, 511, 9, 536], np.int32)
    want = np.asarray(jmega._seg_keys(jax.random.PRNGKey(11), jnp.asarray(c),
                                      jnp.asarray(lo), jnp.asarray(n)))
    got = tmega._seg_keys(torch.tensor([0, 11]), torch.as_tensor(c),
                          torch.as_tensor(lo), torch.as_tensor(n))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_walk_update_equals_canvas_tpu():
    """Seeded chunks through the boundary walk, with rows whose reject and
    accept fall on the same permutation (the reject wins), rows exhausted
    at n_perm and rows not walking."""
    rng = np.random.default_rng(5)
    R, P, n_perm = 12, 64, 150
    sbdry = np.sort(rng.integers(20, 140, 400)).astype(np.int32)
    ostat = rng.uniform(0.5, 1.5, R).astype(np.float32)
    pstats = rng.uniform(0.0, 1.6, (R, P)).astype(np.float32)
    pstats[3, :] = 0.0
    pstats[3, 9] = 2.0              # the first exceedance
    nrejc = rng.integers(0, 6, R).astype(np.int32)
    nrejc[3] = 0
    np0 = rng.integers(0, 3, R).astype(np.int32) * P
    np0[3] = 0
    np0[4] = 128                    # reaches n_perm in this chunk
    pstats[4, :] = 0.0
    nrej0 = np.zeros(R, np.int32)
    k0 = (nrejc * (nrejc + 1) // 2 + 1).astype(np.int32)
    # row 3's accept boundary at the same permutation as its reject
    sbdry[k0[3]] = np0[3] + 10
    walking = np.ones(R, bool)
    walking[7] = False
    want = jmega._walk_update(*map(jnp.asarray, (ostat, nrejc, np0, nrej0,
                                                  k0, walking, pstats, sbdry)),
                              n_perm)
    got = tmega._walk_update(*map(torch.as_tensor, (ostat, nrejc, np0, nrej0,
                                                     k0, walking, pstats,
                                                     sbdry)), n_perm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    acc, walk1 = got[0].numpy(), got[1].numpy()
    assert not acc[3] and not walk1[3]          # the tie rejected
    assert acc[4] and not walk1[4]              # n_perm reached: accepted
    assert acc.any() and (~acc & ~walk1 & walking).any()


def test_edge_tests_equal_canvas_tpu():
    """The split-location edge tests on their own: eight rows (one not
    tested) with short and long arms, weak and strong steps, 2,000
    permutations; the keep flags of both edges and the chunks drawn
    before each lane stopped."""
    rng = np.random.default_rng(4)
    W, T = 8, 1024
    n = np.array([1000, 900, 1024, 700, 500, 1000, 300, 0], np.int32)
    i1 = np.array([5, 300, 400, 8, 100, 497, 20, 0], np.int32)
    i2 = np.array([400, 310, 1018, 600, 400, 503, 280, 0], np.int32)
    step = [0.9, 0.8, 0.15, 0.3, 0.25, 2.0, 0.4, 0.0]
    x = np.zeros((W, T), np.float32)
    for r in range(W - 1):
        v = rng.normal(0, 1, n[r])
        v[i1[r]:i2[r]] += step[r]
        x[r, :n[r]] = v - v.mean()
    test_both = np.arange(W) < W - 1
    keys = np.asarray(jmega._seg_keys(jax.random.PRNGKey(3), jnp.arange(W),
                                      jnp.zeros(W, jnp.int32),
                                      jnp.asarray(n)))
    want = jmega._edge_tests(*map(jnp.asarray, (x, n, i1, i2, test_both,
                                                 keys)),
                             jnp.float32(0.01), 2000, T)
    got = tmega._edge_tests(
        torch.as_tensor(x), *(torch.as_tensor(a).long() for a in (n, i1, i2)),
        torch.as_tensor(test_both), torch.as_tensor(keys.astype(np.int64)),
        torch.tensor(0.01, dtype=torch.float32), 2000, T)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2]) > 8


# --- segment lengths against canvas_tpu's run_cbs_mega -------------------

def test_planted_pair_equal(run_all):
    _equal(run_all, ["planted"])
    assert len(run_all[1]["planted"]) == 5


def test_walk_decided_splits_equal(run_all):
    _equal(run_all, ["weak"])
    counts = run_all[2]
    assert counts["walk_chunks"] >= 2
    assert counts["walks_accepted"] >= 1 and counts["walks_rejected"] >= 1
    assert len(run_all[1]["weak"]) > 1


def test_edge_location_splits_equal(run_all):
    _equal(run_all, ["interior", "mid", "start", "end"])
    assert run_all[2]["edge_chunks"] >= 1
    assert len(run_all[1]["interior"]) == 3 and len(run_all[1]["mid"]) == 3


def test_empty_and_two_bin_contigs(run_all):
    _equal(run_all, ["empty", "tiny"])
    assert list(run_all[1]["empty"]) == [0]
    assert list(run_all[1]["tiny"]) == [2]


@pytest.mark.parametrize("undo", ["prune", "sdundo"])
def test_undo_equal(undo):
    rng = np.random.default_rng(17)
    cov = {"chr1": _planted(rng, events=((300, 600, 4.0), (640, 700, 0.9)))}
    # a flat contig of 1,100 bins (never analysed) and six 2-bin contigs
    # give canvas_tpu the [8, 2,048] table it compiled for run_all
    cov["flat"] = np.full(1100, 2.0)
    cov.update({f"pad{i}": np.array([0.0, 1.0]) for i in range(6)})
    want, got, _counts = _both(cov, undo_method=undo)
    np.testing.assert_array_equal(got["chr1"], want["chr1"])
    assert list(got["flat"]) == [1100]


def test_two_tiers_equal(run_all):
    _equal(run_all, ["long"])
    assert {1024, 2048} <= set(run_all[2]["tiers"])
    assert len(run_all[1]["long"]) >= 3


# --- where the table cannot hold the input (the port alone) ---------------

def test_none_beyond_the_table():
    rng = np.random.default_rng(3)
    many = {f"chr{c}": rng.normal(0, 1, 16) for c in range(193)}
    assert tmega.run_cbs_mega(many, n_perm=N_PERM, device="cpu") is None
    long = {"chr1": rng.normal(0, 1, 65537)}
    assert tmega.run_cbs_mega(long, n_perm=N_PERM, device="cpu") is None


@pytest.mark.parametrize("cap", ["slots", "levels"])
def test_none_on_table_overflow(monkeypatch, cap):
    """Twelve alternating segments overflow a table of 8 slots (the
    smallest), and a bound of one level cannot finish a recursion."""
    if cap == "slots":
        monkeypatch.setattr(tmega, "_MIN_SLOTS", 4)
    else:
        monkeypatch.setattr(tmega, "_MAX_LEVELS", 1)
    r = np.random.default_rng(13).normal(0, 0.3, 480)
    r[np.arange(480) // 40 % 2 == 1] += 6.0
    counts = {}
    assert tmega.run_cbs_mega({"chr1": r}, n_perm=N_PERM, device="cpu",
                              counts=counts) is None
    assert counts["levels"] == (3 if cap == "slots" else 1)


def test_syncs_counted(run_all):
    """Every read from the device is counted: at least two a level (its
    control values and its walk loop's last test) and one for the final
    table."""
    counts = run_all[2]
    assert counts["syncs"] >= 2 * counts["levels"] + 1
