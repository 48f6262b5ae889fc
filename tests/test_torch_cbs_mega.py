"""The whole-recursion CBS engine on the CPU: the port's ops/cbs_mega.py on
CPU tensors (the plain versions of kernels B4, K7 and K8) against
canvas_tpu's ops/cbs_mega.py, called directly.  Segment lengths must be equal contig by
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
from jax import lax

from canvas_tpu.ops import cbs_mega as jmega
from canvas_tpu_torch.ops import cbs_device
from canvas_tpu_torch.ops import cbs_mega as tmega
from canvas_tpu_torch.ops import cbs_mega_cuda as mc
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

    def record(cs, n, tss, npad, al0, **kw):
        # every tier runs each level, under its row mask: record the
        # widths that held a row
        if bool(kw["mask"].any()):
            tiers.append(npad)
        return tmax(cs, n, tss, npad, al0, **kw)

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
    got = mc.seg_keys(torch.tensor([0, 11]), torch.as_tensor(c),
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
    got = mc._walk_update(*map(torch.as_tensor, (ostat, nrejc, np0, nrej0,
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
        torch.as_tensor(test_both), torch.tensor([0, 3]), torch.arange(W),
        torch.zeros(W, dtype=torch.int64),
        torch.tensor(0.01, dtype=torch.float32), 2000, T)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) > 8


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
    """Every read from the device is counted: on CPU tensors one after
    each level, the last finding live 0 and carrying the final table."""
    counts = run_all[2]
    assert counts["syncs"] == counts["levels"]


# --- K7 and K8's plain versions: rows are independent ----------------------

WALK_PERM, WALK_TMAX = 1024, 2048
# full-arc rows (n <= 200), hybrid rows at tier 1,024 and at tier 2,048
WALK_LENGTHS = [150, 1000, 600, 1900, 200, 900, 1024, 1500, 350, 800, 120]


@pytest.fixture(scope="module")
def walk_rows():
    """K7's inputs for eleven walking rows at Tmax 2,048 (mixed tiers and
    hybrid flags), ostat at a high quantile of each row's chunk-0
    statistics so that walks take one or two chunks and end both ways."""
    rng = np.random.default_rng(8)
    W = len(WALK_LENGTHS)
    x = np.zeros((W, WALK_TMAX), np.float32)
    for r, L in enumerate(WALK_LENGTHS):
        v = rng.normal(0, 1, L)
        v[L // 3:L // 2] += 0.4
        x[r, :L] = v - v.mean()
    n = np.asarray(WALK_LENGTHS, np.int64)
    inp = {"x": torch.as_tensor(x), "n": torch.as_tensor(n),
           "tss": torch.as_tensor((x.astype(np.float64) ** 2).sum(1)
                                  .astype(np.float32)),
           "key0": torch.as_tensor(rng.integers(0, 2 ** 32, 2)),
           "seg_c": torch.as_tensor(rng.integers(0, 192, W)),
           "seg_lo": torch.as_tensor(rng.integers(0, 60000, W)),
           "walking": torch.ones(W, dtype=torch.bool),
           "hybrid": torch.as_tensor(n > 200),
           "nrejc": torch.as_tensor(rng.integers(4, 12, W))}
    stats = torch.zeros((W, mc.P_CHUNK))
    mc.walk_plain(**inp, ostat=torch.zeros(W), sbdry=_boundary(512),
                  n_perm=512, al0=2, kmax=25, n_min=200, stats=stats)
    q = [0.985, 0.995, 0.999]
    inp["ostat"] = torch.as_tensor(
        [float(np.quantile(stats[r].numpy(), q[r % 3])) for r in range(W)],
        dtype=torch.float32)
    inp["sbdry"] = _boundary(WALK_PERM)
    return inp, stats


def _row_keys(inp):
    """The rows' keys that K7 and its plain version derive."""
    return mc.seg_keys(inp["key0"], inp["seg_c"], inp["seg_lo"], inp["n"])


def _boundary(n_perm):
    return torch.as_tensor(np.asarray(tmega._cbs.compute_boundary(
        n_perm, 0.01, tmega._cbs.DEFAULT_ETA), np.int64))


def _compacted_walk(inp, n_perm, Tmax, al0=2, kmax=25, n_min=200):
    """The walks in canvas_tpu's schedule: each iteration the first 8
    walking rows draw their next chunk, batched by (hybrid, tier)."""
    W = inp["x"].shape[0]
    keys = _row_keys(inp)
    walking = inp["walking"].clone()
    accepted = torch.zeros(W, dtype=torch.bool)
    np0 = torch.zeros(W, dtype=torch.int64)
    nrej0 = torch.zeros_like(np0)
    kw = inp["nrejc"] * (inp["nrejc"] + 1) // 2 + 1
    chunks = torch.zeros_like(np0)
    while bool(walking.any()):
        sel = torch.nonzero(walking)[:8, 0]
        pst = torch.zeros((W, mc.P_CHUNK))
        for hyb in (False, True):
            for w in tmega._tiers(Tmax):
                g = [int(r) for r in sel
                     if bool(inp["hybrid"][r]) == hyb
                     and mc.tier_width(int(inp["n"][r])) == w]
                if g:
                    pst[g] = cbs_device._perm_stats(
                        inp["x"][g, :w], inp["n"][g], inp["tss"][g],
                        threefry.fold_in(keys[g], chunks[g]), w,
                        mc.P_CHUNK, al0, kmax, not hyb, n_min)
        now = torch.zeros_like(walking)
        now[sel] = True
        acc, walk1, np0, nrej0, kw = mc._walk_update(
            inp["ostat"], inp["nrejc"], np0, nrej0, kw, now, pst,
            inp["sbdry"], n_perm)
        walking = torch.where(now, walk1, walking)
        chunks = torch.where(now, chunks + 1, chunks)
        accepted = accepted | acc
    return accepted, chunks


def _jax_walk(inp, n_perm, Tmax, al0=2, kmax=25):
    """canvas_tpu's walk loop (cbs_mega.py:418-448) on its own, with its
    _chunk_stats and _walk_update."""
    x, n, tss, needs, hybrid, ostat, nrejc, sbdry = (
        jnp.asarray(inp[k].numpy()) for k in (
            "x", "n", "tss", "walking", "hybrid", "ostat", "nrejc",
            "sbdry"))
    keys = jnp.asarray(_row_keys(inp).numpy())
    n, nrejc, sbdry = (a.astype(jnp.int32) for a in (n, nrejc, sbdry))
    keys = keys.astype(jnp.uint32)
    W = x.shape[0]

    def wbody(state):
        accepted, walking, np0, nrej0, kw, chunks = state
        sel = jnp.argsort(~walking)[:jmega._W]
        on = walking[sel]
        pst_sel = jmega._chunk_stats(x[sel], n[sel], tss[sel], keys[sel],
                                     chunks[sel], on, hybrid[sel], Tmax,
                                     al0, kmax)
        pstats = jnp.zeros((W, mc.P_CHUNK), jnp.float32
                           ).at[sel].set(pst_sel, mode="drop")
        now = jnp.zeros(W, bool).at[sel].set(on, mode="drop")
        acc, walk1, np1, nrej1, kw1 = jmega._walk_update(
            ostat, nrejc, np0, nrej0, kw, now, pstats, sbdry, n_perm)
        return (accepted | acc, jnp.where(now, walk1, walking), np1, nrej1,
                kw1, jnp.where(now, chunks + 1, chunks))

    init = (jnp.zeros(W, bool), needs, jnp.zeros(W, jnp.int32),
            jnp.zeros(W, jnp.int32), nrejc * (nrejc + 1) // 2 + 1,
            jnp.zeros(W, jnp.int32))
    out = jax.jit(lambda s: lax.while_loop(lambda t: jnp.any(t[1]), wbody,
                                           s))(init)
    return np.asarray(out[0]), np.asarray(out[5])


@pytest.fixture(scope="module")
def walks(walk_rows):
    inp, _stats = walk_rows
    args = dict(inp, n_perm=WALK_PERM, al0=2, kmax=25, n_min=200)
    return {"compacted": _compacted_walk(inp, WALK_PERM, WALK_TMAX),
            "plain": mc.walk_plain(**args),
            "wrapper": mc.walk(**args)}


def test_walk_plain_equals_compacted_schedule(walks):
    """walk_plain (each row alone, chunk after chunk) gives canvas_tpu's
    schedule's flags and chunk counts, and so does the wrapper on CPU
    tensors; the case walks more than 8 rows, two chunks deep, and ends
    walks both ways."""
    acc, chunks = walks["compacted"]
    for k in ("plain", "wrapper"):
        assert torch.equal(walks[k][0], acc), k
        assert torch.equal(walks[k][1], chunks), k
    assert int(chunks.max()) == 2 and int((chunks == 1).sum()) >= 1
    assert bool(acc.any()) and not bool(acc.all())


@pytest.mark.parametrize("rows", [[0, 1, 2, 3], [4, 5, 6, 7],
                                  [8, 9, 10]])
def test_walk_rows_alone_equal_batched(walk_rows, walks, rows):
    """Each walking row alone through walk_plain: the batched schedule's
    flag and chunk count."""
    inp, _stats = walk_rows
    acc, chunks = walks["compacted"]
    for r in rows:
        one = {k: (v[r:r + 1] if k not in ("sbdry", "key0") else v)
               for k, v in inp.items()}
        got = mc.walk_plain(**one, n_perm=WALK_PERM, al0=2, kmax=25,
                            n_min=200)
        assert bool(got[0][0]) == bool(acc[r]), r
        assert int(got[1][0]) == int(chunks[r]), r


def test_walk_plain_equals_canvas_tpu(walk_rows, walks):
    """walk_plain against canvas_tpu's own walk loop (its _chunk_stats,
    its compaction of 8 rows) on the same rows and keys."""
    inp, _stats = walk_rows
    acc, chunks = _jax_walk(inp, WALK_PERM, WALK_TMAX)
    np.testing.assert_array_equal(walks["plain"][0].numpy(), acc)
    np.testing.assert_array_equal(walks["plain"][1].numpy(), chunks)


def test_walk_stats_equal_canvas_tpu(walk_rows):
    """Chunk 0's statistics of every row, as walk_plain reports them,
    against canvas_tpu's _chunk_stats at each row's tier: the same
    permutations, so equal up to the cumsum's rounding (canvas_tpu sums
    in f32, the port in float64 rounded once: a few f32 ulps)."""
    inp, stats = walk_rows
    W = inp["x"].shape[0]
    want = np.asarray(jmega._chunk_stats(
        jnp.asarray(inp["x"].numpy()), jnp.asarray(inp["n"].numpy(),
                                                   jnp.int32),
        jnp.asarray(inp["tss"].numpy()),
        jnp.asarray(_row_keys(inp).numpy().astype(np.uint32)),
        jnp.zeros(W, jnp.int32), jnp.ones(W, bool),
        jnp.asarray(inp["hybrid"].numpy()), WALK_TMAX, 2, 25))
    np.testing.assert_allclose(stats.numpy(), want, rtol=1e-5, atol=0)
    # another permutation would move the statistics by far more
    assert np.abs(stats.numpy() - want).max() < 1e-3 * np.abs(
        stats.numpy() - np.roll(want, 1, axis=1)).max()


EDGE_PERM = 2048
EDGE_WN = [1000, 1900, 300, 1024, 1500, 60, 700, 2000, 450, 1100]
EDGE_M1 = [400, 900, 2, 12, 700, 30, 150, 3, 200, 550]


@pytest.fixture(scope="module")
def edge_lanes():
    """K8's inputs for ten active lanes at Tmax 2,048 (tiers 1,024 and
    2,048, subset sizes from 2 to half the window), ostat at a high
    quantile of each lane's chunk-0 statistics."""
    rng = np.random.default_rng(6)
    L, Tmax = len(EDGE_WN), 2048
    xw = np.zeros((L, Tmax), np.float32)
    for r, w in enumerate(EDGE_WN):
        v = rng.normal(0, 1, w)
        v[:EDGE_M1[r]] += 0.15
        xw[r, :w] = v
    xwt = torch.as_tensor(xw)
    wn = torch.as_tensor(EDGE_WN)
    inp = {"xw": xwt, "wn": wn, "m1": torch.as_tensor(EDGE_M1),
           "xbar": xwt.double().sum(1).float() / wn.to(torch.float32),
           "active": torch.ones(L, dtype=torch.bool),
           "key0": torch.as_tensor(rng.integers(0, 2 ** 32, 2)),
           "seg_c": torch.as_tensor(rng.integers(0, 192, L)),
           "seg_lo": torch.as_tensor(rng.integers(0, 60000, L)),
           "seg_n": torch.as_tensor(rng.integers(2000, 9000, L)),
           "limit": torch.tensor(0.01, dtype=torch.float32) * EDGE_PERM}
    sums = torch.zeros((L, mc.P_CHUNK))
    mc.edge_counts_plain(**dict(inp, limit=torch.tensor(1e9)),
                         ostat=torch.zeros(L), n_perm=512, sums=sums)
    pstat = (sums / inp["m1"].to(torch.float32)[:, None]
             - inp["xbar"][:, None]).abs()
    q = [0.99, 0.995, 0.98]
    inp["ostat"] = torch.as_tensor(
        [float(np.quantile(pstat[r].numpy(), q[r % 3])) for r in range(L)],
        dtype=torch.float32)
    return inp


def _compacted_edges(inp, n_perm):
    """The edge tests in canvas_tpu's schedule: each iteration the first
    8 active lanes draw their next chunk, batched by tier with the
    group's longest window as the drawn width."""
    L = inp["xw"].shape[0]
    ekeys = mc.edge_keys(inp["key0"], inp["seg_c"], inp["seg_lo"],
                         inp["seg_n"], L)
    active = inp["active"].clone()
    count = torch.zeros(L, dtype=torch.int64)
    done = torch.zeros_like(count)
    cnt = torch.zeros_like(count)
    m1f = torch.clamp(inp["m1"], min=1).to(torch.float32)
    lane = torch.arange(mc.P_CHUNK)
    while bool(active.any()):
        sel = torch.nonzero(active)[:8, 0]
        sums = torch.zeros((L, mc.P_CHUNK))
        for w in (1024, 2048):
            g = [int(r) for r in sel
                 if mc.tier_width(int(inp["wn"][r])) == w]
            if g:
                sums[g] = mc._subset_sums(
                    inp["xw"][g], inp["wn"][g], inp["m1"][g],
                    [int(inp["m1"][r]) for r in g],
                    threefry.fold_in(ekeys[g], cnt[g]), w,
                    int(inp["wn"][g].max()))
        take = torch.clamp(n_perm - done[sel], max=mc.P_CHUNK)
        pstat = (sums[sel] / m1f[sel][:, None]
                 - inp["xbar"][sel][:, None]).abs()
        count[sel] += ((inp["ostat"][sel][:, None] <= pstat)
                       & (lane < take[:, None])).sum(1)
        done[sel] += take
        cnt[sel] += 1
        active = active & (count.to(torch.float32) <= inp["limit"]) \
            & (done < n_perm)
    return count, cnt


@pytest.mark.parametrize("alone", [False, True])
def test_edge_counts_plain_equal_compacted_schedule(edge_lanes, alone):
    """edge_counts_plain (all lanes, or each lane alone) gives the counts
    and chunk counts of canvas_tpu's schedule; the case runs more than 8
    lanes, stops some early on their count and runs others to n_perm."""
    count, cnt = _compacted_edges(edge_lanes, EDGE_PERM)
    if alone:
        got = [mc.edge_counts_plain(
            **{k: (v[r:r + 1] if v.dim() and k != "key0" else v)
               for k, v in edge_lanes.items()}, n_perm=EDGE_PERM)
            for r in range(len(EDGE_WN))]
        got = (torch.cat([g[0] for g in got]), torch.cat([g[1] for g in got]))
    else:
        got = mc.edge_counts(**edge_lanes, n_perm=EDGE_PERM)
    assert torch.equal(got[0], count) and torch.equal(got[1], cnt)
    assert int(cnt.max()) == EDGE_PERM // mc.P_CHUNK
    assert int(cnt.min()) < EDGE_PERM // mc.P_CHUNK


# --- keys from the level key, as K7 and K8 derive them ---------------------

def test_walk_plain_derives_canvas_tpu_keys(walk_rows):
    """walk_plain, given the level key and each row's (contig, start),
    draws under canvas_tpu's _seg_keys(key0, contig, lo, n): its chunk-0
    statistics equal _perm_stats under those keys bit for bit (the
    hybrid rows and the full-arc rows of tier 1,024)."""
    inp, stats = walk_rows
    jkeys = np.asarray(jmega._seg_keys(
        jnp.asarray(inp["key0"].numpy().astype(np.uint32)),
        *(jnp.asarray(inp[k].numpy().astype(np.int32))
          for k in ("seg_c", "seg_lo", "n")))).astype(np.int64)
    for hyb in (False, True):
        rows = [r for r, L in enumerate(WALK_LENGTHS)
                if (L > 200) == hyb and mc.tier_width(L) == 1024]
        want = cbs_device._perm_stats(
            inp["x"][rows, :1024], inp["n"][rows], inp["tss"][rows],
            threefry.fold_in(torch.as_tensor(jkeys[rows]), 0), 1024,
            mc.P_CHUNK, 2, 25, not hyb, 200)
        assert torch.equal(stats[rows].view(torch.int32),
                           want.view(torch.int32)), hyb


@pytest.mark.parametrize("edges", [1, 2])
def test_edge_counts_plain_derives_canvas_tpu_keys(edges):
    """edge_counts_plain over L = edges x R lanes draws lane l under
    fold_in(canvas_tpu's _seg_keys of row l % R, 7777 + l // R), as
    canvas_tpu's _edge_tests does: its chunk-0 subset sums equal
    _subset_sums under those keys bit for bit."""
    rng = np.random.default_rng(21 + edges)
    R, T = 3, 1024
    L = edges * R
    wn = rng.integers(300, 1000, L)
    m1 = np.minimum(rng.integers(2, 60, L), wn // 2)
    xw = np.zeros((L, T), np.float32)
    for r in range(L):
        xw[r, :wn[r]] = rng.normal(0, 1, wn[r])
    key0 = rng.integers(0, 2 ** 32, 2)
    c, lo, n = (rng.integers(0, hi, R) for hi in (192, 60000, 9000))
    sums = torch.zeros((L, mc.P_CHUNK))
    xwt = torch.as_tensor(xw)
    mc.edge_counts_plain(
        xwt, torch.as_tensor(wn), torch.as_tensor(m1), torch.zeros(L),
        torch.full((L,), float("inf")), torch.ones(L, dtype=torch.bool),
        torch.as_tensor(key0), *map(torch.as_tensor, (c, lo, n)),
        torch.tensor(1e9), 512, sums=sums)
    seg = jmega._seg_keys(jnp.asarray(key0.astype(np.uint32)),
                          *(jnp.asarray(a.astype(np.int32))
                            for a in (c, lo, n)))
    jkeys = np.concatenate([np.asarray(jax.vmap(
        lambda k, e=e: jax.random.fold_in(k, 7777 + e))(seg))
        for e in range(edges)]).astype(np.int64)
    for r in range(L):
        want = mc._subset_sums(
            xwt[r:r + 1], torch.as_tensor(wn[r:r + 1]),
            torch.as_tensor(m1[r:r + 1]), [int(m1[r])],
            threefry.fold_in(torch.as_tensor(jkeys[r:r + 1]), 0),
            mc.tier_width(int(wn[r])), int(wn[r]))[0]
        assert torch.equal(sums[r].view(torch.int32),
                           want.view(torch.int32)), r


def test_edge_lanes_must_split_into_rows():
    """K8's lanes are whole edges of the rows: L a multiple of R."""
    with pytest.raises(ValueError, match="do not split"):
        mc.edge_counts(torch.zeros((3, 1024)), *([torch.ones(3)] * 5),
                       torch.tensor([0, 1]), *([torch.zeros(2)] * 3),
                       torch.tensor(1.0), 512)


# --- C5: the tail probability's precision ----------------------------------

C5_ALPHA = 0.01
C5_NPERM = 10_000


def _c5_rows(seed, R):
    """R hybrid rows (b f32, n) whose float64 walk limit (alpha - p1)
    n_perm lies within 1e-3 of an integer: n uniform in (200, 65,536)
    (ROADMAP's C5 sample), the limit's integer part j uniform in [1, 99]
    and its offset u uniform in [-1e-3, 1e-3], all from the seed, and b
    solved for p1(b) = alpha - (j + u) / n_perm with canvas_tpu's tail in
    float64 (jax's x64 mode), then rounded to f32 as the engines' ostat1
    is.  Only such rows can take another limit from canvas_tpu's float32
    tail, and they are rare at random, so the test makes them rather than
    drawing thousands of rows at 30 ms a row.  Returns (b, n, canvas_tpu's p1 of
    b in float64)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(201, 65_536, R)
    target = rng.integers(1, 100, R) + rng.uniform(-1e-3, 1e-3, R)
    logp = np.log(C5_ALPHA - target / C5_NPERM)
    with jax.enable_x64(True):
        tail = jax.jit(jmega._tail_p_batch_dev, static_argnums=(2, 3))

        def f(b):
            return np.log(np.asarray(tail(jnp.asarray(b), jnp.asarray(n),
                                          25, 100))) - logp
        # regula falsi (Illinois) on ln p1(b), decreasing in b on [2, 8]
        lo, hi = np.full(R, 2.0), np.full(R, 8.0)
        flo, fhi = f(lo), f(hi)
        assert (flo > 0).all() and (fhi < 0).all()
        for _ in range(40):
            b = (lo * fhi - hi * flo) / (fhi - flo)
            fb = f(b)
            left = fb > 0
            lo, flo = np.where(left, b, lo), np.where(left, fb, flo)
            hi, fhi = np.where(left, hi, b), np.where(left, fhi, fb)
            flo = np.where(~left, flo / 2, flo)
            fhi = np.where(left, fhi / 2, fhi)
            if np.abs(fb).max() < 1e-11:
                break
        b32 = b.astype(np.float32)
        p64 = np.asarray(tail(jnp.asarray(b32.astype(np.float64)),
                              jnp.asarray(n), 25, 100))
    return b32, n, p64


def _port_tail(b32, n):
    """The port's _tail_p_batch_dev on CPU tensors (float64, K11's plain
    version), as both of its engines call it with b = ostat1."""
    return cbs_device._tail_p_batch_dev(
        torch.as_tensor(b32.astype(np.float64)), torch.as_tensor(n), 25,
        100).numpy()


def test_tail_precision_changes_walk_limits_c5():
    """C5: the port's engines take the OU tail probability p1 in float64
    (K11, rounded to f32 by the whole-recursion engine), canvas_tpu's in
    float32.  On rows whose walk limit int((alpha - p1) n_perm) lies near
    an integer: tail_ok = p1 <= alpha is equal on every row; the limits
    differ on some rows, and on each of those canvas_tpu's float32 p1 is
    the further of the two from its own tail in float64, while the port's
    limit is the one that float64 tail gives on every row."""
    b32, n, p64 = _c5_rows(16, 24)
    alpha_t = torch.full((), C5_ALPHA, dtype=torch.float32)

    def limits_port(p1):            # ops/cbs_mega.py: p1 rounded to f32
        p1 = torch.tensor(p1).float()
        return (p1 <= alpha_t).numpy(), \
            ((alpha_t - p1) * C5_NPERM).to(torch.int32).numpy()

    p_port = _port_tail(b32, n)
    ok_port, lim_port = limits_port(p_port)
    p_jax = np.asarray(jax.jit(jmega._tail_p_batch_dev, static_argnums=(
        2, 3))(jnp.asarray(b32), jnp.asarray(n.astype(np.int32)), 25, 100))
    assert p_jax.dtype == np.float32
    alpha_j = jnp.asarray(C5_ALPHA, jnp.float32)
    ok_jax = np.asarray(jnp.asarray(p_jax) <= alpha_j)
    lim_jax = np.asarray(((alpha_j - jnp.asarray(p_jax)) * C5_NPERM)
                         .astype(jnp.int32))
    assert ok_port.all() and np.array_equal(ok_port, ok_jax)
    differ = lim_port != lim_jax
    assert differ.any()
    far_jax = np.abs(p_jax.astype(np.float64) - p64)
    far_port = np.abs(p_port.astype(np.float32).astype(np.float64) - p64)
    assert (far_jax[differ] > far_port[differ]).all()
    assert np.array_equal(lim_port, limits_port(p64)[1])
    assert (np.abs(lim_port - lim_jax) <= 1).all()
