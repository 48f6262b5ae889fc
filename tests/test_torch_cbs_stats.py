"""The CBS level's statistics on the CPU: the plain versions of kernels K9
(B4's inputs), K10 (the refine and t^2), K11 (the tail probability) and
K12 (the frontier's permutation chunks) against canvas_tpu's functions on
the same numpy inputs, and the wrappers' device rule.  canvas_tpu's Pallas
arc scan runs in interpret mode, at npad <= 2,048 only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canvas_tpu.ops import cbs_device as jdev
from canvas_tpu_torch.ops import arc_scan_cuda
from canvas_tpu_torch.ops import cbs_device as tdev
from canvas_tpu_torch.ops import cbs_mega_cuda as mc
from canvas_tpu_torch.ops import cbs_stats_cuda as st
from tests.test_torch_cuda import _step_row

torch.set_num_threads(1)

AL0 = 2


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _noise_rows(seed, npad, B):
    """Cumsums f32 [B, npad] of centred noise with a planted step (float64
    accumulation, as the port's engines), lengths in (npad / 2, npad] and
    sums of squares."""
    rng = np.random.default_rng(seed)
    cs = np.zeros((B, npad), np.float32)
    n = np.zeros(B, np.int32)
    tss = np.zeros(B, np.float32)
    for i in range(B):
        L = int(rng.integers(npad // 2 + 1, npad + 1))
        r = rng.normal(0, 1, L)
        r[L // 4:L // 3] += 1.2
        r -= r.mean()
        cs[i, :L] = np.cumsum(r)
        n[i] = L
        tss[i] = np.sum(r * r)
    return cs, n, tss


def _tie_rows(seed, npad):
    """Integer-valued cumsum rows f32 [4, npad] whose extrema and best
    terms tie: an integer random walk; two equal spikes at n - 2 and
    n - 10 over a shallow valley (the best term at lag 2 from three
    positions); a staircase of equal steps (each position's best lag ties
    with its neighbours'); and a walk with a plateau at its maximum."""
    rng = np.random.default_rng(seed)
    cs = np.zeros((4, npad), np.float32)
    n = np.array([npad - 1, npad, npad - 7, npad // 2 + 3], np.int32)
    cs[0, :n[0]] = np.cumsum(rng.integers(-1, 2, n[0]))
    cs[1, n[1] - 2] = 40.0
    cs[1, n[1] - 10] = 40.0
    cs[1, n[1] // 2] = -1.0
    cs[2, :n[2]] = np.repeat(np.arange(n[2] // 16 + 1), 16)[:n[2]] * 3.0
    walk = np.cumsum(rng.integers(-2, 3, n[3]))
    top = int(np.argmax(walk))
    walk[top:top + 40] = walk[top]
    cs[3, :n[3]] = walk
    tss = (np.diff(cs, axis=1, prepend=0) ** 2).sum(1).astype(np.float32)
    return cs, n, tss


def _canvas_tpu_inputs(cs, n, npad):
    """seed, lag_hi, ti0, tj0, psdiff and psd2 as canvas_tpu's
    _tmax_batch_pallas builds them (cbs_device.py:382-398)."""
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
    ti0 = jnp.minimum(imin, imax).astype(jnp.int32) + 1
    tj0 = jnp.maximum(imin, imax).astype(jnp.int32) + 1
    psd2 = jdev._block_d2_bound(csj, psdiff, npad, min(512, npad))
    return seed, lag_hi, ti0, tj0, psd2


# --- K9 ---------------------------------------------------------------------

@pytest.mark.parametrize("npad,rows", [(512, "noise"), (512, "ties"),
                                       (2048, "noise"), (2048, "ties"),
                                       (65536, "noise")])
def test_arc_scan_inputs_plain_equals_canvas_tpu(npad, rows):
    """K9's plain version against canvas_tpu's inputs of its arc scan:
    seed, lag_hi, the seed's split and psd2 (_block_d2_bound) bit for bit;
    at 65,536 (128 lag blocks, 256 chunks) the JAX function alone."""
    if rows == "ties":
        cs, n, _tss = _tie_rows(npad, npad)
    else:
        cs, n, _tss = _noise_rows(npad, npad, 2 if npad == 65536 else 4)
    want = _canvas_tpu_inputs(cs, n, npad)
    for nt in (torch.as_tensor(n), torch.as_tensor(n.astype(np.int64))):
        got = st.arc_scan_inputs_plain(torch.as_tensor(cs), nt, npad, AL0)
        seed, lag_hi, psd2, ti0, tj0 = got
        np.testing.assert_array_equal(_bits(seed.numpy()), _bits(want[0]))
        np.testing.assert_array_equal(lag_hi.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(ti0.numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(tj0.numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(_bits(psd2.numpy()), _bits(want[4]))
        assert psd2.shape == (cs.shape[0], max(npad // 512, 1))
        # the wrapper's CPU path, with n as int32 for B4
        also = st.arc_inputs(torch.as_tensor(cs), nt, npad, AL0)
        assert all(torch.equal(a, b) for a, b in zip(also[:5], got))
        assert also[5].dtype == torch.int32
        assert torch.equal(also[5], nt.to(torch.int32))
    # the frontier engine's name for it
    assert tdev.arc_scan_inputs is st.arc_scan_inputs


# --- K9 + B4 + K10 ----------------------------------------------------------

@pytest.mark.parametrize("npad", [256, 512, 1024])
def test_tmax_batch_with_ties_equals_pallas_interpret(npad):
    """tmax_batch on CPU tensors (K9's plain version, B4's, K10's) against
    canvas_tpu's _tmax_batch_pallas in interpret mode on integer-valued
    rows whose best terms tie across positions and lags: t^2 bit for bit
    and the same first (ti, tj)."""
    cs, n, tss = _tie_rows(npad + 1, npad)
    t2j, tij, tjj = jdev._tmax_batch_pallas(
        jnp.asarray(cs), jnp.asarray(n), jnp.asarray(tss), npad, AL0,
        interpret=True)
    t2, ti, tj = tdev.tmax_batch(torch.as_tensor(cs), torch.as_tensor(n),
                                 torch.as_tensor(tss), npad, AL0)
    np.testing.assert_array_equal(_bits(t2.numpy()), _bits(t2j))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(tij))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(tjj))
    # the spikes: lag 2 from the first of the three tied positions
    assert (int(ti[1]), int(tj[1])) == (int(n[1]) - 11, int(n[1]) - 9)


def test_refine_plain_keeps_the_seed_split_where_b4_never_beat_it():
    """Rows whose B4 sub-block is -1 keep K9's (ti0, tj0); a row with no
    admissible pair in its sub-block takes its first position and lag."""
    npad = 512
    cs, n, tss = _noise_rows(3, npad, 3)
    csT, nT, tssT = (torch.as_tensor(a) for a in (cs, n, tss))
    seed, lag_hi, _psd2, ti0, tj0 = st.arc_scan_inputs_plain(csT, nT, npad,
                                                             AL0)
    best = seed.clone()
    bl0 = torch.tensor([-1, 0, 480], dtype=torch.int32)
    lag_hi = torch.tensor([int(lag_hi[0]), int(lag_hi[1]), 1],
                          dtype=torch.int32)
    t2, ti, tj = st.refine_plain(csT, nT, tssT, lag_hi, best, bl0, ti0, tj0,
                                 npad, AL0)
    assert (int(ti[0]), int(tj[0])) == (int(ti0[0]), int(tj0[0]))
    assert int(tj[1]) - int(ti[1]) in range(AL0, 32)
    assert (int(ti[2]), int(tj[2])) == (1, 480 + 1)   # nothing admitted
    assert torch.equal(st.refine(csT, nT, tssT, lag_hi, best, bl0, ti0, tj0,
                                 npad, AL0)[0], t2)


# --- K11 --------------------------------------------------------------------

def _level_batch(seed=14, R=32):
    """A level's batch of statistics b [R] at n bins: b of 0 and 1e-3
    (every x <= 0.01), b up to 7 at small n (x past the 9.0 clamp), n from
    4 to 65,536."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(0.05, 7.0, R)
    b[:3] = [0.0, 1e-3, 1e-3]
    n = rng.integers(4, 65537, R)
    n[:6] = [10000, 10000, 4, 30, 57, 65536]
    return b, n


def test_tail_p_plain_at_a_level_batch_equals_canvas_tpu():
    """The tail probability of a [32 x 100] level batch against canvas_tpu's
    _tail_p_batch_dev run in float64 (jax's x64 mode): rtol 1e-12, for
    the sums' order and the two libraries' erfc.  (canvas_tpu runs it in
    float32, whose error reaches 1.6e-4 relative on this batch.)"""
    b, n = _level_batch()
    x = b[:, None] / np.sqrt(n)[:, None] / 0.5
    assert (x[1] <= 0.01).all() and (x * np.sqrt(8192.5) / 2 > 9.0).any()
    with jax.enable_x64(True):
        want = np.asarray(jdev._tail_p_batch_dev(
            jnp.asarray(b, jnp.float64), jnp.asarray(n, jnp.int64), 25, 100))
    got = tdev._tail_p_batch_dev(torch.as_tensor(b), torch.as_tensor(n), 25,
                                 100).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] == 0.0 and np.isfinite(got).all()
    assert np.array_equal(got, st.tail_p(torch.as_tensor(b),
                                         torch.as_tensor(n), 25, 100).numpy())


def test_tree_sum_is_the_adjacent_pair_tree():
    """_tree_sum adds slots (0, 1), (2, 3), ... then pairs of pairs, zero
    past the values: on values whose sum depends on the order, it equals
    that tree written out, and not the sum left to right."""
    v = torch.tensor([1e16, 1.0, -1e16, 1.0, 3.0], dtype=torch.float64)
    want = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + 0.0) + (0.0 + 0.0))
    assert float(st._tree_sum(v, 8)) == float(want) == 3.0
    assert float(((((v[0] + v[1]) + v[2]) + v[3]) + v[4])) == 4.0


def test_nu_plain_series_and_tail():
    """nu at x <= 0.01 is exp(-0.583 x); above, the series of 8,192 terms
    and the Simpson tail, against canvas_tpu's _nu_dev in float64 (rtol
    1e-12) and in float32, as canvas_tpu runs it (rtol 1e-5)."""
    x = np.array([0.0, 0.004, 0.01, 0.0101, 0.05, 0.3, 1.0, 4.0, 30.0])
    got = st.nu_plain(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got[:3], np.exp(-0.583 * x[:3]))
    with jax.enable_x64(True):
        want = np.asarray(jdev._nu_dev(jnp.asarray(x, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    want = np.asarray(jdev._nu_dev(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --- what K10's and K11's layouts on the card rest on ----------------------

KERNEL_TILE = 512        # K10's positions a thread block (csrc/cbs_stats.cu)


def _refine_lex_numpy(cs, n, lag_hi, bl0):
    """(ti, tj) of each row with a sub-block, as the lexicographic maximum
    of (term, -i, -k) over its admissible pairs (position i, lag bl0 + k,
    k < 32, the lag in [AL0, lag_hi], i + lag <= n - 1), the term (w d) d
    in float32; (1, bl0 + 1) where none is admissible; None where bl0 is
    -1."""
    B, npad = cs.shape
    sub = min(32, npad)
    i = np.arange(npad)[:, None]
    k = np.arange(sub)[None, :]
    out = []
    for r in range(B):
        if bl0[r] < 0:
            out.append(None)
            continue
        lag = bl0[r] + k
        ok = (lag >= AL0) & (lag <= lag_hi[r]) & (i + lag <= n[r] - 1)
        d = cs[r][np.minimum(i + lag, npad - 1)] - cs[r][i]
        lf = np.maximum(lag, 1).astype(np.float32)
        nf = np.float32(n[r])
        with np.errstate(divide="ignore", invalid="ignore"):
            w = nf / (lf * (nf - lf))          # inf where lag = n: not ok
            term = np.where(ok, (w * d) * d, -np.inf)
        best_i, best_k = np.unravel_index(np.argmax(term), term.shape)
        out.append((int(best_i) + 1, int(best_i + bl0[r] + best_k) + 1))
    return out


def _straddling_rows(seed, npad):
    """Integer rows f32 [4, npad]: _tie_rows' random walk and plateau
    walk, and two of steps (_step_row) whose best pairs tie: rises of 2 a
    position over lag 9 from a tile's last position and from a position
    of the next tile, and from 505, whose pair crosses the tile edge, and
    from 3 tiles on (at widths of one tile: from 100 and 300, 200 and
    400)."""
    rng = np.random.default_rng(seed)
    cs, n, _tss = _tie_rows(seed, npad)
    starts = ([[100, 300], [200, 400]] if npad <= KERNEL_TILE else
              [[KERNEL_TILE - 1, KERNEL_TILE + 90],
               [KERNEL_TILE - 7, 3 * KERNEL_TILE]])
    lens = [npad - 5, npad]
    more = [_step_row(rng, npad, lens[r], starts[r], 9) for r in range(2)]
    return (np.concatenate([cs[[0, 3]], np.stack(more)]),
            np.concatenate([n[[0, 3]], lens]), [s[0] for s in starts])


@pytest.mark.parametrize("npad", [512, 2048, 32768])
def test_refine_plain_is_the_lexicographic_maximum(npad):
    """refine_plain's (ti, tj) equals the lexicographic maximum of
    (term, -i, -k) over every admissible pair, which the kernel takes
    across its tiles in any order: integer rows whose terms tie across
    positions and lags, equal best pairs on both sides of a tile edge, a
    row whose sub-block admits no pair (position 0, the sub-block's first
    lag) and one without a sub-block (the seed's split)."""
    cs, n, firsts = _straddling_rows(npad + 7, npad)
    B = cs.shape[0] + 2
    cs = np.concatenate([cs, cs[:2]])
    n = np.concatenate([n, n[:2]]).astype(np.int64)
    lag_hi = np.minimum(n - AL0, n - 1).astype(np.int32)
    bl0 = np.array([0, 32, 0, 0, min(npad - 32, 480), -1], np.int32)
    lag_hi[4] = bl0[4] - 1                    # nothing admitted
    csT = torch.as_tensor(cs)
    ti0 = torch.arange(1, B + 1, dtype=torch.int32)
    tj0 = ti0 + 5
    t2, ti, tj = st.refine_plain(
        csT, torch.as_tensor(n), torch.ones(B), torch.as_tensor(lag_hi),
        torch.full((B,), 0.5), torch.as_tensor(bl0), ti0, tj0, npad, AL0)
    want = _refine_lex_numpy(cs, n, lag_hi, bl0)
    for r in range(B):
        got = (int(ti[r]), int(tj[r]))
        assert got == (want[r] or (int(ti0[r]), int(tj0[r]))), (r, got,
                                                                 want[r])
    assert [want[2], want[3]] == [(i + 1, i + 10) for i in firsts]
    assert want[4] == (1, int(bl0[4]) + 1)


def _nu_terms(x, chunk):
    """nu_plain's series terms of chunk `chunk` at each x [X]: float64
    [X, 2,048], as it computes them."""
    K = st.NU_SERIES_CHUNK
    two, sqrt2 = st._const(2.0, x), st._const(float(np.sqrt(2.0)), x)
    k = (chunk * K + torch.arange(1, K + 1)).double()
    z = x[:, None] * torch.sqrt(k)[None, :] / two / sqrt2
    return torch.special.erfc(z) * 0.5 * (two / k)[None, :]


def _by_units(v, slots, units):
    """The adjacent-pair tree over `slots` slots of v as the kernel takes
    it: the trees over aligned runs of units[0] slots, those over runs of
    units[1] of them, and so on, then the tree over what is left."""
    v = torch.nn.functional.pad(v, (0, slots - v.shape[-1]))
    width = 1
    for u in units:
        v = st._tree_sum(v.reshape(*v.shape[:-1], -1, u), u)
        width *= u
    return st._tree_sum(v, slots // width)


def _nu_x(seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.concatenate([
        [0.0101, 0.05, 9.0 / np.sqrt(2048.125), 30.0],
        np.exp(rng.uniform(np.log(0.0101), np.log(40.0), 12))]))


@pytest.mark.parametrize("units", [(8, 32, 8), (8, 32), (256,), (512,),
                                   (2, 2, 2, 2, 2, 2, 2, 2, 2, 2)])
def test_series_chunk_tree_splits_into_aligned_units(units):
    """On nu_plain's own float64 terms (x from a seed, 0.0101 to 40), the
    tree over each 2,048-term chunk equals bit for bit the pairwise tree of
    its trees over aligned runs: a lane's 8 terms, 32 lanes a warp, 8
    warps a block (K11's units of 256), and other splits."""
    x = _nu_x(15)
    in_order = True
    for c in range(st.NU_SERIES_TERMS // st.NU_SERIES_CHUNK):
        t = _nu_terms(x, c)
        want = st._tree_sum(t, st.NU_SERIES_CHUNK)
        got = _by_units(t, st.NU_SERIES_CHUNK, units)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
        in_order &= torch.equal(torch.cumsum(t, dim=1)[:, -1], want)
    assert not in_order        # the order matters: a sum left to right differs


def _tail_p_as_the_kernel(b, n, kmax, n_grid):
    """tail_p_plain's arithmetic in K11's layout: each grid point's series
    as 4 chunks of 8 units of 32 lanes of 8 terms (sqrt(k) and 2 / k as a
    table, x sqrt(k) times 0.5), its Simpson points as 8 runs of 32, the
    grid's terms as 4 warps of 32."""
    dt = b.dtype
    nf = n.to(dt)
    delta = torch.clamp(st._const(kmax + 1.0, b) / nf, 0.0, 0.45)
    dincr = (0.5 - delta) / st._const(n_grid, b)
    i = torch.arange(n_grid).to(dt)[None, :]
    tls = 0.5 + i * dincr[:, None]
    ts = 0.5 + (i + 0.5) * dincr[:, None]
    x = ((b / torch.sqrt(nf))[:, None] / torch.sqrt(ts * (1 - ts))).reshape(-1)
    k = torch.arange(1, st.NU_SERIES_TERMS + 1).to(dt)
    two, sqrt2 = st._const(2.0, b), st._const(float(np.sqrt(2.0)), b)
    sqrt_k, two_k = torch.sqrt(k), two / k
    series = None
    for c in range(4):
        sl = slice(c * 2048, (c + 1) * 2048)
        z = x[:, None] * sqrt_k[None, sl] * 0.5 / sqrt2
        t = torch.special.erfc(z) * 0.5 * two_k[None, sl]
        s = _by_units(t, 2048, (8, 32, 8))
        series = s if series is None else series + s
    v0c = torch.clamp(x * float(np.sqrt(st.NU_SERIES_TERMS + 0.5)) / two,
                      max=9.0)
    h = (9.0 - v0c) / st._const(st.NU_TAIL_PANELS, b)
    j = torch.arange(st.NU_TAIL_PANELS + 1)
    u = v0c[:, None] + h[:, None] * j.to(dt)[None, :]
    f = 0.5 * torch.special.erfc(u / sqrt2) / torch.clamp(u, min=1e-12)
    simp = torch.where((j == 0) | (j == st.NU_TAIL_PANELS), 1.0,
                       torch.where(j % 2 == 1, 4.0, 2.0)).to(dt)
    simpson = _by_units(f * simp[None, :], st.NU_TAIL_SLOTS, (32,))
    tail = 4.0 * (h / st._const(3.0, b)) * simpson
    lnu = float(np.log(2.0)) - 2.0 * torch.log(torch.clamp(x, min=1e-12)) \
        - series - tail
    nu = torch.where(x <= 0.01, torch.exp(-0.583 * x), torch.exp(lnu))
    nu = nu.reshape(-1, n_grid)
    integ = st._integral_inv_t1t_sq(tls, dincr[:, None])
    out = _by_units(nu * nu * integ, st.MAX_GRID, (32,))
    return 2.0 * 9.973557e-2 * (b * b * b) \
        * torch.exp(-b * b / st._const(2.0, b)) * out


@pytest.mark.parametrize("n_grid", [1, 100, 128])
def test_tail_p_in_the_kernels_layout_equals_plain(n_grid):
    """tail_p_plain on a level's batch (dead, live and clamped rows) equals
    bit for bit its arithmetic redone in K11's layout on the card: the
    series by units of 256 terms with sqrt(k) and 2 / k from a table and
    the division by 2 a multiplication by 0.5, the Simpson points and the
    grid points in aligned runs."""
    b, n = _level_batch(R=12)
    bt, nt = torch.as_tensor(b), torch.as_tensor(n)
    want = st.tail_p_plain(bt, nt, 25, n_grid)
    got = _tail_p_as_the_kernel(bt, nt, 25, n_grid)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_halving_by_multiplication_equals_division():
    """x / 2 and x * 0.5 round alike in float64, subnormal results too:
    K11 multiplies where the plain version divides by 2."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(np.concatenate([
        rng.uniform(-1e3, 1e3, 10_000),
        rng.uniform(0, 1, 10_000) * 4.9e-324 * 2 ** rng.integers(0, 60,
                                                                10_000),
        [5e-324, 1e-323, 2.2250738585072014e-308, 1.7976931348623157e308]]))
    two = st._const(2.0, x)
    assert torch.equal((x * 0.5).view(torch.int64),
                       (x / two).view(torch.int64))


# --- K12 --------------------------------------------------------------------

def _perm_rows(npad, seed, S, full):
    """S centred rows f32 [S, npad] (lengths in (npad / 2, npad], at most
    150 for the full-arc statistic), their sums of squares and canvas_tpu's
    segment keys."""
    rng = np.random.default_rng(seed)
    hi = min(npad, 150) if full else npad
    n = rng.integers(min(hi, npad // 2 + 1), hi + 1, S)
    n = np.maximum(n, min(npad, 4))
    x = np.zeros((S, npad), np.float32)
    for r in range(S):
        v = rng.normal(0, 1, n[r]).astype(np.float32)
        v[: n[r] // 3] += 0.4
        x[r, :n[r]] = v - v.mean()
    tss = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    keys = jdev._seg_keys_np(11, np.arange(S), 7 * np.arange(S), n, 0)
    return x, n, tss, keys


@pytest.mark.parametrize("npad", [8, 64, 1024])
@pytest.mark.parametrize("P", [512, 768])
@pytest.mark.parametrize("full", [False, True])
def test_perm_stats_equals_canvas_tpu_perm_kernel(npad, P, full):
    """K12's plain version (_perm_stats on the masked rows) against
    canvas_tpu's _perm_kernel at the frontier's bucket widths and chunk
    sizes: the same threefry permutations, so the statistics agree up to
    canvas_tpu's float32 cumsum (the port's rounds a float64 one: rtol
    2e-4, as tests/test_torch_cbs.py); rows off the mask are zero."""
    S = 3
    x, n, tss, keys = _perm_rows(npad, npad + P + full, S, full)
    want = np.asarray(jdev._perm_kernel(
        jnp.asarray(x), jnp.asarray(n.astype(np.int32)), jnp.asarray(tss),
        jnp.asarray(keys), npad, P, AL0, 25, full))
    xt, nt, tsst = (torch.as_tensor(a) for a in (x, n, tss))
    kt = torch.as_tensor(keys.astype(np.int64))
    got = tdev._perm_stats(xt, nt, tsst, kt, npad, P, AL0, 25, full,
                           200 if full else npad)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)
    mask = torch.tensor([True, False, True])
    hybrid = torch.full((S,), not full)
    masked = mc.perm_stats(xt, nt, tsst, kt, mask, hybrid, P, AL0, 25, 200)
    assert torch.equal(masked[mask], got[mask])
    assert bool((masked[1] == 0).all())


# --- the wrappers' device rule ------------------------------------------------

def test_statistics_wrappers_raise_on_other_devices():
    """K9-K12's wrappers take CPU tensors (plain versions) and CUDA ones;
    any other device raises."""
    meta = torch.device("meta")
    cs, n, tss = (torch.as_tensor(a).to(meta) for a in _noise_rows(1, 64, 2))
    with pytest.raises(ValueError, match="device"):
        st.arc_inputs(cs, n, 64, AL0)
    with pytest.raises(ValueError, match="device"):
        st.arc_scan_inputs(cs, n, 64, AL0)
    i32 = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="device"):
        st.refine(cs, n, tss, i32, tss, i32, i32, i32, 64, AL0)
    with pytest.raises(ValueError, match="device"):
        st.tail_p(tss.double(), n, 25, 100)
    keys = torch.zeros((2, 2), dtype=torch.int64, device=meta)
    flags = torch.ones(2, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="device"):
        mc.perm_stats(cs, n.long(), tss, keys, flags, flags, 512, AL0, 25,
                      200)


# --- what K9's tiles and K12's groups on the card rest on -------------------

def _k9_as_the_kernel(cs, n, npad, al0, order):
    """arc_scan_inputs_plain's outputs computed as K9's blocks do: each
    tile of st.K9_TILE positions takes its first-index argmin and argmax
    over the row's real positions in it and its 256-position chunks'
    maxima and minima; the tiles' extrema are merged in the given order of
    tiles (the order they finish in) keeping the smaller index among equal
    values; then the seed, the split, lag_hi and psd2 from the merged
    extrema and the chunk-distance bounds."""
    B = cs.shape[0]
    T = min(npad, st.K9_TILE)
    tiles = st.arc_tiles(npad)
    C = min(st.BCHUNK, npad)
    nchunk = npad // C
    blk, _sub, nblk, _nsub = arc_scan_cuda.geometry(npad)
    inf = float("inf")
    seed = torch.empty(B, dtype=torch.float32)
    lag_hi = torch.empty(B, dtype=torch.int32)
    ti0 = torch.empty(B, dtype=torch.int32)
    tj0 = torch.empty(B, dtype=torch.int32)
    psd2 = torch.empty((B, nblk), dtype=torch.float32)
    for b in range(B):
        nv = min(max(int(n[b]), 0), npad)
        ext = []
        for k in range(tiles):
            seg = cs[b, k * T:(k + 1) * T]
            real = seg[:max(0, min(T, nv - k * T))]
            if len(real):
                ext.append((float(real.min()), k * T + int(real.argmin()),
                            float(real.max()), k * T + int(real.argmax())))
            else:
                ext.append((inf, 1 << 31, -inf, 1 << 31))
        vmin, imin, vmax, imax = inf, 1 << 31, -inf, 1 << 31
        for k in order[b]:
            a, ia, c, ic = ext[k]
            if a < vmin or (a == vmin and ia < imin):
                vmin, imin = a, ia
            if c > vmax or (c == vmax and ic < imax):
                vmax, imax = c, ic
        imin = 0 if imin == 1 << 31 else imin
        imax = 0 if imax == 1 << 31 else imax
        psdiff = cs[b, imax] - cs[b, imin]
        nf = torch.tensor(float(n[b]), dtype=torch.float32)
        rjs = torch.tensor(float(max(abs(imax - imin), 1)),
                           dtype=torch.float32)
        seed[b] = nf / (rjs * (nf - rjs)) * psdiff * psdiff \
            if psdiff > 0 else 0.0
        lag_hi[b] = min(int(n[b]) - al0, int(n[b]) - 1)
        ti0[b], tj0[b] = min(imin, imax) + 1, max(imin, imax) + 1
        chunks = cs[b].reshape(nchunk, C)
        M, m = chunks.amax(dim=1), chunks.amin(dim=1)
        by_db = torch.stack([torch.maximum(M[db:] - m[:nchunk - db],
                                           M[:nchunk - db] - m[db:]).amax()
                             for db in range(nchunk)])
        for k in range(nblk):
            lo = max(k * blk // C - 1, 0)
            hi = min((k * blk + blk - 1) // C + 1, nchunk - 1)
            d = torch.minimum(psdiff, by_db[lo:hi + 1].amax())
            psd2[b, k] = d * d
    return seed, lag_hi, psd2, ti0, tj0


def k9_tie_rows(seed, npad):
    """Integer random-walk cumsum rows f32 [6, npad] whose equal extrema
    lie in different tiles of K9 and on a tile's first and last position,
    with n not a multiple of the tile: (0) the maximum planted on every
    tile edge (last position of a tile, first of the next) and once inside
    tile 0, the minimum in every tile's middle and once inside tile 0; (1)
    the maximum on the edges after odd tiles and the minimum on those
    after even ones, so the first index of each lies on a tile's edge (in
    a row of one tile, two equal maxima and minima inside it); (2) larger
    and smaller values past n; (3) a constant row; rows of n = 1 and 0."""
    rng = np.random.default_rng(seed)
    T = min(npad, st.K9_TILE)
    tiles = npad // T
    cs = np.zeros((6, npad), np.float32)
    n = np.array([npad - 1, npad - 3, max(2, npad - T // 2 - 3), npad, 1, 0],
                 np.int64)
    walks = np.cumsum(rng.integers(-3, 4, (3, npad)), axis=1)
    for r in range(3):
        w = walks[r].astype(np.float32)
        top, low = w.max() + 5, w.min() - 5
        if r == 0:
            for k in range(1, tiles):
                w[k * T - 1] = w[k * T] = top
                w[k * T + T // 2] = low
            w[T // 3], w[T // 5] = top, low
        elif r == 1 and tiles > 1:
            for k in range(1, tiles):
                w[k * T - 1] = w[k * T] = top if k % 2 else low
        elif r == 1:
            w[T // 3] = w[T // 2] = top
            w[T // 5] = w[T // 4] = low
        cs[r] = w
    cs[2, n[2]:] = cs[2].max() + 7
    cs[2, n[2] + 1::2] = cs[2].min() - 7
    cs[3] = 3.0
    cs[4, 0] = -2.0
    cs[4, 1:] = 9.0
    return cs, n


@pytest.mark.parametrize("npad", [512, 4096, 32768, 65536])
def test_k9_tiles_and_last_tile_merge_equal_plain(npad):
    """K9's split of a row over tiles of 8,192 positions, each tile's
    first-index extrema and chunk extrema, and the merge by the row's last
    tile to finish (in any order of the tiles: forwards, backwards and
    shuffled) give arc_scan_inputs_plain's outputs, psd2 included
    (block_d2_bound), bit for bit, on rows whose extrema tie across
    tiles."""
    cs, n = k9_tie_rows(npad, npad)
    cst, nt = torch.as_tensor(cs), torch.as_tensor(n)
    want = st.arc_scan_inputs_plain(cst, nt, npad, AL0)
    tiles = st.arc_tiles(npad)
    assert tiles == max(1, npad // 8192)
    rng = np.random.default_rng(npad)
    for order in (list(range(tiles)), list(range(tiles))[::-1],
                  list(rng.permutation(tiles))):
        got = _k9_as_the_kernel(cst, n, npad, AL0, [order] * len(n))
        for a, b in zip(got, want):
            assert bits_equal(a, b)
    if tiles > 1:
        # row 1's first maximum is tile 0's last position, its first
        # minimum tile 1's last, each tied with the next tile's first
        T = st.K9_TILE
        assert (int(want[3][1]), int(want[4][1])) == (T, 2 * T)


def bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


PERM_WIDTHS = [1 << k for k in range(3, 17)]


@pytest.mark.parametrize("grid", [132, 66, 1])
def test_k12_group_rule(grid):
    """The mirror of K12's group rule (cbs_mega_cuda.perm_layout), at every
    bucket width from 8 to 65,536 and 1 x 512 to 1,024 x 768 items: never
    more groups than K7's layout of the width allows, every slice within
    K12's shared memory and at least what its buffers take, two buffers
    (the draws kept, one cipher call a position) wherever the slice holds
    them and always where they take the block's share in one round, the
    share in the fewest rounds its cap allows and by the fewest groups
    that take it in those rounds."""
    for npad in PERM_WIDTHS:
        cap7 = mc.layout(npad, False)["groups"]
        kd = 0 if npad >= mc.SLAB_TIER else min(
            cap7, mc._PERM_BUDGET // mc._double_bytes(npad))
        for rows in (1, 2, 33, 1024):
            for P in (512, 768):
                items = rows * P
                lay = mc.perm_layout(npad, items, grid)
                k = lay["groups"]
                assert 1 <= k <= cap7
                assert k * lay["bytes"] <= mc._PERM_BUDGET
                assert lay["bytes"] % 16 == 0
                two = npad < mc.SLAB_TIER \
                    and lay["double_bytes"] <= lay["bytes"]
                assert (lay["buffers"] == "shared, two buffers") == two
                assert lay["draws_a_position"] == (1 if two else 2)
                assert lay["staged"] == (two and npad >= mc.WIDE_ROW)
                share = -(-items // grid)
                if npad >= mc.SLAB_TIER:
                    assert lay["buffers"] == "device-memory slab"
                elif not two:
                    assert mc.layout(npad, False)["bytes"] <= lay["bytes"]
                if kd >= 1 and share <= kd:
                    assert two and k == share
                wide = kd >= 1 and (share <= kd
                                    or npad >= mc.WIDE_ROW)
                cap = kd if wide else cap7
                rounds = -(-share // cap)
                assert lay["rounds"] == rounds == -(-share // k)
                assert k == 1 or -(-share // (k - 1)) > rounds
