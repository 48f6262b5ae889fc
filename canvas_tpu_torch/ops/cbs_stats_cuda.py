"""The CBS level's statistics kernels (K9, K10, K11), with their plain torch
versions.

  arc_scan_inputs  (K9): what B4 (ops/arc_scan_cuda.py) takes besides the
                   cumsum cs f32 [B, npad]: per row the extrema seed, lag_hi,
                   the per-block bound psd2 on d^2 (block_d2_bound) and the
                   seed's 1-based split (ti0, tj0), from the first-index
                   argmin and argmax of cs over the row's n positions.
  refine           (K10): after B4, each winner's (ti, tj) inside its
                   32-lag sub-block (the running maximum over the lags keeps
                   the smallest lag a position, then the first maximal
                   position) and every row's t^2 from B4's best and tss.
  tail_p           (K11): the OU tail probability TailProbability.TailP of
                   a [R] float64 batch (hybrid delta = (kmax + 1) / n) over
                   a grid of n_grid points, nu(x) at each by 8,192 series
                   terms and a 129-point Simpson tail (nu_plain).
  tail_decide_launch (K11 carrying K14): for the whole-recursion engine's
                   level, K11 with b from the level's t2 and, in the same
                   launch, K14's decision rules from its p1
                   (cbs_level_cuda.tail_decide is the level's wrapper).

On CUDA tensors the wrappers launch csrc/cbs_stats.cu, one launch a call,
and count it in LAUNCHES; on CPU tensors they run the plain versions; any
other device raises.  For the whole-recursion engine's tiers, K9 and K10
take a row mask (the rows outside it return at once and are not
written; K10 writes the rows under it into the level's t2, ti, tj) and
read the cumsum's first npad columns of wider rows at their stride; K9,
K10 and K11 take the engine's live flag, every block returning at once
where it is 0.  K9 and K10 spread a row over thread blocks (K9:
tiles of K9_TILE positions), the row's last block to finish writing its
result; K11 is one cooperative launch whose blocks share the live grid
points' series.  Each CUDA device keeps their counters (K9's and K10's a
row, K11's two), K10's row keys and K9's scratch, the counters zeroed
once and left zero by every launch, so calls on one device run on one
stream at a time, and K11's table of sqrt(k) and 2 / k and its grids (made
at the device's first call).  K9 and K10 round every f32
operation as their plain versions do and take maxima, minima and first
indices exactly, so they are equal bit for bit.  The plain tail
probability fixes its arithmetic: every division by a constant divides by
a 0-dim tensor on the batch's device (so it is IEEE division on every
device; torch's CUDA division by a Python scalar multiplies by the
reciprocal), and every sum is an adjacent-pair tree (_tree_sum: a
2,048-term chunk of the series, the 129 Simpson points padded to 256, the
grid points padded to 128), the series' chunks added in order.  K11
repeats that arithmetic with the CUDA math library's erfc, exp, log and
sqrt, which torch's CUDA operators call too, so on the card it equals the
plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from canvas_tpu_torch.ops import arc_scan_cuda, cuda_lib

BCHUNK = 256            # position-chunk width of the per-block d^2 bound
NU_SERIES_TERMS = 8192
NU_SERIES_CHUNK = 2048  # the series terms a tree sums
NU_TAIL_PANELS = 128
NU_TAIL_SLOTS = 256     # the Simpson points' tree, zero-padded
MAX_GRID = 128          # grid points K11 takes a row, the grid's tree
_NU_BATCH = 4096        # x values a [batch, 2048] series block (plain)

_NU_PARTS = 40          # K11's partial sums a live grid point: 32 units
                        # of 256 series terms, 8 runs of 32 Simpson slots
_MIN_ROWS = 1024        # rows the per-device counters hold at least
K9_TILE = 8192          # K9's positions a thread block
_K9_EXT_WORDS = 4       # a tile's extrema: vmin, vmax, imin, imax

# launches of the kernels, counted by the wrappers (tail_decide: K11
# carrying K14, the whole-recursion engine's)
LAUNCHES = {"arc_inputs": 0, "refine": 0, "tail_p": 0, "tail_decide": 0}

# per CUDA device: {"table", "grid", "grid_decide", "count", "key",
# "k9_count", "k9_ext", "k9_chunk", "rows"} (_device_state)
_STATE: dict = {}
_STATE_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cbs_arc_inputs": [_P, _P, _I] + [_P] * 9 + [_I] * 4 + [_P] * 3,
    "cbs_refine": [_P, _P, _I] + [_P] * 11 + [_I] * 4 + [_P] * 3,
    "cbs_tail_table": [_P, _P],
    "cbs_tail_grid": [_I, _P],
    "cbs_tail_p": [_P, _P, _I] + [_P] * 6 + [_I] * 4 + [_P] * 2,
    "cbs_tail_decide": [_P, _I] + [_P] * 18 + [ctypes.c_longlong]
                       + [_I] * 5 + [_P] * 2,
    "cbs_series_term": [_P, _P, _P, _I, _P],
    "cbs_erfc": [_P, _P, _I, _P],
}


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-dim tensor of like's dtype and device: dividing by it is
    IEEE division on every device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def block_d2_bound(cs, psdiff, npad, sblk):
    """[B, nblk] upper bound on d^2 = (cs[j] - cs[i])^2 over pairs with
    lag j - i inside each sblk-lag block.

    Chunk the position axis at BCHUNK; with M/m the per-chunk max/min of
    the cumsum, any pair at chunk distance db satisfies
    |d| <= max(M[a+db] - m[a], M[a] - m[a+db]).  A lag block only reaches
    chunk distances around lag/BCHUNK, so its bound is the max over that
    small db range — far tighter than the global cumsum range for noise
    (local range ~ sqrt(lag) vs sqrt(n)), which is what lets the arc scan
    skip the mid-lag blocks the psdiff bound always over-admits.
    Pad positions enter the chunk extrema unmasked: extra values only
    widen M - m, so the bound stays valid."""
    B = cs.shape[0]
    dev = cs.device
    nblk = max(npad // sblk, 1)
    C = min(BCHUNK, npad)
    nchunk = npad // C
    csr = cs.reshape(B, nchunk, C)
    M = csr.amax(dim=2)
    m = csr.amin(dim=2)
    # the max of M[c] - m[a] over chunk pairs at each distance |c - a|
    a = torch.arange(nchunk, device=dev)
    dist = (a[None, :] - a[:, None]).abs().reshape(1, -1).expand(B, -1)
    pair = (M[:, None, :] - m[:, :, None]).reshape(B, -1)
    by_db = torch.full((B, nchunk), -torch.inf, dtype=cs.dtype, device=dev)
    by_db = by_db.scatter_reduce(1, dist, pair, reduce="amax")
    # each block takes the max over its reachable chunk distances, those
    # from (first lag // C) - 1 to (last lag // C) + 1 (made on the device:
    # a copy from the host would wait for the stream)
    k = torch.arange(nblk, device=dev)[:, None]
    db_lo = torch.clamp(k * sblk // C - 1, min=0)
    db_hi = torch.clamp((k * sblk + sblk - 1) // C + 1, max=nchunk - 1)
    reach = (a[None, :] >= db_lo) & (a[None, :] <= db_hi)
    bnd = torch.where(reach[None], by_db[:, None, :], -torch.inf).amax(dim=2)
    d = torch.minimum(psdiff[:, None], bnd)
    return (d * d).to(torch.float32)


def arc_scan_inputs_plain(cs, n, npad, al0):
    """Plain version of K9: (seed, lag_hi, psd2, ti0, tj0) of the rows of
    the cumsum cs f32 [B, npad] with n real positions."""
    blk = arc_scan_cuda.geometry(npad)[0]
    big = torch.finfo(torch.float32).max
    valid = torch.arange(npad, device=cs.device)[None, :] < n[:, None]
    imin = torch.argmin(torch.where(valid, cs, big), dim=1)
    imax = torch.argmax(torch.where(valid, cs, -big), dim=1)
    cmin = cs.gather(1, imin[:, None])[:, 0]
    cmax = cs.gather(1, imax[:, None])[:, 0]
    psdiff = cmax - cmin
    nf = n.to(torch.float32)
    rjs = torch.clamp((imax - imin).abs(), min=1).to(torch.float32)
    seed = torch.where(psdiff > 0, nf / (rjs * (nf - rjs)) * psdiff * psdiff,
                       0.0)
    lag_hi = torch.minimum(n - al0, n - 1).to(torch.int32)
    psd2 = block_d2_bound(cs, psdiff, npad, blk)
    ti0 = (torch.minimum(imin, imax) + 1).to(torch.int32)
    tj0 = (torch.maximum(imin, imax) + 1).to(torch.int32)
    return seed, lag_hi, psd2, ti0, tj0


def refine_plain(cs, n, tss, lag_hi, best, bl0, ti0, tj0, npad, al0):
    """Plain version of K10: (t^2 f32, ti, tj int32) [B] from B4's (best,
    bl0).  Recover (ti, tj) inside each winner's sub-block: the running max
    over its lags keeps the SMALLEST lag per position, and the per-row
    argmax takes the first max position.  A row that never beat its
    extrema seed (bl0 = -1) keeps the seed's split (ti0, tj0)."""
    B = cs.shape[0]
    dev = cs.device
    sub = arc_scan_cuda.geometry(npad)[1]
    pos = torch.arange(npad, device=dev)
    nf = n.to(torch.float32)
    hit = bl0 >= 0
    b0c = torch.clamp(bl0, min=0).to(torch.int64)
    cs2 = torch.cat([cs, torch.zeros_like(cs)], dim=1)
    base = cs2.gather(
        1, b0c[:, None] + torch.arange(npad + sub, device=dev)[None, :])
    val = torch.full((B, npad), -1.0, dtype=torch.float32, device=dev)
    lagk = torch.zeros((B, npad), dtype=torch.int64, device=dev)
    for k in range(sub):
        lag = b0c + k
        lag_ok = (lag >= al0) & (lag <= lag_hi)
        d = base[:, k:k + npad] - cs
        ok = lag_ok[:, None] & (pos[None, :] + lag[:, None]
                                <= n[:, None] - 1)
        lf = torch.clamp(lag, min=1).to(torch.float32)
        w = (nf / (lf * (nf - lf)))[:, None]
        v = torch.where(ok, w * d * d, -1.0)
        upd = v > val
        val = torch.where(upd, v, val)
        lagk = torch.where(upd, k, lagk)
    flat_i = torch.argmax(val, dim=1)
    sel_lag = b0c + lagk.gather(1, flat_i[:, None])[:, 0]
    ti = torch.where(hit, flat_i + 1, ti0).to(torch.int32)
    tj = torch.where(hit, flat_i + sel_lag + 1, tj0).to(torch.int32)
    tssv = torch.where(tss <= best + 1e-4, best + 1.0, tss)
    t2 = best / ((tssv - best) / torch.clamp(nf - 2.0, min=1.0))
    return t2, ti, tj


def _tree_sum(v: torch.Tensor, slots: int) -> torch.Tensor:
    """The sum over the last axis as an adjacent-pair tree over `slots` (a
    power of two, at least the axis' length) slots, zero past the values:
    slots (0, 1), (2, 3), ..., then pairs of those, and so on."""
    v = torch.nn.functional.pad(v, (0, slots - v.shape[-1]))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def nu_plain(x):
    """TailProbability.Nu over a flat vector, in the dtype of x: 8,192
    exact series terms in 4 chunks + the Euler-Maclaurin integral tail by
    Simpson's rule (cbs_device's module note).  Each chunk's terms sum as
    a tree, the chunks in order."""
    dev, dt = x.device, x.dtype
    K = NU_SERIES_CHUNK
    two, sqrt2 = _const(2.0, x), _const(float(np.sqrt(2.0)), x)
    series = torch.empty_like(x)
    for s0 in range(0, x.shape[0], _NU_BATCH):
        xs = x[s0:s0 + _NU_BATCH, None]
        acc = None
        for c in range(NU_SERIES_TERMS // K):
            k = (c * K + torch.arange(1, K + 1, device=dev)).to(dt)
            # the term ndtr(-x sqrt(k) / 2) (2 / k)
            z = xs * torch.sqrt(k)[None, :] / two / sqrt2
            t = torch.special.erfc(z) * 0.5 * (two / k)[None, :]
            s = _tree_sum(t, K)
            acc = s if acc is None else acc + s
        series[s0:s0 + _NU_BATCH] = acc
    # tail: sum_{t>D} 2*ndtr(-x*sqrt(t)/2)/t ~= int_{D+1/2}^inf (midpoint EM)
    #     = 4 * int_{x*sqrt(D+0.5)/2}^inf ndtr(-u)/u du   (u = x*sqrt(t)/2)
    v0c = torch.clamp(x * float(np.sqrt(NU_SERIES_TERMS + 0.5)) / two,
                      max=9.0)
    h = (9.0 - v0c) / _const(NU_TAIL_PANELS, x)
    j = torch.arange(NU_TAIL_PANELS + 1, device=dev)
    u = v0c[:, None] + h[:, None] * j.to(dt)[None, :]
    f = 0.5 * torch.special.erfc(u / sqrt2) / torch.clamp(u, min=1e-12)
    # Simpson weights 1, 4, 2, 4, ..., 2, 4, 1
    simp = torch.where((j == 0) | (j == NU_TAIL_PANELS), 1.0,
                       torch.where(j % 2 == 1, 4.0, 2.0)).to(dt)
    tail = 4.0 * (h / _const(3.0, x)) * _tree_sum(f * simp[None, :],
                                                  NU_TAIL_SLOTS)
    lnu = float(np.log(2.0)) - 2.0 * torch.log(torch.clamp(x, min=1e-12)) \
        - series - tail
    return torch.where(x <= 0.01, torch.exp(-0.583 * x), torch.exp(lnu))


def _integral_inv_t1t_sq(tl, a):
    def f(y):
        return (8.0 * y / (1.0 - 4.0 * y * y)
                + 2.0 * torch.log((1 + 2 * y) / (1 - 2 * y)))
    return f(tl + a - 0.5) - f(tl - 0.5)


def tail_p_plain(b, n, kmax: int, n_grid: int):
    """Plain version of K11: TailProbability.TailP for a [R] batch b at n
    bins (hybrid delta = (kmax + 1) / n), in the dtype of b; the grid
    points' terms sum as a tree over MAX_GRID slots."""
    dt = b.dtype
    nf = n.to(dt)
    delta = torch.clamp(_const(kmax + 1.0, b) / nf, 0.0, 0.45)
    dincr = (0.5 - delta) / _const(n_grid, b)                # [R]
    i = torch.arange(n_grid, device=b.device).to(dt)[None, :]
    tls = 0.5 + i * dincr[:, None]
    ts = 0.5 + (i + 0.5) * dincr[:, None]
    bsqrtm = b / torch.sqrt(nf)
    xg = bsqrtm[:, None] / torch.sqrt(ts * (1 - ts))        # [R, n_grid]
    nus = nu_plain(xg.reshape(-1)).reshape(xg.shape)
    integ = _integral_inv_t1t_sq(tls, dincr[:, None])
    out = _tree_sum(nus * nus * integ, MAX_GRID)
    return 2.0 * 9.973557e-2 * (b * b * b) \
        * torch.exp(-b * b / _const(2.0, b)) * out


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _device_of(t: torch.Tensor, name: str) -> str:
    """"cpu" or "cuda"; any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _check_rows(name, n, B, dev) -> int:
    """Raise unless n is a contiguous int32 or int64 CUDA tensor [B] on
    dev; returns 1 for int64."""
    if n.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} must be int32 or int64, got {n.dtype}")
    cuda_lib.require_cuda_tensor(name, n, n.dtype, dev)
    if tuple(n.shape) != (B,):
        raise ValueError(f"{name} must be [{B}], got {list(n.shape)}")
    return int(n.dtype == torch.int64)


def _check_vec(name, x, dtype, B, dev) -> None:
    cuda_lib.require_cuda_tensor(name, x, dtype, dev)
    if tuple(x.shape) != (B,):
        raise ValueError(f"{name} must be [{B}], got {list(x.shape)}")


def _check_cs(cs, npad) -> tuple[int, torch.device, int]:
    """(rows, device, row stride) of cs [B, npad], whose rows may be the
    first npad columns of wider ones."""
    if cs.dim() != 2 or cs.shape[1] != npad:
        raise ValueError(f"cs must be [B, {npad}], got {tuple(cs.shape)}")
    if npad < 1 or npad & (npad - 1):
        raise ValueError(f"npad must be a power of two, got {npad}")
    ld = cuda_lib.require_cuda_rows("cs", cs, torch.float32)
    return cs.shape[0], cs.device, ld


def _check_gate(mask, live, B, dev) -> None:
    """Raise unless mask (bool [B]) and live (an int64 scalar) are None or
    on dev."""
    if mask is not None:
        _check_vec("mask", mask, torch.bool, B, dev)
    if live is not None:
        cuda_lib.require_cuda_tensor("live", live, torch.int64, dev)
        if live.dim() != 0:
            raise ValueError("live must be a scalar")


def _masked_rows(mask, B: int):
    """The rows under mask on the CPU (every row where mask is None)."""
    return slice(None) if mask is None else torch.nonzero(mask)[:, 0]


def arc_tiles(npad: int) -> int:
    """K9's thread blocks a row of width npad: tiles of K9_TILE
    positions, one where the row is narrower."""
    return max(1, npad // K9_TILE)


def arc_inputs(cs, n, npad: int, al0: int, mask=None, live=None):
    """K9, and n as int32 beside its outputs for B4: (seed f32, lag_hi
    int32, psd2 f32 [B, nblk], ti0, tj0, n32 int32) for the cumsum cs f32
    [B, npad] (npad a power of two up to 65,536; on the card 16-byte
    aligned; its rows may be the first npad columns of wider rows, a
    multiple of 4 floats apart) and n int32 or int64 [B].  With mask (bool
    [B]) only the rows under it are computed, the others' outputs left
    unset (on the card their blocks return at once); live (an int64 scalar
    on the card, may be None): where it is 0 every block returns at once.
    On CPU tensors live is not read."""
    if _device_of(cs, "arc_scan_inputs") == "cpu":
        if mask is None:
            return (*arc_scan_inputs_plain(cs, n, npad, al0),
                    n.to(torch.int32))
        B = cs.shape[0]
        nblk = arc_scan_cuda.geometry(npad)[2]
        out = (torch.zeros(B), torch.full((B,), -1, dtype=torch.int32),
               torch.zeros((B, nblk)), torch.ones(B, dtype=torch.int32),
               torch.ones(B, dtype=torch.int32), n.to(torch.int32))
        rows = _masked_rows(mask, B)
        if len(rows):
            for o, v in zip(out, arc_scan_inputs_plain(cs[rows], n[rows],
                                                       npad, al0)):
                o[rows] = v
        return out
    B, dev, ld = _check_cs(cs, npad)
    n64 = _check_rows("n", n, B, dev)
    _check_gate(mask, live, B, dev)
    if npad > 65536:
        raise ValueError(f"npad must be at most 65536, got {npad}")
    if cs.data_ptr() % 16 or ld % 4:
        raise ValueError("cs must be 16-byte aligned, its rows too")
    nblk = arc_scan_cuda.geometry(npad)[2]
    seed = torch.empty(B, dtype=torch.float32, device=dev)
    lag_hi, ti0, tj0, n32 = (torch.empty(B, dtype=torch.int32, device=dev)
                             for _ in range(4))
    psd2 = torch.empty((B, nblk), dtype=torch.float32, device=dev)
    state = _device_state(dev, B)
    lib = cuda_lib.load("cbs_stats", _SIGNATURES)
    status = cuda_lib.launch(
        dev, lib.cbs_arc_inputs, cs.data_ptr(), n.data_ptr(), n64,
        state["k9_ext"].data_ptr(), state["k9_chunk"].data_ptr(),
        state["k9_count"].data_ptr(), seed.data_ptr(), lag_hi.data_ptr(),
        ti0.data_ptr(), tj0.data_ptr(), n32.data_ptr(), psd2.data_ptr(), B,
        npad, al0, ld, cuda_lib.ptr(mask), cuda_lib.ptr(live))
    cuda_lib.check(status, "cbs_arc_inputs")
    LAUNCHES["arc_inputs"] += 1
    return seed, lag_hi, psd2, ti0, tj0, n32


def arc_scan_inputs(cs, n, npad: int, al0: int):
    """K9: what B4 takes besides cs, per row of the cumsum cs f32 [B,
    npad]: (seed, lag_hi, psd2), plus the 1-based split (ti0, tj0) of the
    extrema pair that the seed scores."""
    return arc_inputs(cs, n, npad, al0)[:5]


def _device_state(dev: torch.device, rows: int) -> dict:
    """The CUDA device's K11 series table (float64 [8,192 x 2], made on the
    card at its first call) and K11's cooperative grids (grid, and
    grid_decide for the variant that carries K14), and for at least
    `rows` rows, grown to a power of two: zeroed row counters (int32; K11
    counts in the first two) and K10 row keys (int64), K9's own zeroed row
    counters and its scratch of tile extrema and chunk extrema (8 tiles
    and 256 chunks a row, the most a width of 65,536 has)."""
    with _STATE_LOCK:
        state = _STATE.get(dev)
        if state is None:
            lib = cuda_lib.load("cbs_stats", _SIGNATURES)
            table = torch.empty(2 * NU_SERIES_TERMS, dtype=torch.float64,
                                device=dev)
            cuda_lib.check(cuda_lib.launch(dev, lib.cbs_tail_table,
                                           table.data_ptr()),
                           "cbs_tail_table")
            grids = []
            for decide in (0, 1):
                grid = ctypes.c_int(0)
                with torch.cuda.device(dev):
                    cuda_lib.check(lib.cbs_tail_grid(decide,
                                                     ctypes.byref(grid)),
                                   "cbs_tail_grid")
                grids.append(grid.value)
            state = _STATE[dev] = {"table": table, "grid": grids[0],
                                   "grid_decide": grids[1], "rows": 0}
        if state["rows"] < rows:
            # a captured CUDA graph may hold the smaller buffers: they are
            # kept, never freed for reuse
            state.setdefault("retired", []).append(
                [state.get(k) for k in ("count", "key", "k9_count",
                                        "k9_ext", "k9_chunk")])
            cap = max(_MIN_ROWS, 1 << (rows - 1).bit_length())
            state["count"] = torch.zeros(cap, dtype=torch.int32, device=dev)
            state["key"] = torch.zeros(cap, dtype=torch.int64, device=dev)
            state["k9_count"] = torch.zeros(cap, dtype=torch.int32,
                                            device=dev)
            state["k9_ext"] = torch.empty(
                cap * arc_tiles(65536) * _K9_EXT_WORDS, dtype=torch.int32,
                device=dev)
            state["k9_chunk"] = torch.empty(cap * (65536 // BCHUNK) * 2,
                                            dtype=torch.float32, device=dev)
            state["rows"] = cap
        return state


def refine(cs, n, tss, lag_hi, best, bl0, ti0, tj0, npad: int, al0: int,
           mask=None, out=None, live=None):
    """K10: (t^2 f32, ti, tj int32) [B] of the rows of cs f32 [B, npad]
    (rows as for arc_inputs) with n int32 or int64, tss f32, K9's lag_hi,
    ti0, tj0 and B4's best f32 and bl0 int32.  With mask (bool [B]) only
    the rows under it are computed, and with out (t2, ti, tj) the results
    go into those tensors, the other rows' entries untouched; live as for
    arc_inputs."""
    if _device_of(cs, "refine") == "cpu":
        if mask is None and out is None:
            return refine_plain(cs, n, tss, lag_hi, best, bl0, ti0, tj0,
                                npad, al0)
        B = cs.shape[0]
        out = out or (torch.zeros(B), torch.ones(B, dtype=torch.int32),
                      torch.full((B,), 2, dtype=torch.int32))
        rows = _masked_rows(mask, B)
        if len(out[0][rows]):
            args = [a[rows] for a in (cs, n, tss, lag_hi, best, bl0, ti0,
                                      tj0)]
            for o, v in zip(out, refine_plain(*args, npad, al0)):
                o[rows] = v
        return out
    B, dev, ld = _check_cs(cs, npad)
    n64 = _check_rows("n", n, B, dev)
    for name, x, dt in (("tss", tss, torch.float32),
                        ("lag_hi", lag_hi, torch.int32),
                        ("best", best, torch.float32),
                        ("bl0", bl0, torch.int32),
                        ("ti0", ti0, torch.int32), ("tj0", tj0, torch.int32)):
        _check_vec(name, x, dt, B, dev)
    _check_gate(mask, live, B, dev)
    if out is None:
        out = (torch.empty(B, dtype=torch.float32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev))
    for name, x, dt in zip(("t2", "ti", "tj"), out,
                           (torch.float32, torch.int32, torch.int32)):
        _check_vec(name, x, dt, B, dev)
    t2, ti, tj = out
    state = _device_state(dev, B)
    lib = cuda_lib.load("cbs_stats", _SIGNATURES)
    status = cuda_lib.launch(
        dev, lib.cbs_refine, cs.data_ptr(), n.data_ptr(), n64,
        tss.data_ptr(), lag_hi.data_ptr(), best.data_ptr(), bl0.data_ptr(),
        ti0.data_ptr(), tj0.data_ptr(), state["key"].data_ptr(),
        state["count"].data_ptr(), t2.data_ptr(), ti.data_ptr(),
        tj.data_ptr(), B, npad, al0, ld, cuda_lib.ptr(mask),
        cuda_lib.ptr(live))
    cuda_lib.check(status, "cbs_refine")
    LAUNCHES["refine"] += 1
    return t2, ti, tj


def tail_p(b, n, kmax: int, n_grid: int, live=None):
    """K11: the tail probabilities float64 [R] of b float64 [R] at n int32
    or int64 [R] bins over n_grid <= MAX_GRID grid points.  live (an int64
    scalar on the card, may be None): where it is 0 every block returns at
    once and nothing is written; on CPU tensors it is not read."""
    if _device_of(b, "tail_p") == "cpu":
        return tail_p_plain(b, n, kmax, n_grid)
    if b.dim() != 1:
        raise ValueError(f"b must be [R], got {tuple(b.shape)}")
    if not 1 <= n_grid <= MAX_GRID:
        raise ValueError(f"n_grid must be in [1, {MAX_GRID}], got {n_grid}")
    R, dev = b.shape[0], b.device
    cuda_lib.require_cuda_tensor("b", b, torch.float64)
    n64 = _check_rows("n", n, R, dev)
    _check_gate(None, live, R, dev)
    p = torch.empty(R, dtype=torch.float64, device=dev)
    xs = torch.empty(R * n_grid, dtype=torch.float64, device=dev)
    points = torch.empty(R * n_grid, dtype=torch.int32, device=dev)
    part = torch.empty(R * n_grid * _NU_PARTS, dtype=torch.float64,
                       device=dev)
    state = _device_state(dev, 1)
    lib = cuda_lib.load("cbs_stats", _SIGNATURES)
    status = cuda_lib.launch(dev, lib.cbs_tail_p, b.data_ptr(), n.data_ptr(),
                             n64, state["table"].data_ptr(), xs.data_ptr(),
                             points.data_ptr(), part.data_ptr(),
                             state["count"].data_ptr(), p.data_ptr(), R,
                             kmax, n_grid, state["grid"], cuda_lib.ptr(live))
    cuda_lib.check(status, "cbs_tail_p")
    LAUNCHES["tail_p"] += 1
    return p


def tail_decide_launch(rows: dict, n_eff, alpha, kmax: int, n_grid: int,
                       n_perm: int, n_min: int, live) -> None:
    """K11 carrying K14 on CUDA tensors, one cooperative launch: the tail
    probability p1 float64 of b = sqrt(max(t2, 0)) at n_eff int64 [R]
    bins, and from it K14's rules.  rows holds [R] tensors: the inputs t2
    f32, ti, tj int32, n int64 and analyzable bool, and the outputs,
    written in place, b and p1 float64, ostat f32, hybrid, needs and
    trivial bool, nrejc int64; alpha is an f32 scalar, live the engine's
    int64 scalar (where it is 0 every block returns at once and nothing is
    written).  The level's wrapper is cbs_level_cuda.tail_decide."""
    R, dev = n_eff.shape[0], n_eff.device
    if not 1 <= n_grid <= MAX_GRID:
        raise ValueError(f"n_grid must be in [1, {MAX_GRID}], got {n_grid}")
    _check_vec("n_eff", n_eff, torch.int64, R, dev)
    for name, dt in (("t2", torch.float32), ("ti", torch.int32),
                     ("tj", torch.int32), ("n", torch.int64),
                     ("analyzable", torch.bool), ("b", torch.float64),
                     ("p1", torch.float64), ("ostat", torch.float32),
                     ("hybrid", torch.bool), ("needs", torch.bool),
                     ("trivial", torch.bool), ("nrejc", torch.int64)):
        _check_vec(name, rows[name], dt, R, dev)
    cuda_lib.require_cuda_tensor("alpha", alpha, torch.float32, dev)
    _check_gate(None, live, R, dev)
    if live is None or alpha.dim() != 0:
        raise ValueError("alpha and live must be scalars")
    xs = torch.empty(R * n_grid, dtype=torch.float64, device=dev)
    points = torch.empty(R * n_grid, dtype=torch.int32, device=dev)
    part = torch.empty(R * n_grid * _NU_PARTS, dtype=torch.float64,
                       device=dev)
    state = _device_state(dev, 1)
    lib = cuda_lib.load("cbs_stats", _SIGNATURES)
    status = cuda_lib.launch(
        dev, lib.cbs_tail_decide, n_eff.data_ptr(), 1,
        state["table"].data_ptr(), xs.data_ptr(), points.data_ptr(),
        part.data_ptr(), state["count"].data_ptr(), rows["p1"].data_ptr(),
        *(rows[k].data_ptr() for k in ("t2", "ti", "tj", "n", "analyzable")),
        alpha.data_ptr(),
        *(rows[k].data_ptr() for k in ("b", "ostat", "hybrid", "needs",
                                       "trivial", "nrejc")),
        min(int(n_min), 1 << 62), n_perm, R, kmax, n_grid,
        state["grid_decide"], live.data_ptr())
    cuda_lib.check(status, "cbs_tail_decide")
    LAUNCHES["tail_decide"] += 1


def device_series_terms(x):
    """Series term k = i % 8,192 + 1 of nu(x[i]) as K11 computes it, from
    its table, on x float64 [count] on a CUDA device, for tests."""
    cuda_lib.require_cuda_tensor("x", x, torch.float64)
    out = torch.empty_like(x)
    table = _device_state(x.device, 0)["table"]
    lib = cuda_lib.load("cbs_stats", _SIGNATURES)
    status = cuda_lib.launch(x.device, lib.cbs_series_term, x.data_ptr(),
                             table.data_ptr(), out.data_ptr(), x.numel())
    cuda_lib.check(status, "cbs_series_term")
    return out


def device_erfc(x):
    """The math library's erfc as K11 calls it, on x float64 [count] on a
    CUDA device, for tests."""
    cuda_lib.require_cuda_tensor("x", x, torch.float64)
    out = torch.empty_like(x)
    lib = cuda_lib.load("cbs_stats", _SIGNATURES)
    status = cuda_lib.launch(x.device, lib.cbs_erfc, x.data_ptr(),
                             out.data_ptr(), x.numel())
    cuda_lib.check(status, "cbs_erfc")
    return out
