"""The whole-recursion CBS engine's walk and edge-test kernels (K7, K8),
with their plain torch versions.

  walk          (K7): the level's sequential-stopping boundary walks
                (ChangePoint.cs:206-246).  Every walking row loops over
                permutation chunks of P_CHUNK until it is decided: chunk c
                draws from fold_in(key, c), key the row's seg_keys chain
                of the level key, the [P_CHUNK, npad] uniforms of
                the row's tier width npad (the smallest power of two >=
                1,024 that holds n), permutes the row's values by a stable
                sort of them (padding draws 2.0 and sorts last), takes the
                f32 cumsum (accumulated in float64), the max-t statistic
                (hybrid: lags al0..kmax with wrap arcs, n > n_min; full:
                every lag up to min(n_min, npad)) and feeds the P_CHUNK
                statistics through the boundary walk (_walk_update).
                Returns (accepted bool [W], chunks int64 [W]).
  edge_counts   (K8): the split-location edge tests (TPermP,
                ChangePoint.cs:359-398).  Every active lane loops over
                chunks: from fold_in(ekey, cnt), ekey its edge_keys chain
                of the level key, the [P_CHUNK, npad] uint32
                keys of its tier width, the subset of its m1 smallest keys
                (ties by index) summed in float64, the statistic
                |sum / m1 - xbar| against ostat on the first
                n_perm - done permutations, until the count exceeds limit
                or n_perm permutations are done.  Returns (count int64
                [L], cnt int64 [L]).
  perm_stats    (K12): the frontier engine's permutation chunks
                (cbs_device's _level and _walk_pending): for each row under
                a mask, one chunk of P permutations (512 or 768) under the
                row's given threefry key at its bucket's own width npad (8
                to 65,536), with K7's permutation, cumsum and statistic
                code; f32 [S, P], zero on the other rows.  Its plain
                version is cbs_device._perm_stats on the masked rows.
                The kernel sizes its groups from the launch's items on
                the card; perm_layout mirrors that rule.

Each row (lane) is decided by its own chunk sequence alone, so the order
in which rows draw their chunks does not matter: canvas_tpu's compaction
of 8 rows an iteration, the plain versions' loop over one row at a time
and the kernels' rows in parallel give the same results.  The plain
versions read their loop tests from the tensors (on the card, a read
each); the kernels keep every loop on the card.

On CUDA tensors the wrappers launch csrc/cbs_mega.cu, one launch a call
(K12: one a call of up to MAX_ROWS rows; K7 and K8 cooperative, with the
launch attribute a CUDA graph's capture keeps, and the whole-recursion
engine's live flag, every block returning at once where it is 0), and
the launch counts go to LAUNCHES; on CPU tensors they run the plain
versions.  The kernels derive every key on the card; the plain versions
run the same fold_in chains through ops/threefry.py (seg_keys,
edge_keys), so both take the level key and the rows' (contig, start,
length).  Both draw the same threefry bits (ops/threefry.py), sort and
select exactly, and round every f32 operation of the statistics as the
plain versions do, so flags, counts and statistics agree bit for bit
wherever their float64 sums round to the same f32 (the kernels add in
another order; see the source note).
"""

from __future__ import annotations

import ctypes

import torch

# cbs_device imports this module for K12: its names are read at call time
from canvas_tpu_torch.ops import cbs_device, cuda_lib, threefry

P_CHUNK = 512          # permutations per chunk
MAX_ROWS = 1024        # rows (lanes) a launch
SLAB_TIER = 65536      # tiers whose buffers live in device memory
EDGE_DEPTH = 4         # K8: chunks a lane may take in one iteration
EDGE_TAG = 7777        # edge e of a row folds in EDGE_TAG + e - 1

# launches of the kernels, counted by the wrappers
LAUNCHES = {"walk": 0, "edge": 0, "perm": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cbs_walk": [_P] * 17 + [_I] * 8 + [_P] * 2,
    "cbs_edge": [_P] * 17 + [_I] * 5 + [_P] * 2,
    "cbs_threefry": [_P] * 2 + [_I, ctypes.c_longlong, _I] + [_P] * 3
    + [_P],
    "cbs_keys": [_P] * 4 + [_I] * 3 + [_P] * 2 + [_P],
    "cbs_perm": [_P] * 8 + [_I] * 7 + [_P],
    "cbs_grid": [_I, _P],
    "cbs_layout": [_I, _I, _P],
    "cbs_perm_layout": [_I, _I, _I, _P],
}

# csrc/cbs_mega.cu's shared-memory plan, mirrored for layout() and
# perm_layout() (the card tests hold them equal to the source's)
_THREADS = 1024
_WARPS = _THREADS // 32
_SMEM = 232448             # 227 KB, the most a block can have
_MAX_GROUPS = 8
_LAG_TILE = 256
_DIGIT_BINS = 2048
_MODES = ("shared, two buffers", "shared, one buffer", "device-memory slab")
_DOUBLE, _SINGLE, _SLAB = 0, 1, 2


def _align16(b: int) -> int:
    return (b + 15) & ~15


_HEAD7_LAG = _align16((_WARPS + 1) * 8 + (_WARPS + 1) * 4 + 16)
_HEAD7 = _HEAD7_LAG + _LAG_TILE * 4
_FIXED = _align16(MAX_ROWS * 8 + 2 * MAX_ROWS * 4 + (_WARPS + 1) * 4
                  + MAX_ROWS)
_BUDGET = _SMEM - _FIXED
_PERM_FIXED = _align16(MAX_ROWS * 2 + (_WARPS + 1) * 4)
_PERM_BUDGET = _SMEM - _PERM_FIXED


def _fsum(v: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis, accumulated in float64."""
    return v.double().sum(dim=-1).float()


def seg_keys(key0, seg_c, seg_lo, n):
    """[R, 2] threefry keys of R rows from the level key key0 ([2]):
    fold_in(fold_in(fold_in(key0, c), lo), n) of each row's contig c,
    start lo and length n (int64 [R]), canvas_tpu's _seg_keys."""
    k = threefry.fold_in(key0, seg_c)
    k = threefry.fold_in(k, seg_lo)
    return threefry.fold_in(k, n)


def edge_keys(key0, seg_c, seg_lo, seg_n, L: int):
    """[L, 2] edge-test keys of L = e R lanes over R rows: lane l tests
    edge l // R + 1 of row l % R, under fold_in(seg_keys(row), EDGE_TAG +
    l // R)."""
    k = seg_keys(key0, seg_c, seg_lo, seg_n)
    return torch.cat([threefry.fold_in(k, EDGE_TAG + e)
                      for e in range(L // seg_c.shape[0])])


def tier_width(n: int) -> int:
    """The tier width of a row of n bins: the smallest power of two that
    is at least 1,024 and holds n."""
    return max(1024, 1 << (int(n) - 1).bit_length())


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def _walk_update(ostat, nrejc, np0, nrej0, k0, walking, pstats, sbdry,
                 n_perm):
    """One permutation chunk through every walking row's boundary walk.
    Returns (accept_now, walking', np', nrej', k')."""
    S, P = pstats.shape
    dev = pstats.device
    csum = torch.cumsum((ostat[:, None] <= pstats).to(torch.int64), dim=1)
    nrej_j = nrej0[:, None] + csum
    k_j = k0[:, None] + csum
    np_j = np0[:, None] + torch.arange(1, P + 1, device=dev)[None, :]
    rej = nrej_j > nrejc[:, None]
    sb = sbdry[torch.clamp(k_j - 1, 0, sbdry.shape[0] - 1)]
    acc = (np_j >= sb) | (np_j >= n_perm)
    first_rej = torch.where(rej.any(dim=1),
                            torch.argmax(rej.to(torch.int32), dim=1), P)
    first_acc = torch.where(acc.any(dim=1),
                            torch.argmax(acc.to(torch.int32), dim=1), P)
    decided = walking & ((first_rej < P) | (first_acc < P))
    # reject is checked before the boundary accept inside one iteration,
    # so an exact tie (same j) rejects: accept only strictly earlier
    accept_now = decided & (first_acc < first_rej)
    np1 = torch.where(walking, np0 + P, np0)
    nrej1 = torch.where(walking, nrej0 + csum[:, -1], nrej0)
    k1 = torch.where(walking, k0 + csum[:, -1], k0)
    exhausted = walking & ~decided & (np1 >= n_perm)
    accept_now = accept_now | exhausted
    walking1 = walking & ~decided & ~exhausted
    return accept_now, walking1, np1, nrej1, k1


def walk_plain(x, n, tss, key0, seg_c, seg_lo, walking, hybrid, ostat,
               nrejc, sbdry, n_perm: int, al0: int, kmax: int, n_min: int,
               stats=None):
    """Plain version of K7: each walking row alone, chunk after chunk,
    through cbs_device._perm_stats and _walk_update until it is decided,
    under the row's seg_keys(key0, seg_c, seg_lo, n).  With `stats` (f32
    [W, P_CHUNK]) given, each walking row's row of it takes the
    statistics of its chunk 0."""
    W = x.shape[0]
    dev = x.device
    keys = seg_keys(key0, seg_c, seg_lo, n)
    accepted = torch.zeros(W, dtype=torch.bool, device=dev)
    chunks = torch.zeros(W, dtype=torch.int64, device=dev)
    for r in range(W):
        if not bool(walking[r]):
            continue
        w = tier_width(int(n[r]))
        rr = slice(r, r + 1)
        live = walking[rr]
        np0 = torch.zeros(1, dtype=torch.int64, device=dev)
        nrej0 = torch.zeros_like(np0)
        k0 = nrejc[rr] * (nrejc[rr] + 1) // 2 + 1
        c = 0
        while bool(live):
            ps = cbs_device._perm_stats(
                x[rr, :w], n[rr], tss[rr], threefry.fold_in(keys[rr], c), w,
                P_CHUNK, al0, kmax, not bool(hybrid[r]), n_min)
            if stats is not None and c == 0:
                stats[r] = ps[0]
            acc, live, np0, nrej0, k0 = _walk_update(
                ostat[rr], nrejc[rr], np0, nrej0, k0, live, ps, sbdry,
                n_perm)
            accepted[r] = accepted[r] | acc[0]
            c += 1
        chunks[r] = c
    return accepted, chunks


def _subset_sums(xr, nn, mm, mm_host, keys, npad, cols):
    """[R, P_CHUNK] sums over uniform random mm-subsets of the first nn
    values of each row of xr [R, >= cols], drawn from its key as the
    [P_CHUNK, npad] block of uint32 keys that the JAX package draws.

    The mm smallest of iid 32-bit keys form a uniform mm-subset, so the
    values whose keys lie under the mm-th order statistic are summed.  Key
    ties resolve by index through one cumsum, which keeps the subset
    uniform.  Padding draws 0xFFFFFFFF, the largest key, so no padding is
    ever picked (mm <= nn real keys come first) and the keys past the
    longest row, `cols` <= npad, are not drawn.  The order statistic is
    torch.kthvalue with each row's mm from the host (`mm_host`), equal to
    the JAX package's 32-step binary search over the key space."""
    R = xr.shape[0]
    dev = xr.device
    out = torch.empty((R, P_CHUNK), dtype=torch.float32, device=dev)
    per = max(1, cbs_device._PERM_ELEMS // (P_CHUNK * cols))
    real = torch.arange(cols, device=dev)[None, None, :]
    for s0 in range(0, R, per):
        s1 = min(R, s0 + per)
        u = threefry.random_bits(keys[s0:s1], (P_CHUNK, npad), cols)
        u = torch.where(real < nn[s0:s1, None, None], u, 0xFFFFFFFF)
        tau = torch.stack([torch.kthvalue(u[i], mm_host[s0 + i]).values
                           for i in range(s1 - s0)])
        less = u < tau[..., None]
        k_t = mm[s0:s1, None] - less.sum(dim=2)
        tie = u == tau[..., None]
        cum = torch.cumsum(tie.to(torch.int64), dim=2)
        pick = less | (tie & (cum <= k_t[..., None]))
        out[s0:s1] = _fsum(torch.where(pick, xr[s0:s1, None, :cols], 0.0))
    return out


def edge_counts_plain(xw, wn, m1, xbar, ostat, active, key0, seg_c, seg_lo,
                      seg_n, limit, n_perm: int, sums=None):
    """Plain version of K8: each active lane alone, chunk after chunk,
    through _subset_sums until its count passes `limit` or n_perm
    permutations are done, under the lane's edge_keys(key0, seg_c,
    seg_lo, seg_n, L).  With `sums` (f32 [L, P_CHUNK]) given, each active
    lane's row of it takes the subset sums of its chunk 0."""
    L = xw.shape[0]
    dev = xw.device
    _check_lanes(L, seg_c.shape[0])
    ekeys = edge_keys(key0, seg_c, seg_lo, seg_n, L)
    count = torch.zeros(L, dtype=torch.int64, device=dev)
    cnt = torch.zeros_like(count)
    m1f = torch.clamp(m1, min=1).to(torch.float32)
    lane = torch.arange(P_CHUNK, device=dev)
    for r in range(L):
        if not bool(active[r]):
            continue
        w, mm = int(wn[r]), int(m1[r])
        rr = slice(r, r + 1)
        live, done, c = active[r], 0, 0
        while bool(live):
            s = _subset_sums(xw[rr], wn[rr], m1[rr], [mm],
                             threefry.fold_in(ekeys[rr], c),
                             tier_width(w), w)[0]
            if sums is not None and c == 0:
                sums[r] = s
            take = min(n_perm - done, P_CHUNK)
            pstat = (s / m1f[r] - xbar[r]).abs()
            count[r] += ((ostat[r] <= pstat) & (lane < take)).sum()
            done += take
            c += 1
            live = (count[r].to(torch.float32) <= limit) & (done < n_perm)
        cnt[r] = c
    return count, cnt


def perm_stats_plain(x, n, tss, keys, mask, hybrid, P: int, al0: int,
                     kmax: int, max_len: int):
    """Plain version of K12: f32 [S, P], for the rows under mask
    cbs_device._perm_stats of the hybrid rows and of the full-arc rows
    (lags bounded by max_len) apart, zero elsewhere."""
    S, npad = x.shape
    out = torch.zeros((S, P), dtype=torch.float32, device=x.device)
    for full in (False, True):
        rows = torch.nonzero(mask & (~hybrid if full else hybrid))[:, 0]
        if len(rows):
            out[rows] = cbs_device._perm_stats(
                x[rows], n[rows], tss[rows], keys[rows], npad, P, al0, kmax,
                full, max_len)
    return out


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_GRIDS: dict = {}


_WALK, _EDGE, _PERM = 0, 1, 2     # cbs_grid's kernels: K7, K8, K12


def _grid(lib, dev: torch.device, which: int) -> int:
    """Thread blocks of a launch of kernel `which` on dev: its SMs times
    the blocks the occupancy calculator lets each hold (one), all resident
    at once, as K7's and K8's grid-wide barriers need (a cooperative
    launch checks it)."""
    key = (dev.index, which)
    if key not in _GRIDS:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            cuda_lib.check(lib.cbs_grid(which, ctypes.byref(out)),
                           "cbs_grid")
        _GRIDS[key] = out.value
    return _GRIDS[key]


def _slab(dev: torch.device, grid: int, Tmax: int) -> torch.Tensor:
    """Per thread block, the buffer of one permutation where its tier
    does not fit in shared memory (SLAB_TIER)."""
    words = grid * Tmax if Tmax >= SLAB_TIER else 1
    return torch.empty(words, dtype=torch.int32, device=dev)


def _check_lanes(L: int, R: int) -> None:
    if R < 1 or L % R:
        raise ValueError(f"{L} lanes do not split into edges of {R} rows")


def _check(tensors) -> None:
    """Raise unless every (name, tensor, dtype, shape) is a contiguous
    CUDA tensor of that dtype and shape on the first one's device."""
    dev = tensors[0][1].device
    for name, t, dt, shape in tensors:
        cuda_lib.require_cuda_tensor(name, t, dt, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")


def _check_sizes(W: int, Tmax: int) -> None:
    if W > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows a launch, got {W}")
    if Tmax < 1024 or Tmax > 65536 or Tmax & (Tmax - 1):
        raise ValueError(f"Tmax must be a power of two in [1024, 65536], "
                         f"got {Tmax}")


def walk(x, n, tss, key0, seg_c, seg_lo, walking, hybrid, ostat, nrejc,
         sbdry, n_perm: int, al0: int, kmax: int, n_min: int, stats=None,
         live=None):
    """K7: (accepted bool [W], chunks int64 [W]) of the boundary walks of
    the rows of x f32 [W, Tmax] (centred values, zero past n) with n int64,
    tss f32, the level's threefry key key0 int64 [2] and each row's contig
    seg_c and start seg_lo int64 [W] (its key is seg_keys(key0, seg_c,
    seg_lo, n)), walking and hybrid bool, ostat f32, nrejc int64 [W] and
    the boundary sbdry int64; Tmax a power of two in [1024, 65536] and
    n <= Tmax.  With `stats` (f32 [W, P_CHUNK]), each walking row's row of
    it takes its chunk 0's statistics.  live (an int64 scalar on the card,
    may be None): where it is 0 every block returns at once and nothing is
    written; on CPU tensors it is not read."""
    if x.dim() != 2:
        raise ValueError(f"x must be [W, Tmax], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return walk_plain(x, n, tss, key0, seg_c, seg_lo, walking, hybrid,
                          ostat, nrejc, sbdry, n_perm, al0, kmax, n_min,
                          stats)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    W, Tmax = x.shape
    vec = (W,)
    checks = [("x", x, torch.float32, (W, Tmax)),
              ("n", n, torch.int64, vec), ("tss", tss, torch.float32, vec),
              ("key0", key0, torch.int64, (2,)),
              ("seg_c", seg_c, torch.int64, vec),
              ("seg_lo", seg_lo, torch.int64, vec),
              ("walking", walking, torch.bool, vec),
              ("hybrid", hybrid, torch.bool, vec),
              ("ostat", ostat, torch.float32, vec),
              ("nrejc", nrejc, torch.int64, vec),
              ("sbdry", sbdry, torch.int64, (sbdry.shape[0],))]
    if stats is not None:
        checks.append(("stats", stats, torch.float32, (W, P_CHUNK)))
    if live is not None:
        checks.append(("live", live, torch.int64, ()))
    _check(checks)
    _check_sizes(W, Tmax)
    dev = x.device
    lib = cuda_lib.load("cbs_mega", _SIGNATURES)
    grid = _grid(lib, dev, _WALK)
    # the walks' state (nrej, k) by the iteration's parity, and a chunk's
    # statistics by parity
    state = torch.empty((2, 2, W), dtype=torch.int64, device=dev)
    pstats = torch.empty((2, W, P_CHUNK), dtype=torch.float32, device=dev)
    slab = _slab(dev, grid, Tmax)
    accepted = torch.empty(W, dtype=torch.bool, device=dev)
    chunks = torch.empty(W, dtype=torch.int64, device=dev)
    status = cuda_lib.launch(
        dev, lib.cbs_walk,
        x.data_ptr(), n.data_ptr(), tss.data_ptr(), key0.data_ptr(),
        seg_c.data_ptr(), seg_lo.data_ptr(), walking.data_ptr(),
        hybrid.data_ptr(), ostat.data_ptr(), nrejc.data_ptr(),
        sbdry.data_ptr(), state.data_ptr(), pstats.data_ptr(),
        slab.data_ptr(), accepted.data_ptr(), chunks.data_ptr(),
        stats.data_ptr() if stats is not None else None,
        W, Tmax, sbdry.shape[0], n_perm, al0, kmax, min(n_min, 1 << 30),
        grid, cuda_lib.ptr(live))
    cuda_lib.check(status, "cbs_walk")
    LAUNCHES["walk"] += 1
    return accepted, chunks


def edge_counts(xw, wn, m1, xbar, ostat, active, key0, seg_c, seg_lo,
                seg_n, limit, n_perm: int, sums=None, live=None):
    """K8: (count int64 [L], cnt int64 [L]) of the edge tests of the
    lanes of xw f32 [L, Tmax] (window values, zero past wn) with wn and
    m1 int64, xbar and ostat f32, active bool, the level's threefry key
    key0 int64 [2], the rows' contig, start and length seg_c, seg_lo and
    seg_n int64 [R] with L a multiple of R (lane l tests edge l // R + 1
    of row l % R, under edge_keys) and limit an f32 scalar tensor
    (alpha * n_perm); Tmax a power of two in [1024, 65536] and wn <= Tmax.
    With `sums` (f32 [L, P_CHUNK]), each active lane's row of it takes its
    chunk 0's subset sums.  live as for walk."""
    if xw.dim() != 2:
        raise ValueError(f"xw must be [L, Tmax], got {tuple(xw.shape)}")
    if xw.device.type == "cpu":
        return edge_counts_plain(xw, wn, m1, xbar, ostat, active, key0,
                                 seg_c, seg_lo, seg_n, limit, n_perm, sums)
    if xw.device.type != "cuda":
        raise ValueError(f"unsupported device {xw.device}")
    L, Tmax = xw.shape
    R = seg_c.shape[0]
    _check_lanes(L, R)
    vec, rows = (L,), (R,)
    checks = [("xw", xw, torch.float32, (L, Tmax)),
              ("wn", wn, torch.int64, vec), ("m1", m1, torch.int64, vec),
              ("xbar", xbar, torch.float32, vec),
              ("ostat", ostat, torch.float32, vec),
              ("active", active, torch.bool, vec),
              ("key0", key0, torch.int64, (2,)),
              ("seg_c", seg_c, torch.int64, rows),
              ("seg_lo", seg_lo, torch.int64, rows),
              ("seg_n", seg_n, torch.int64, rows),
              ("limit", limit, torch.float32, ())]
    if sums is not None:
        checks.append(("sums", sums, torch.float32, (L, P_CHUNK)))
    if live is not None:
        checks.append(("live", live, torch.int64, ()))
    _check(checks)
    _check_sizes(L, Tmax)
    dev = xw.device
    lib = cuda_lib.load("cbs_mega", _SIGNATURES)
    grid = _grid(lib, dev, _EDGE)
    # the lanes' counts by the iteration's parity, and the subset sums of
    # the chunks an iteration takes (up to EDGE_DEPTH) by parity
    state = torch.empty((2, L), dtype=torch.int64, device=dev)
    psums = torch.empty((2, EDGE_DEPTH, L, P_CHUNK), dtype=torch.float32,
                        device=dev)
    slab = _slab(dev, grid, Tmax)
    count = torch.empty(L, dtype=torch.int64, device=dev)
    cnt = torch.empty(L, dtype=torch.int64, device=dev)
    status = cuda_lib.launch(
        dev, lib.cbs_edge,
        xw.data_ptr(), wn.data_ptr(), m1.data_ptr(), xbar.data_ptr(),
        ostat.data_ptr(), active.data_ptr(), key0.data_ptr(),
        seg_c.data_ptr(), seg_lo.data_ptr(), seg_n.data_ptr(),
        limit.data_ptr(), state.data_ptr(), psums.data_ptr(),
        slab.data_ptr(), count.data_ptr(), cnt.data_ptr(),
        sums.data_ptr() if sums is not None else None,
        L, R, Tmax, n_perm, grid, cuda_lib.ptr(live))
    cuda_lib.check(status, "cbs_edge")
    LAUNCHES["edge"] += 1
    return count, cnt


def perm_stats(x, n, tss, keys, mask, hybrid, P: int, al0: int, kmax: int,
               max_len: int):
    """K12: f32 [S, P] permutation max-t statistics of one chunk for the
    rows of x f32 [S, npad] (centred values, zero past n; npad a power of
    two up to 65,536) under mask, with n int64, tss f32, the rows' chunk
    keys int64 [S, 2] and hybrid bool [S] (else the full-arc statistic,
    lags bounded by max_len, which is at least every full row's n); zero
    on the other rows.  One launch for each MAX_ROWS rows."""
    if x.dim() != 2:
        raise ValueError(f"x must be [S, npad], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return perm_stats_plain(x, n, tss, keys, mask, hybrid, P, al0, kmax,
                                max_len)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    S, npad = x.shape
    vec = (S,)
    _check([("x", x, torch.float32, (S, npad)),
            ("n", n, torch.int64, vec), ("tss", tss, torch.float32, vec),
            ("keys", keys, torch.int64, (S, 2)),
            ("mask", mask, torch.bool, vec),
            ("hybrid", hybrid, torch.bool, vec)])
    if npad < 1 or npad > SLAB_TIER or npad & (npad - 1):
        raise ValueError(f"npad must be a power of two up to {SLAB_TIER}, "
                         f"got {npad}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    dev = x.device
    out = torch.empty((S, P), dtype=torch.float32, device=dev)
    if S == 0:
        return out
    lib = cuda_lib.load("cbs_mega", _SIGNATURES)
    grid = _grid(lib, dev, _PERM)
    slab = _slab(dev, grid, npad)
    for s0 in range(0, S, MAX_ROWS):
        s1 = min(S, s0 + MAX_ROWS)
        status = cuda_lib.launch(
            dev, lib.cbs_perm, x[s0:s1].data_ptr(), n[s0:s1].data_ptr(),
            tss[s0:s1].data_ptr(), keys[s0:s1].data_ptr(),
            mask[s0:s1].data_ptr(), hybrid[s0:s1].data_ptr(),
            slab.data_ptr(), out[s0:s1].data_ptr(), s1 - s0, npad, P, al0,
            kmax, min(max_len, 1 << 30), grid)
        cuda_lib.check(status, "cbs_perm")
        LAUNCHES["perm"] += 1
    return out


def _bucket_nb(npad: int) -> int:
    """The counting sort's buckets at width npad: 2^B, B = log2(npad) - 2
    clamped to 7..13."""
    lg = max(0, (int(npad) - 1).bit_length())
    return 1 << min(13, max(7, lg - 2))


def _k7_groups(npad: int, edge: bool) -> tuple[int, int, int]:
    """(groups, mode, bytes) of k7_layout / k8_layout."""
    if edge:
        mode = _SLAB if npad >= SLAB_TIER else _SINGLE
        need = _align16(_HEAD7_LAG + 4 * (_DIGIT_BINS
                                          + (0 if mode == _SLAB else npad)))
    elif npad >= SLAB_TIER:
        mode, need = _SLAB, _align16(_HEAD7 + 4 * _bucket_nb(npad))
    else:
        mode = _SINGLE
        need = _align16(_HEAD7 + 4 * (_bucket_nb(npad) + npad))
    k = 1 if mode == _SLAB else min(_MAX_GROUPS, _BUDGET // need)
    return k, mode, need


def layout(npad: int, edge: bool) -> dict:
    """How a launch of K7 (or K8, for a subset above 32) works a row
    of tier width npad: the groups of warps a block runs at once (K7: in
    an iteration whose widest walking row has this tier), where a
    permutation's buffers live ("shared, two buffers", "shared, one
    buffer" or "device-memory slab") and a group's shared bytes."""
    k, mode, need = _k7_groups(npad, edge)
    return {"groups": k, "buffers": _MODES[mode], "bytes": need}


def _double_bytes(npad: int) -> int:
    return _HEAD7 + 4 * (_bucket_nb(npad) + 2 * npad)


WIDE_ROW = 8192        # K12 keeps two buffers from here at more rounds,
                       # and stages the row's values


def perm_layout(npad: int, items: int, grid: int) -> dict:
    """K12's groups for a launch of `items` (masked rows x P) over `grid`
    blocks at width npad, as csrc/cbs_mega.cu's perm_layout chooses them on
    the card.  The cap is what two buffers a slice allow where they take
    each block's share of the items in one round (or the width is
    WIDE_ROW or more), else layout(npad, False)'s (never more); the
    share goes in as few rounds as the cap allows, by the fewest groups
    that take it in those rounds; a slice keeps two buffers wherever it
    holds them (the scatter then reads the kept draws, one cipher call a
    position instead of two; from WIDE_ROW on, the row's values are staged
    in shared memory).  Returns the groups, the buffers, a group's slice
    bytes, the bytes two buffers take, the rounds, the cipher calls a
    position and whether the values are staged."""
    kcap = _k7_groups(npad, False)[0]
    kd = 0 if npad >= SLAB_TIER else min(kcap,
                                         _PERM_BUDGET // _double_bytes(npad))
    share = max(1, -(-items // grid) if grid > 0 else items)
    cap = kd if kd >= 1 and (share <= kd or npad >= WIDE_ROW) else kcap
    rounds = -(-share // cap)
    k = -(-share // rounds)
    slice_ = (_PERM_BUDGET // k) & ~15
    mode = _SLAB if npad >= SLAB_TIER else (
        _DOUBLE if _double_bytes(npad) <= slice_ else _SINGLE)
    return {"groups": k, "buffers": _MODES[mode], "bytes": slice_,
            "double_bytes": _double_bytes(npad), "rounds": -(-share // k),
            "draws_a_position": 1 if mode == _DOUBLE else 2,
            "staged": mode == _DOUBLE and npad >= WIDE_ROW}


def device_layout(npad: int, edge: bool) -> dict:
    """layout() as csrc/cbs_mega.cu computes it (k7_layout, k8_layout),
    from the built library, for tests."""
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load("cbs_mega", _SIGNATURES).cbs_layout(
        npad, int(edge), out), "cbs_layout")
    return {"groups": out[0], "buffers": _MODES[out[1]], "bytes": out[2]}


def device_perm_layout(npad: int, items: int, grid: int) -> dict:
    """(groups, buffers, slice bytes, bytes of two buffers) of
    perm_layout() as csrc/cbs_mega.cu computes it, for tests."""
    out = (ctypes.c_int * 4)()
    cuda_lib.check(cuda_lib.load("cbs_mega", _SIGNATURES).cbs_perm_layout(
        npad, items, grid, out), "cbs_perm_layout")
    return {"groups": out[0], "buffers": _MODES[out[1]], "bytes": out[2],
            "double_bytes": out[3]}


def perm_grid(dev: torch.device) -> int:
    """K12's thread blocks a launch on the CUDA device dev."""
    return _grid(cuda_lib.load("cbs_mega", _SIGNATURES), dev, _PERM)


def device_draws(keys, data, counter0: int, count: int):
    """The kernels' own threefry on the card, for tests: (fold_in(keys,
    data) int64 [K, 2], the 32-bit draws of counters counter0 ..
    counter0 + count - 1 under each key int64 [K, count], and their f32
    uniforms [K, count]); keys int64 [K, 2] and data int64 [K] on a CUDA
    device."""
    K = keys.shape[0]
    dev = keys.device
    _check([("keys", keys, torch.int64, (K, 2)),
            ("data", data, torch.int64, (K,))])
    lib = cuda_lib.load("cbs_mega", _SIGNATURES)
    folded = torch.empty((K, 2), dtype=torch.int64, device=dev)
    bits = torch.empty((K, count), dtype=torch.int64, device=dev)
    unif = torch.empty((K, count), dtype=torch.float32, device=dev)
    status = cuda_lib.launch(
        dev, lib.cbs_threefry, keys.data_ptr(), data.data_ptr(), K,
        counter0, count, folded.data_ptr(), bits.data_ptr(),
        unif.data_ptr())
    cuda_lib.check(status, "cbs_threefry")
    return folded, bits, unif


def device_keys(key0, seg_c, seg_lo, seg_n, L: int, chunk: int):
    """The chunk keys the kernels derive on the card, for tests: (fold_in(
    seg_keys(...), chunk) int64 [R, 2], K7's, and fold_in(edge_keys(...,
    L), chunk) int64 [L, 2], K8's); key0 int64 [2] and the rows' seg_c,
    seg_lo and seg_n int64 [R] on a CUDA device."""
    R = seg_c.shape[0]
    dev = key0.device
    _check_lanes(L, R)
    _check([("key0", key0, torch.int64, (2,)),
            ("seg_c", seg_c, torch.int64, (R,)),
            ("seg_lo", seg_lo, torch.int64, (R,)),
            ("seg_n", seg_n, torch.int64, (R,))])
    lib = cuda_lib.load("cbs_mega", _SIGNATURES)
    walk_keys = torch.empty((R, 2), dtype=torch.int64, device=dev)
    edge_keys_ = torch.empty((L, 2), dtype=torch.int64, device=dev)
    status = cuda_lib.launch(
        dev, lib.cbs_keys, key0.data_ptr(), seg_c.data_ptr(),
        seg_lo.data_ptr(), seg_n.data_ptr(), R, L, chunk,
        walk_keys.data_ptr(), edge_keys_.data_ptr())
    cuda_lib.check(status, "cbs_keys")
    return walk_keys, edge_keys_
