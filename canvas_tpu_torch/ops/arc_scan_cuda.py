"""CBS arc-scan kernel B4, with its plain torch version.

Per segment b (one row of a frontier bucket), over the cumsum `cs` f32
[B, npad] of its centred values (zero beyond its length n[b]):

    best[b] = max(seed[b], max over lags L in [al0, lag_hi[b]] and positions
                  i <= n[b]-1-L of  w(L) * (cs2[i+L] - cs[i])^2),
    w(L) = n / (L (n - L)),  cs2 = cs zero-extended to 2 npad,

searched as a branch-and-bound over blocks of `blk` = min(512, npad) lags:
block k (lags k*blk .. k*blk+blk-1) is visited only when it overlaps
[al0, lag_hi] and w_bound * psd2[b, k] > best, the running best
(w_bound: the larger weight at the block's two live ends; psd2: the
per-block bound on d^2 from cbs_device._block_d2_bound).  Inside a visited
block the lags go in sub-blocks of `sub` = min(32, blk); a sub-block whose
maximum is strictly greater than the best takes it, and bl0[b] is the
first lag of the last sub-block that did (-1 when the seed was never
beaten).  cbs_device.tmax_batch recovers (i, j) inside that sub-block.

On CUDA tensors `arc_scan` launches csrc/arc_scan.cu; on CPU tensors it
runs `arc_scan_plain` (with a row mask, on the rows under it).  The
whole-recursion engine passes its tier's row mask, the first npad columns
of its [W, Tmax] cumsum (rows at their stride), its live flag and the word
of its tally that B4 adds to: a row outside the mask, or every row where
live is 0, is left out.  The plain version forms every term as w * (d * d)
with correctly rounded f32 operations.  The kernel factors w out of the
maximum over positions: fl(d * d) is monotone in |d| and fl(w * x) in x
for w > 0, so max_i fl(w * fl(d_i * d_i)) = fl(w * fl(D * D)) with
D = max_i |d_i|, bit for bit.  It computes, on a persistent grid of the
card's SMs times the blocks each holds (`grid`), every (lag block, row,
position tile) that the seed admits and no finished block has pruned (one
subtraction and one |.|-maximum a term, w once a lag), listed on the card
from the rows under the mask, then replays the walk above over the
blocks' sub-block maxima; so `best` is equal bit for bit and `bl0` equal.
That pruning needs psd2 to bound d^2 in each block, as `_block_d2_bound`
does.  The bound counts the pair terms the walk visits
(`arc_scan_plain(..., count=)`) at two f32 issue slots each; the kernel's
tally counts the pair terms it computed, between the walk's and those of
every block the seed admits (count's "terms" and "seed_terms").
"""

from __future__ import annotations

import ctypes

import torch

from canvas_tpu_torch.ops import cuda_lib

PTBL = 32     # lags per sub-block: the bl0 granularity
PBLK = 512    # lags per pruning block
MAX_SUB = PBLK // PTBL

# launches of the kernel, counted by the wrapper
LAUNCHES = {"arc_scan": 0}

_SIGNATURES = {
    "arc_scan": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 4,
    "arc_scan_occupancy": [ctypes.c_void_p],
}
_OCCUPANCY: dict[int, tuple[int, int]] = {}


def scratch_words(B: int, nblk: int) -> int:
    """int32 words of the kernel's scratch: its item counter, the
    sub-block maxima [B, nblk, MAX_SUB] and the floors [B, nblk]."""
    return 1 + B * nblk * (MAX_SUB + 1)


def geometry(npad: int) -> tuple[int, int, int, int]:
    """(blk, sub, nblk, nsub): lags per block and per sub-block, blocks per
    segment and sub-blocks per block for a bucket padded to npad."""
    blk = min(PBLK, npad)
    sub = min(PTBL, blk)
    return blk, sub, max((npad + blk - 1) // blk, 1), blk // sub


def _w_of(L: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """w(L) = n / (L (n - L)) in f32, with L clipped into [1, max(n-1, 1)]."""
    hi = torch.clamp(n - 1, min=1)
    Lf = torch.minimum(torch.clamp(L, min=1), hi).to(torch.float32)
    nf = n.to(torch.float32)
    return nf / (Lf * (nf - Lf))


def _block_gate(k: int, blk: int, n, lag_hi, psd2, al0: int):
    """(in_range, w_bound * psd2[:, k]) of block k for every row."""
    l0 = k * blk
    in_range = (l0 <= lag_hi) & (l0 + blk - 1 >= al0)
    lo = torch.full_like(n, max(l0, al0))
    hi = torch.clamp(lag_hi, max=l0 + blk - 1)
    w_bound = torch.maximum(_w_of(lo, n), _w_of(hi, n))
    return in_range, w_bound * psd2[:, k]


def _block_terms(k: int, blk: int, n, lag_hi, al0: int) -> torch.Tensor:
    """The live pair terms of block k for every row, int64: n - L summed
    over its lags L in [al0, lag_hi], L <= n - 1."""
    nn = n.to(torch.int64)
    lo = max(k * blk, al0)
    hi = torch.minimum(torch.clamp(lag_hi.to(torch.int64),
                                   max=k * blk + blk - 1), nn - 1)
    cnt = torch.clamp(hi - lo + 1, min=0)
    return cnt * nn - (lo + hi) * cnt // 2


def arc_scan_plain(cs, n, lag_hi, seed, psd2, al0: int,
                   count: dict | None = None):
    """Plain torch version of B4: the sequential loop over blocks and
    sub-blocks, each sub-block evaluated as a [B, sub, npad] tile.  With a
    `count` dict, count["blocks"] and count["terms"] gain the blocks the
    walk visits and their pair terms (lag L of a row of n bins has n - L):
    the work the function needs on these inputs; count["seed_terms"] the
    pair terms of every block that the seed alone admits, the most that
    the kernel's first phase computes."""
    B, npad = cs.shape
    blk, sub, nblk, nsub = geometry(npad)
    dev = cs.device
    cs2 = torch.cat([cs, torch.zeros_like(cs)], dim=1)
    pos = torch.arange(npad, device=dev)
    t_off = torch.arange(sub, device=dev)
    best = seed.clone()
    bl0 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for k in range(nblk):
        in_range, gate = _block_gate(k, blk, n, lag_hi, psd2, al0)
        go = in_range & (gate > best)
        if count is not None:
            terms = _block_terms(k, blk, n, lag_hi, al0)
            admitted = in_range & (gate > seed)
            count["blocks"] = count.get("blocks", 0) + int(go.sum())
            count["terms"] = count.get("terms", 0) + int((go * terms).sum())
            count["seed_terms"] = count.get("seed_terms", 0) + int(
                (admitted * terms).sum())
        if not bool(go.any()):
            continue
        # only the rows the block admits are evaluated; the others keep
        # their best
        rows = torch.nonzero(go)[:, 0]
        g = rows.shape[0]
        win = cs2[rows].unfold(1, npad, 1)   # win[r, s, i] = cs2[r, s + i]
        cs_g, n_g, lag_hi_g = cs[rows], n[rows], lag_hi[rows]
        for q in range(nsub):
            L0 = k * blk + q * sub
            lags = L0 + t_off                                      # [sub]
            d = win[:, L0:L0 + sub, :] - cs_g[:, None, :]          # [g,sub,npad]
            live = (lags[None] >= al0) & (lags[None] <= lag_hi_g[:, None])
            wv = torch.where(live, _w_of(lags[None].expand(g, sub),
                                         n_g[:, None]), -1.0)
            ok = pos[None, None, :] <= (n_g[:, None, None] - 1
                                        - lags[None, :, None])
            vals = torch.where(ok, wv[:, :, None] * (d * d), -1.0)
            m = vals.amax(dim=(1, 2))
            upd = m > best[rows]
            best[rows] = torch.where(upd, m, best[rows])
            bl0[rows] = torch.where(upd, L0, bl0[rows])
    return best, bl0


def occupancy(dev: torch.device) -> tuple[int, int]:
    """(SMs, blocks of phase 1 each holds at once) on the card dev, from
    the occupancy calculator, once a device: phase 1's grid is their
    product, whatever the launch's rows, mask and width."""
    if dev.index not in _OCCUPANCY:
        lib = cuda_lib.load("arc_scan", _SIGNATURES)
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            cuda_lib.check(lib.arc_scan_occupancy(out), "arc_scan_occupancy")
        _OCCUPANCY[dev.index] = (out[0], out[1])
    return _OCCUPANCY[dev.index]


def arc_scan(cs, n, lag_hi, seed, psd2, al0: int, mask=None, live=None,
             terms=None):
    """B4: (best f32 [B], bl0 int32 [B]) for cs f32 [B, npad], n and lag_hi
    int32 [B], seed f32 [B], psd2 f32 [B, nblk]; npad a power of two.  cs
    may be the first npad columns of wider rows (a view whose rows are
    contiguous).  With mask (bool [B]) only the rows under it are scanned:
    the others' best and bl0 are left unset (on the card, the kernel's
    list leaves them out).  live (an int64 scalar on the card, may be
    None): where it is 0 every block returns at once and nothing is
    written; on CPU tensors it is not read.  terms (an int64 scalar on the
    card, may be None) gains the live pair terms the kernel's first phase
    computed; on CPU tensors it is not written."""
    if cs.dim() != 2:
        raise ValueError(f"cs must be [B, npad], got {tuple(cs.shape)}")
    B, npad = cs.shape
    if npad < 1 or npad & (npad - 1):
        raise ValueError(f"npad must be a power of two, got {npad}")
    nblk = geometry(npad)[2]
    if n.shape != (B,) or lag_hi.shape != (B,) or seed.shape != (B,):
        raise ValueError("n, lag_hi and seed must be [B]")
    if psd2.shape != (B, nblk):
        raise ValueError(f"psd2 must be [{B}, {nblk}], got "
                         f"{tuple(psd2.shape)}")
    if cs.device.type == "cpu":
        if mask is None:
            return arc_scan_plain(cs, n, lag_hi, seed, psd2, al0)
        best = torch.zeros(B, dtype=torch.float32)
        bl0 = torch.full((B,), -1, dtype=torch.int32)
        rows = torch.nonzero(mask)[:, 0]
        if len(rows):
            best[rows], bl0[rows] = arc_scan_plain(
                cs[rows], n[rows], lag_hi[rows], seed[rows], psd2[rows], al0)
        return best, bl0
    if cs.device.type != "cuda":
        raise ValueError(f"unsupported device {cs.device}")
    dev = cs.device
    ld = cuda_lib.require_cuda_rows("cs", cs, torch.float32)
    for name, x, dt in (("n", n, torch.int32), ("lag_hi", lag_hi, torch.int32),
                        ("seed", seed, torch.float32),
                        ("psd2", psd2, torch.float32)):
        cuda_lib.require_cuda_tensor(name, x, dt, dev)
    if mask is not None:
        cuda_lib.require_cuda_tensor("mask", mask, torch.bool, dev)
    for name, x in (("live", live), ("terms", terms)):
        if x is not None:
            cuda_lib.require_cuda_tensor(name, x, torch.int64, dev)
    lib = cuda_lib.load("arc_scan", _SIGNATURES)
    sms, per_sm = occupancy(dev)
    scratch = torch.empty(scratch_words(B, nblk), dtype=torch.int32,
                          device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    bl0 = torch.empty(B, dtype=torch.int32, device=dev)
    status = cuda_lib.launch(
        dev, lib.arc_scan,
        cs.data_ptr(), n.data_ptr(), lag_hi.data_ptr(), seed.data_ptr(),
        psd2.data_ptr(), scratch.data_ptr(), best.data_ptr(), bl0.data_ptr(),
        B, npad, al0, ld, sms * per_sm, cuda_lib.ptr(mask),
        cuda_lib.ptr(live), cuda_lib.ptr(terms))
    cuda_lib.check(status, "arc_scan")
    LAUNCHES["arc_scan"] += 1
    return best, bl0
