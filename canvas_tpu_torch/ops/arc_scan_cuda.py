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
runs `arc_scan_plain`.  Both compute every term as w * (d * d) with
correctly rounded f32 operations and no contraction, so `best` is equal
bit for bit and `bl0` equal.
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
    "arc_scan": [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


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


def arc_scan_plain(cs, n, lag_hi, seed, psd2, al0: int):
    """Plain torch version of B4: the sequential loop over blocks and
    sub-blocks, each sub-block evaluated as a [B, sub, npad] tile."""
    B, npad = cs.shape
    blk, sub, nblk, nsub = geometry(npad)
    dev = cs.device
    cs2 = torch.cat([cs, torch.zeros_like(cs)], dim=1)
    win = cs2.unfold(1, npad, 1)             # win[b, s, i] = cs2[b, s + i]
    pos = torch.arange(npad, device=dev)
    t_off = torch.arange(sub, device=dev)
    best = seed.clone()
    bl0 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for k in range(nblk):
        in_range, gate = _block_gate(k, blk, n, lag_hi, psd2, al0)
        go = in_range & (gate > best)
        if not bool(go.any()):
            continue
        for q in range(nsub):
            L0 = k * blk + q * sub
            lags = L0 + t_off                                      # [sub]
            d = win[:, L0:L0 + sub, :] - cs[:, None, :]            # [B,sub,npad]
            live = (lags[None] >= al0) & (lags[None] <= lag_hi[:, None])
            wv = torch.where(live, _w_of(lags[None].expand(B, sub),
                                         n[:, None]), -1.0)
            ok = pos[None, None, :] <= (n[:, None, None] - 1
                                        - lags[None, :, None])
            vals = torch.where(ok, wv[:, :, None] * (d * d), -1.0)
            m = vals.amax(dim=(1, 2))
            upd = go & (m > best)
            best = torch.where(upd, m, best)
            bl0 = torch.where(upd, L0, bl0)
    return best, bl0


def arc_scan(cs, n, lag_hi, seed, psd2, al0: int):
    """B4: (best f32 [B], bl0 int32 [B]) for cs f32 [B, npad], n and lag_hi
    int32 [B], seed f32 [B], psd2 f32 [B, nblk]; npad a power of two."""
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
        return arc_scan_plain(cs, n, lag_hi, seed, psd2, al0)
    if cs.device.type != "cuda":
        raise ValueError(f"unsupported device {cs.device}")
    if B > 65535:
        raise ValueError(f"at most 65535 segments per launch, got {B}")
    dev = cs.device
    cuda_lib.require_cuda_tensor("cs", cs, torch.float32)
    for name, x, dt in (("n", n, torch.int32), ("lag_hi", lag_hi, torch.int32),
                        ("seed", seed, torch.float32),
                        ("psd2", psd2, torch.float32)):
        cuda_lib.require_cuda_tensor(name, x, dt, dev)
    lib = cuda_lib.load("arc_scan", _SIGNATURES)
    scratch = torch.empty((B, nblk, MAX_SUB), dtype=torch.int32, device=dev)
    best = torch.empty(B, dtype=torch.float32, device=dev)
    bl0 = torch.empty(B, dtype=torch.int32, device=dev)
    status = lib.arc_scan(
        cs.data_ptr(), n.data_ptr(), lag_hi.data_ptr(), seed.data_ptr(),
        psd2.data_ptr(), scratch.data_ptr(), best.data_ptr(), bl0.data_ptr(),
        B, npad, al0, cuda_lib.current_stream(dev))
    cuda_lib.check(status, "arc_scan")
    LAUNCHES["arc_scan"] += 1
    return best, bl0
