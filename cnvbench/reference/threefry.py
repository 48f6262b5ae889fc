"""Threefry-2x32 draws in plain torch: the reference's own copy of the
stream the whole-recursion CBS engine draws its permutations from.

The stream is JAX's partitionable threefry (Salmon et al., SC'11):
element k of a flattened shape is hashed from the counter pair
(k >> 32, k & 0xffffffff) by the 20-round Threefry-2x32 cipher under the
key (k0, k1), its 32 random bits are the exclusive or of the two output
words, and `fold_in(key, d)` is the cipher's two words on the counter
(0, d).  A uniform is (bits >> 9 | 0x3f800000) read as f32, minus 1.

Keys and bits cross the interface as int64 holding uint32 values; the
cipher runs on int32 words, whose adds wrap modulo 2^32, a logical right
shift being an arithmetic one with the sign bits masked off.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.int32 else x.to(torch.int64).to(torch.int32)


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block: int32 words out for key and
    counter words in; the key words broadcast against the counters."""
    k0, k1 = _i32(k0), _i32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = _i32(x0) + ks[0]
    x1 = _i32(x1) + ks[1]
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1) \
                .bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """fold_in(key, d) for every key row of keys [..., 2]; data is an int
    or an integer tensor broadcasting against keys[..., 0], taken as
    uint32."""
    k = keys.to(torch.int64)
    if isinstance(data, int):
        d = torch.full_like(k[..., 0], data & _MASK)
    else:
        d = data.to(torch.int64) & _MASK
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    out = torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)
    return out.to(torch.int64) & _MASK


def _bits32(keys: torch.Tensor, shape: tuple, cols: int | None = None):
    dev = keys.device
    k = keys.to(torch.int64)
    view = (*k.shape[:-1], *([1] * len(shape)))
    k0 = k[..., 0].reshape(view)
    k1 = k[..., 1].reshape(view)
    idx = torch.arange(shape[-1] if cols is None else cols,
                       dtype=torch.int64, device=dev)
    stride = shape[-1]
    for s in reversed(shape[:-1]):
        idx = (torch.arange(s, dtype=torch.int64, device=dev)
               .view(-1, *([1] * idx.dim())) * stride + idx)
        stride *= s
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return b0.bitwise_xor_(b1)


def random_bits(keys: torch.Tensor, shape: tuple, cols: int | None = None):
    """int64 [*keys.shape[:-1], *shape] of 32-bit draws, one block of
    shape a key row; with cols, only the first cols entries of the last
    axis (the counters keep the full shape's numbering)."""
    return _bits32(keys, shape, cols).to(torch.int64) & _MASK


def uniform(keys: torch.Tensor, shape: tuple, cols: int | None = None):
    """f32 uniforms in [0, 1), one block of shape a key row."""
    fbits = _bits32(keys, shape, cols).bitwise_right_shift_(9) \
        .bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    return fbits.view(torch.float32) - 1.0
