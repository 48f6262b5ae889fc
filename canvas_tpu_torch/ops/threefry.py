"""Threefry-2x32 uniforms in torch, equal bit for bit to the JAX package's
`jax.random.uniform(key, shape, float32)` for a raw [2] uint32 key, and
`fold_in`, equal to `jax.random.fold_in`.

The frontier CBS engine (ops/cbs_device.py) draws its permutations from
per-(contig, segment, chunk) keys that it derives on the host
(`_seg_keys_np`); the whole-recursion engine (ops/cbs_mega.py) derives
its keys on the device with `fold_in` chains.  With the same keys and
these draws the port's permutations are the JAX package's, on the CPU and
on a card alike.

The stream, as JAX builds it with partitionable threefry:
  * element k of the flattened shape is hashed from the counter pair
    (hi, lo) = (k >> 32, k & 0xffffffff) with the 20-round Threefry-2x32
    block cipher (Salmon et al., SC'11) under the key (k0, k1);
  * its 32 random bits are the XOR of the two output words;
  * the float is (bits >> 9 | 0x3f800000) read as f32, minus 1.

torch's uint32 lacks shifts on CUDA, so keys and bits cross the interface
as int64 holding uint32 values.  The cipher itself runs on int32 words:
adds wrap modulo 2^32 in two's complement, and a logical right shift is an
arithmetic one with the sign bits masked off.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (held in int64, or already int32) as int32 words."""
    return x if x.dtype == torch.int32 else x.to(torch.int64).to(torch.int32)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block: int32 words out for key and
    counter words in (int64 holding uint32, or int32); the key words
    broadcast against the counters.  The rounds update two fresh word
    tensors in place."""
    k0, k1 = _i32(k0), _i32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = _i32(x0) + ks[0]
    x1 = _i32(x1) + ks[1]
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            # x1 = rotl32(x1, r) ^ x0
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1) \
                .bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, d)` for every key row of `keys` ([..., 2],
    uint32 words as int64): the two output words of threefry2x32 under the
    key on the counter pair (0, d).  `data` is an int or an integer tensor
    that broadcasts against keys[..., 0]; it is taken as uint32.  An int
    is filled in on the keys' device (a copy from the host would wait for
    the device)."""
    k = keys.to(torch.int64)
    if isinstance(data, int):
        d = torch.full_like(k[..., 0], data & _MASK)
    else:
        d = data.to(torch.int64) & _MASK
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    out = torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)
    return out.to(torch.int64) & _MASK


def _bits32(keys: torch.Tensor, shape: tuple[int, ...],
            cols: int | None = None) -> torch.Tensor:
    """int32 words [*keys.shape[:-1], *shape] of `jax.random.bits(key,
    shape, uint32)` for each key row; with `cols`, only the first cols
    entries of the last axis (the counters keep the full shape's
    numbering)."""
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


def random_bits(keys: torch.Tensor, shape: tuple[int, ...],
                cols: int | None = None) -> torch.Tensor:
    """int64 [*keys.shape[:-1], *shape] of 32-bit draws: for each key row
    of `keys` ([..., 2], uint32 words as integers), the draws that
    `jax.random.bits(key, shape, uint32)` gives; with `cols`, only the
    first cols entries of the last axis."""
    return _bits32(keys, shape, cols).to(torch.int64) & _MASK


def uniform(keys: torch.Tensor, shape: tuple[int, ...],
            cols: int | None = None) -> torch.Tensor:
    """f32 uniforms in [0, 1), one block of `shape` per key row: equal to
    `jax.random.uniform(key, shape, jnp.float32)` for each key; with
    `cols`, only the first cols entries of the last axis."""
    fbits = _bits32(keys, shape, cols).bitwise_right_shift_(9) \
        .bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    return fbits.view(torch.float32) - 1.0
