"""Threefry-2x32 uniforms in torch, equal bit for bit to the JAX package's
`jax.random.uniform(key, shape, float32)` for a raw [2] uint32 key.

The frontier CBS engine (ops/cbs_device.py) draws its permutations from
per-(contig, segment, chunk) keys that it derives on the host
(`_seg_keys_np`).  With the same keys and these draws the port's
permutations are the JAX package's, on the CPU and on a card alike.

The stream, as JAX builds it with partitionable threefry:
  * element k of the flattened shape is hashed from the counter pair
    (hi, lo) = (k >> 32, k & 0xffffffff) with the 20-round Threefry-2x32
    block cipher (Salmon et al., SC'11) under the key (k0, k1);
  * its 32 random bits are the XOR of the two output words;
  * the float is (bits >> 9 | 0x3f800000) read as f32, minus 1.

torch's uint32 lacks shifts on CUDA, so the words live in int64 masked to
32 bits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block on int64 tensors holding uint32
    words; the key words broadcast against the counters."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def random_bits(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """int64 [*keys.shape[:-1], *shape] of 32-bit draws: for each key row
    of `keys` ([..., 2], uint32 words as integers), the draws that
    `jax.random.bits(key, shape, uint32)` gives."""
    n = 1
    for s in shape:
        n *= s
    dev = keys.device
    k = keys.to(torch.int64)
    lead = k.shape[:-1]
    view = (*lead, *([1] * len(shape)))
    k0 = k[..., 0].reshape(view)
    k1 = k[..., 1].reshape(view)
    idx = torch.arange(n, dtype=torch.int64, device=dev).reshape(shape)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return b0 ^ b1


def uniform(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """f32 uniforms in [0, 1), one block of `shape` per key row: equal to
    `jax.random.uniform(key, shape, jnp.float32)` for each key."""
    bits = random_bits(keys, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0
