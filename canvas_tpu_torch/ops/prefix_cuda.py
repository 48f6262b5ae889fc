"""Fused prefix sums of the binning stage: kernel B1 and its plain version.

For one contig padded to Lp positions, three inclusive int32 prefixes:

    pcum  = cumsum(possible masked to [offset, real_len))
    ocum  = cumsum(min(observed, cap) * that masked possible)
    gccum = cumsum(is_gc)                       (unmasked, like the oracle)

`possible` and `is_gc` come bit-packed in np.packbits order (8 consecutive
positions per byte, first position in the most significant bit), `observed`
as one uint8 per position.  ocum and gccum wrap modulo 2^32 (stored as
int32 bits); callers only take differences.  pcum is bounded by the contig
length, so it stays monotone for searchsorted.

On a CUDA tensor `fused_prefix_sums` launches csrc/prefix_scan.cu (one
single-pass scan with decoupled look-back); on a CPU tensor it runs
`fused_prefix_sums_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from canvas_tpu_torch.ops import cuda_lib

# Lp must be a multiple of TILE (the kernel's positions per block).
TILE = 4096

# launches of the kernel, counted by the wrapper
LAUNCHES = {"prefix_scan": 0}

_SIGNATURES = {
    "prefix_scan": [ctypes.c_void_p] * 7
    + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p],
    "prefix_scan_tile": [],
}


def pack_bits(x: np.ndarray) -> np.ndarray:
    """bool [Lp] -> uint8 [Lp/8] in np.packbits order."""
    return np.packbits(np.asarray(x, dtype=bool))


def _unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [Lp/8] -> int64 [Lp] of 0/1, first position in the MSB."""
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.int64)
    return ((packed.to(torch.int64)[:, None] >> shifts) & 1).reshape(-1)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 two's-complement bits (modulo 2^32)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def fused_prefix_sums_plain(p_bits: torch.Tensor, obs: torch.Tensor,
                            gc_bits: torch.Tensor, offset: int,
                            real_len: int, cap: int):
    """Plain torch version of kernel B1 (same inputs, same outputs)."""
    p = _unpack_bits(p_bits)
    g = _unpack_bits(gc_bits)
    pos = torch.arange(p.shape[0], device=p.device)
    p = p * ((pos >= offset) & (pos < real_len))
    o = torch.clamp(obs.to(torch.int64), max=cap) * p
    return tuple(_wrap_int32(torch.cumsum(x, 0)) for x in (p, o, g))


def fused_prefix_sums(p_bits: torch.Tensor, obs: torch.Tensor,
                      gc_bits: torch.Tensor, offset: int, real_len: int,
                      cap: int):
    """(pcum, ocum, gccum), each int32 [Lp].

    p_bits / gc_bits: uint8 [Lp/8]; obs: uint8 [Lp]; the live range is
    [offset, real_len).  On CUDA, Lp must be a multiple of TILE."""
    n_pos = obs.shape[0]
    if obs.dim() != 1 or p_bits.shape != (n_pos // 8,) \
            or gc_bits.shape != (n_pos // 8,) or n_pos % 8:
        raise ValueError(
            f"shapes: obs {tuple(obs.shape)}, p_bits {tuple(p_bits.shape)}, "
            f"gc_bits {tuple(gc_bits.shape)}; want [Lp], [Lp/8], [Lp/8]")
    if not 0 <= cap <= 255:
        raise ValueError(f"cap {cap} out of range")
    if obs.device.type == "cpu":
        return fused_prefix_sums_plain(p_bits, obs, gc_bits, offset,
                                       real_len, cap)
    dev = obs.device
    for name, x in (("p_bits", p_bits), ("obs", obs), ("gc_bits", gc_bits)):
        cuda_lib.require_cuda_tensor(name, x, torch.uint8, dev)
    if n_pos % TILE:
        raise ValueError(f"Lp={n_pos} is not a multiple of {TILE}")
    if obs.data_ptr() % 16:
        raise ValueError("obs must be 16-byte aligned")
    if p_bits.data_ptr() % 2 or gc_bits.data_ptr() % 2:
        raise ValueError("p_bits and gc_bits must be 2-byte aligned")
    lib = cuda_lib.load("prefix_scan", _SIGNATURES)
    if lib.prefix_scan_tile() != TILE:
        raise RuntimeError("prefix_scan.cu tile size differs from TILE")
    pcum, ocum, gccum = (torch.empty(n_pos, dtype=torch.int32, device=dev)
                         for _ in range(3))
    # the tile counter and three status words per tile, cleared by the
    # entry point with one cudaMemsetAsync
    state = torch.empty(1 + 3 * (n_pos // TILE), dtype=torch.int64,
                        device=dev)
    status = cuda_lib.launch(
        dev, lib.prefix_scan,
        p_bits.data_ptr(), obs.data_ptr(), gc_bits.data_ptr(),
        pcum.data_ptr(), ocum.data_ptr(), gccum.data_ptr(), state.data_ptr(),
        n_pos, int(offset), int(real_len), int(cap))
    cuda_lib.check(status, "prefix_scan")
    LAUNCHES["prefix_scan"] += 1
    return pcum, ocum, gccum
