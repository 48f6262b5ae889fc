"""Fused device pipeline steps: plain functions on tensors.

One function from per-position tracks to bins (binning step), one from
padded per-lane coverage to Viterbi copy-number paths (segmentation step),
per-lane rates, a device copy-number assignment (caller step) and the
whole chain (full_pipeline_step), which the multichip dryrun runs.  Each
runs on the device of its inputs.  Given a `mesh`, the lanes split into
contiguous groups over the mesh's "contig" axis (parallel.mesh), each
group runs on its own device, and the results come back to the inputs'
device in lane order.  Lanes are independent; the genome-wide sums
(total, nvalid, diploid coverage) are added on the host in lane order.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from canvas_tpu_torch.ops import hmm
from canvas_tpu_torch.parallel.mesh import (gather_lanes, lane_devices,
                                            split_lanes)


def _on_lanes(fn, mesh, lane_args: tuple, *shared):
    """fn(*lane_args, *shared) on the whole batch, or, given a mesh, on
    each group of lanes on its own device, gathered back to the device of
    lane_args[0] in lane order.  A lane argument that is a numpy array
    splits the same way and stays on the host.  fn returns a tensor or a
    tuple of tensors with the lanes leading."""
    if mesh is None:
        return fn(*lane_args, *shared)
    devs = lane_devices(devices=mesh)
    parts = [np.split(a, len(devs)) if isinstance(a, np.ndarray)
             else split_lanes(a, devs) for a in lane_args]
    outs = [fn(*[p[k] for p in parts], *shared) for k in range(len(devs))]
    home = lane_args[0].device
    if isinstance(outs[0], tuple):
        return tuple(gather_lanes([o[i] for o in outs], home)
                     for i in range(len(outs[0])))
    return gather_lanes(outs, home)


def _lane_order_sum(per_lane: torch.Tensor) -> np.float32:
    """float32 sum of per-lane values, added on the host in lane order."""
    vals = per_lane.cpu().numpy().astype(np.float32)
    return np.add.accumulate(vals)[-1] if len(vals) else np.float32(0.0)


def _host_model(x) -> np.ndarray:
    return np.asarray(torch.as_tensor(x).cpu().numpy(), np.float32)


def _segment(coverage, mask, lengths, log_tables, log_trans, log_init,
             use_all_states, chunk):
    em = hmm.emissions_from_log_tables(
        coverage, log_tables.to(coverage.device), mask, use_all_states)
    return hmm.viterbi_decode_chunked(em, mask, log_trans, log_init,
                                      chunk=chunk, lengths=lengths)


def segmentation_step(
    coverage: torch.Tensor,    # [B, T, D] clamped coverage lanes
    mask: torch.Tensor,        # [B, T] prefix masks
    log_tables: torch.Tensor,  # [S, D, V] log NB densities
    log_trans,                 # [S, S]
    log_init,                  # [S]
    use_all_states: bool = True,
    n_dim: int = 1,
    chunk: int = 256,
    mesh=None,
) -> torch.Tensor:
    """Emission lookup + chunked Viterbi, the segmentation forward: int32
    [B, T] state paths.  The emission is the genotype-permutation max of
    the table lookups (hmm.emissions_from_log_tables); the decode is
    hmm.viterbi_decode_chunked, kernels B2, K5, B3 and K6 on a CUDA
    device."""
    if n_dim != log_tables.shape[1]:
        raise ValueError(f"n_dim {n_dim} differs from the tables' "
                         f"{log_tables.shape[1]} samples")
    # the mask's one read, before any launch of the step: the decodes read
    # nothing back, so every lane group is queued before a path is read
    lengths = hmm.prefix_lengths(mask.cpu())
    return _on_lanes(
        _segment, mesh, (coverage, mask, lengths), log_tables,
        _host_model(log_trans), _host_model(log_init), use_all_states, chunk)


def _bin_lanes(possible, capped_obs, is_gc, offsets, bin_size, max_bins):
    out = [_bin_lane(p, o, g, int(off), bin_size, max_bins)
           for p, o, g, off in zip(possible, capped_obs, is_gc, offsets)]
    return tuple(torch.stack(col) for col in zip(*out))


def _bin_lane(possible, capped_obs, is_gc, offset, bin_size, max_bins):
    """canvas_tpu's bin_contig_device for one lane: bins by searchsorted on
    the int32 prefix of the possible positions at or after `offset`; each
    bin's count is the float32 sum of its members' values in position
    order (one column of the [n_bins, bin_size] members added at a time),
    the IEEE adds of XLA's CPU segment sum."""
    dev = possible.device
    L = possible.shape[0]
    p = possible & (torch.arange(L, device=dev) >= offset)
    pcum = torch.cumsum(p, 0, dtype=torch.int32)
    n_bins = pcum[-1] // bin_size
    k = torch.arange(max_bins, dtype=torch.int32, device=dev)
    valid = k < n_bins
    ends = torch.searchsorted(pcum, (k + 1) * bin_size, right=False)
    ends = torch.clamp(ends, max=L - 1)
    starts = torch.cat([torch.full((1,), offset, dtype=ends.dtype,
                                   device=dev), ends[:-1] + 1])
    gccum0 = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(is_gc, 0, dtype=torch.int32)])
    gc_count = gccum0[ends + 1] - gccum0[starts]
    counts = torch.zeros(max_bins, dtype=torch.float32, device=dev)
    nb = min(int(n_bins), max_bins)
    if nb:
        cols = capped_obs.to(torch.float32)[p][:nb * bin_size] \
            .view(nb, bin_size).T.contiguous()
        acc = cols[0].clone()
        for j in range(1, bin_size):
            acc += cols[j]
        counts[:nb] = acc
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    return (torch.where(valid, starts.to(torch.int32), zi),
            torch.where(valid, (ends + 1).to(torch.int32), zi),
            torch.where(valid, gc_count, zi),
            counts,                       # 0 beyond the whole bins
            valid)


def binning_step(
    possible: torch.Tensor,    # [C, L] bool, per-contig position tracks
    capped_obs: torch.Tensor,  # [C, L] float32
    is_gc: torch.Tensor,       # [C, L] bool
    offsets: torch.Tensor,     # [C] int32
    bin_size: int,
    max_bins: int,
    mesh=None,
):
    """Variable-width binning of padded contig lanes.  Returns (start,
    end, gc, count, valid), each [C, max_bins]: int32 starts, exclusive
    ends and GC counts, float32 counts, bool valid; 0 where not valid."""
    return _on_lanes(partial(_bin_lanes, bin_size=bin_size,
                             max_bins=max_bins),
                     mesh, (possible, capped_obs, is_gc, offsets))


def _rates(possible, observed):
    n_obs = torch.sum(observed > 0, dim=-1, dtype=torch.int32)
    n_pos = torch.sum(possible, dim=-1, dtype=torch.int32)
    return n_obs / torch.clamp(n_pos, min=1)


def rate_step(possible: torch.Tensor, observed: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """Per-contig observed/possible rates [C] (CanvasBin.cs:55-60),
    float32."""
    return _on_lanes(_rates, mesh, (possible, observed))


def _segment_means(states, coverage, valid):
    """Per lane: each bin's mean coverage over its Viterbi run (valid bins
    only), the lane's valid coverage sum and valid count."""
    C, T = states.shape
    dev = states.device
    first = torch.cat([torch.ones((C, 1), dtype=torch.bool, device=dev),
                       states[:, 1:] != states[:, :-1]], dim=1)
    seg_id = torch.cumsum(first, dim=1, dtype=torch.int64) - 1
    flat = (seg_id + T * torch.arange(C, device=dev)[:, None]).reshape(-1)
    w = valid.to(torch.float32)
    s = torch.zeros(C * T, dtype=torch.float32, device=dev) \
        .index_add_(0, flat, (coverage * w).reshape(-1))
    n = torch.zeros(C * T, dtype=torch.float32, device=dev) \
        .index_add_(0, flat, w.reshape(-1))
    seg_cov = (s / torch.clamp(n, min=1.0))[flat].reshape(C, T)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lane_sum = torch.where(valid, coverage, zero).sum(dim=1)
    return seg_cov, lane_sum, valid.sum(dim=1)


def _nearest_cn(seg_cov, diploid_cov, max_cn):
    dev = seg_cov.device
    diploid = torch.tensor(diploid_cov, dtype=torch.float32, device=dev)
    weight = torch.tensor(np.float32(0.6) / max(diploid_cov,
                                                np.float32(1e-6)),
                          dtype=torch.float32, device=dev)
    cn = torch.arange(max_cn + 1, dtype=torch.float32, device=dev)
    model_cov = diploid * cn / 2.0
    t = (model_cov[None, None] - seg_cov[..., None]) * weight
    return torch.argmin(t * t, dim=-1).to(torch.int32)


def caller_step(
    states: torch.Tensor,    # [C, T] Viterbi state path per lane
    coverage: torch.Tensor,  # [C, T] normalized bin coverage
    valid: torch.Tensor,     # [C, T]
    max_cn: int = 10,
    mesh=None,
) -> torch.Tensor:
    """Device diploid-caller assignment (CanvasDiploidCaller.cs:125-179):
    per Viterbi run, the mean valid coverage -> the nearest CN model, where
    model coverage = diploidCoverage * CN/2 and distance weight
    0.6/diploidCoverage; diploidCoverage is the genome-wide mean of the
    valid bins.  Returns int32 [C, T] called CN per bin (first nearest
    model on ties)."""
    seg_cov, lane_sum, lane_n = _on_lanes(_segment_means, mesh,
                                          (states, coverage, valid))
    n_valid = max(int(lane_n.sum()), 1)
    diploid_cov = _lane_order_sum(lane_sum) / np.float32(n_valid)
    return _on_lanes(_nearest_cn, mesh, (seg_cov,), diploid_cov, max_cn)


def full_pipeline_step(
    possible, observed, is_gc, offsets, bin_size: int, max_bins: int,
    log_tables, log_trans, log_init, mesh=None):
    """Binning -> per-lane bin counts -> genome-wide scale -> Viterbi ->
    caller: one chain from position tracks to per-bin called copy numbers,
    run by the multichip dryrun.  Returns (states, called CN, (start, end,
    gc, count, valid))."""
    zero = torch.zeros((), dtype=torch.float32, device=observed.device)
    capped = torch.where(possible, torch.clamp(observed, max=10.0), zero)
    start, end, gc, counts, valid = binning_step(
        possible, capped, is_gc, offsets, bin_size, max_bins, mesh=mesh)
    total = _lane_order_sum(torch.where(valid, counts, zero).sum(dim=1))
    n_valid = max(int(valid.sum()), 1)
    mean_count = total / np.float32(n_valid)
    scale = np.float32(100.0) / max(mean_count, np.float32(1e-6))
    norm = counts * torch.tensor(scale, dtype=torch.float32,
                                 device=counts.device)
    states = segmentation_step(norm[..., None], valid, log_tables,
                               log_trans, log_init, mesh=mesh)
    called_cn = caller_step(states, norm, valid, mesh=mesh)
    return states, called_cn, (start, end, gc, counts, valid)
