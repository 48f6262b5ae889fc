"""Variable-width coverage binning — the CanvasBin compute stage.

The reference walks every genome position sequentially, accumulating
unique-35-mer ("possible") positions until `binSize` of them have been seen,
then emits a bin (CanvasBin.cs:568-661 BinCountsForChromosome).  That loop is
inherently parallel: the bin index of every position is a function of the
*prefix count* of possible positions, so on the device the whole stage
becomes

    pcum    = cumsum(possible)                      # one fused pass (B1)
    ends[k] = searchsorted(pcum, (k+1)*binSize)     # boundary positions
    count   = diff-of-cumsum of capped observed hits at the boundaries
    gc      = diff-of-cumsum of GC flags at the boundaries

No sequential dependency, no dynamic shapes (bin count bounded by
total_possible // binSize, known on host before the device pass).

Semantics matched to the reference:
  * leading lowercase-'n' skip (CanvasBin.cs:582-583);
  * NucleotideCount counts EVERY position in a bin's span — the reference
    compares a char against the string "n" (CanvasBin.cs:592), which is
    always false, so 'n' bases are not excluded from the GC denominator;
  * GC% = trunc(100f * gcCount / nucleotideCount) (CanvasBin.cs:638);
  * TruncatedDynamicRange caps each possible position's hit count at 10
    (CanvasBin.cs:618-625); GCContentWeighted divides by the per-read-GC
    observed/expected ratio, caps at 10, and banker's-rounds the bin total
    (CanvasBin.cs:626-636);
  * the trailing partial bin is dropped;
  * bin size = countsPerBin / median(autosome observed/possible rates)
    (CanvasBin.cs:30-83; observed = positions with >=1 hit).
"""

from __future__ import annotations

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.ops import prefix_cuda, stats
from canvas_tpu_torch.parallel.mesh import lane_devices

TRUNCATED_CAP = 10


# ---------------------------------------------------------------------------
# Bin-size estimation
# ---------------------------------------------------------------------------

def _gc_pct_host(gc_count: np.ndarray, nuc: np.ndarray) -> np.ndarray:
    """(int)(100f * gcCount / nucleotideCount) (CanvasBin.cs:638) in IEEE
    f32 on the HOST, with numpy's correctly-rounded divide; the device
    path ships integer GC counts and leaves the divide to this function."""
    return (np.float32(100.0) * gc_count.astype(np.float32)
            / nuc.astype(np.float32)).astype(np.int16)


def contig_rate(possible: np.ndarray, observed: np.ndarray) -> float:
    """Observed/possible rate for one contig (CanvasBin.cs:55-60)."""
    n_pos = int(np.count_nonzero(possible))
    n_obs = int(np.count_nonzero(observed))
    return n_obs / n_pos if n_pos else 0.0


def bin_size_from_rates(counts_per_bin: int, rates: list[float]) -> int:
    """binSize = int(countsPerBin / median(rates)) (CanvasBin.cs:79-83)."""
    return int(counts_per_bin / stats.median(rates))


# ---------------------------------------------------------------------------
# Host (numpy) binning — exact reference semantics, used for parity tests.
# ---------------------------------------------------------------------------

def leading_n_offset(is_lower_n: np.ndarray) -> int:
    """Index of the first position that is not a lowercase 'n'."""
    nz = np.flatnonzero(~is_lower_n)
    return int(nz[0]) if nz.size else len(is_lower_n)


def bin_contig_np(
    possible: np.ndarray,
    observed: np.ndarray,
    is_gc: np.ndarray,
    bin_size: int,
    offset: int = 0,
    mode: str = "TruncatedDynamicRange",
    gc_weights: np.ndarray | None = None,
):
    """Reference-parallel numpy binning.  Returns (start, end, gc, count).

    Narrow dtypes and sampled inclusive cumsums keep this memory-bound pass
    cheap at genome scale (the previous int64/f64 cumsums + full-length
    prepend copies cost ~25s per 60 Mbp contig on 2 vCPU; this form ~1s).
    The uint32 observed-cumsum may wrap on huge contigs — safe, because
    per-bin counts are prefix *differences*, exact under modular arithmetic
    (each bin sum <= cap*bin_size << 2^31); pcum itself never wraps
    (contig length < 2^31) so searchsorted stays monotone."""
    possible = np.asarray(possible)[offset:].astype(bool, copy=False)
    pcum = possible.cumsum(dtype=np.int32)
    total = int(pcum[-1]) if len(pcum) else 0
    n_bins = total // bin_size
    if n_bins == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.int16), z.astype(np.float32)
    targets = np.arange(1, n_bins + 1, dtype=np.int32) * bin_size
    ends_rel = np.searchsorted(pcum, targets, side="left")  # boundary pos (rel)
    ends = ends_rel + offset                                # inclusive boundary
    starts = np.concatenate([[offset], ends[:-1] + 1])

    gccum = np.asarray(is_gc).cumsum(dtype=np.int32)        # inclusive
    prev = np.maximum(starts - 1, 0)
    gc_count = gccum[ends] - np.where(starts > 0, gccum[prev], 0)
    nuc_count = (ends + 1) - starts
    gc_pct = (np.float32(100.0) * gc_count.astype(np.float32)
              / nuc_count.astype(np.float32)).astype(np.int16)

    observed = np.asarray(observed)
    if mode == "GCContentWeighted":
        assert gc_weights is not None
        vals = np.where(
            possible,
            np.minimum(TRUNCATED_CAP,
                       observed[offset:].astype(np.float64)
                       / gc_weights[offset:]), 0.0)
        ocum = vals.cumsum()                                # inclusive f64
    else:
        o = observed[offset:]
        if mode == "TruncatedDynamicRange":
            o = np.minimum(o, TRUNCATED_CAP)
        if np.issubdtype(o.dtype, np.integer):
            ocum = np.where(possible, o, 0).cumsum(dtype=np.uint32)
        else:  # float-typed counts (e.g. fragment tracks): exact in f64
            ocum = np.where(possible, o.astype(np.float64), 0.0).cumsum()
    ce = ocum[ends_rel]                                     # per-bin prefixes
    # diff in the cumsum dtype FIRST: uint32 subtraction wraps modularly,
    # which is what makes a wrapped prefix still yield exact bin sums
    counts = np.diff(ce, prepend=ce.dtype.type(0)).astype(np.float64)
    if mode == "GCContentWeighted":
        counts = np.round(counts)  # banker's rounding, matches C# Math.Round
    return starts, ends + 1, gc_pct, counts.astype(np.float32)


# ---------------------------------------------------------------------------
# Device (torch) binning — kernel B1 + searchsorted + prefix differences.
# ---------------------------------------------------------------------------

def bin_contig_device_fused(
    p_bits: torch.Tensor,    # uint8 [Lp/8] bit-packed possible
    obs: torch.Tensor,       # uint8 [Lp] observed counts
    gc_bits: torch.Tensor,   # uint8 [Lp/8] bit-packed G/C flags
    offset: int,             # leading-n skip (for starts[0])
    real_len: int,           # contig length before padding
    bin_size: int,
    max_bins: int,
    cap: int = TRUNCATED_CAP,
) -> torch.Tensor:
    """Fused device binning: one pass of kernel B1 computes all three prefix
    arrays (ops/prefix_cuda.py), then bin boundaries by searchsorted and
    per-bin sums by prefix differences.  Exact for the integer coverage
    modes (TDR cap=10, Binary cap=1).

    Returns one int32 [5, max_bins] tensor — rows (start, end, gc_count,
    count, valid) — so the host needs a single device-to-host copy."""
    pcum, ocum, gccum = prefix_cuda.fused_prefix_sums(
        p_bits, obs, gc_bits, offset, real_len, cap)
    dev = pcum.device
    total = pcum[real_len - 1]
    n_bins = total // bin_size

    k = torch.arange(max_bins, dtype=torch.int32, device=dev)
    valid = k < n_bins
    targets = (k + 1) * bin_size
    ends = torch.searchsorted(pcum, targets, right=False)
    ends = torch.clamp(ends, max=real_len - 1)
    starts = torch.cat([torch.full((1,), offset, dtype=ends.dtype,
                                   device=dev), ends[:-1] + 1])
    prev = torch.clamp(starts - 1, min=0)
    has_prev = starts > 0

    def diff(cum: torch.Tensor) -> torch.Tensor:
        # prefix differences modulo 2^32: exact, since every bin sum is far
        # below 2^31 even where the prefixes themselves wrapped
        hi = cum[ends].to(torch.int64)
        lo = torch.where(has_prev, cum[prev].to(torch.int64), 0)
        return ((hi - lo) & 0xFFFFFFFF).to(torch.int32)

    # integer GC COUNT only — the percent's f32 divide happens on host
    gc_count = diff(gccum)
    # obs is masked by `possible` inside the kernel and possible is zeroed
    # before `offset`, so ocum[offset-1] == 0 and the diff is exact
    counts = diff(ocum)

    zi = torch.zeros((), dtype=torch.int32, device=dev)
    return torch.stack([
        torch.where(valid, starts.to(torch.int32), zi),
        torch.where(valid, (ends + 1).to(torch.int32), zi),
        torch.where(valid, gc_count, zi),
        torch.where(valid, counts, zi),
        valid.to(torch.int32),
    ])


def bin_contig_weighted(
    possible: torch.Tensor,  # bool [L]
    capped: torch.Tensor,    # float32 [L] capped per-position hit values
    is_gc: torch.Tensor,     # bool [L]
    offset: int,             # leading-n skip
    bin_size: int,
) -> tuple[torch.Tensor, ...]:
    """Device binning of float-valued counts (GCContentWeighted), the
    counterpart of canvas_tpu's non-fused pass: bins by searchsorted on the
    int32 prefix of possible positions, as in bin_contig_device_fused.

    A possible position belongs to bin k when its prefix lies in
    (k*bin_size, (k+1)*bin_size], so the live possible positions, gathered
    in order, fall into bins of exactly bin_size each: the first
    n_bins * bin_size of their capped values, viewed [n_bins, bin_size], are
    the bins' members.  Each row is summed in float32 in position order, one
    column added to all bins at a time, and banker's-rounded (C#
    Math.Round): the same IEEE adds in the same order on every device, so
    the counts are equal on CUDA and the CPU and equal to canvas_tpu's
    float32 segment sum.  torch.sum and torch.cumsum would not do: their
    order and accumulator differ by device.

    Returns (start, end, gc_count, count) for the whole bins: int64 starts
    and exclusive ends, int32 GC counts, float32 rounded counts."""
    dev = possible.device
    L = possible.shape[0]
    p = possible.clone()
    p[:offset] = False
    pcum = torch.cumsum(p, 0, dtype=torch.int32)
    total = int(pcum[-1]) if L else 0
    n_bins = total // bin_size
    if n_bins == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z.to(torch.int32), z.to(torch.float32)
    targets = torch.arange(1, n_bins + 1, dtype=torch.int32,
                           device=dev) * bin_size
    ends = torch.searchsorted(pcum, targets, right=False)
    starts = torch.cat([torch.full((1,), offset, dtype=ends.dtype,
                                   device=dev), ends[:-1] + 1])
    gccum0 = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(is_gc, 0, dtype=torch.int32)])
    gc_count = gccum0[ends + 1] - gccum0[starts]
    # [bin_size, n_bins]: each step adds one contiguous row to every bin
    cols = capped[p][:n_bins * bin_size].view(n_bins, bin_size).T.contiguous()
    acc = cols[0].clone()
    for j in range(1, bin_size):
        acc += cols[j]
    return starts, ends + 1, gc_count, torch.round(acc)


def _bin_weighted(t: dict, bin_size: int, dev: torch.device):
    """One contig of GCContentWeighted binning on `dev`: per-position
    values min(10, observed / weight) in float32 (CanvasBin.cs:626-636),
    then bin_contig_weighted."""
    obs = torch.as_tensor(np.asarray(t["observed"], dtype=np.uint8)).to(dev)
    weights = torch.as_tensor(
        np.asarray(t["gc_weights"], dtype=np.float32)).to(dev)
    capped = torch.clamp(obs.to(torch.float32) / weights, max=TRUNCATED_CAP)
    s, e, g, c = bin_contig_weighted(
        torch.as_tensor(np.asarray(t["possible"], dtype=bool)).to(dev),
        capped, torch.as_tensor(np.asarray(t["is_gc"], dtype=bool)).to(dev),
        int(t["offset"]), bin_size)
    s, e = s.cpu().numpy(), e.cpu().numpy()
    return (s, e, _gc_pct_host(g.cpu().numpy(), e - s),
            c.cpu().numpy().astype(np.float32))


_FUSED_CAPS = {"TruncatedDynamicRange": TRUNCATED_CAP, "Binary": 1}


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# Device-resident copies of the constant reference tracks, keyed by the id
# of the host `possible` array and the device (entries hold a strong
# reference so the id stays valid; the cache is size-capped).
# possible/is_gc never change between samples, so only `observed` crosses
# to the device per sample.
# NOTE: assumes the host arrays are not mutated after first use (the
# runner's filter-bed zeroing happens at context init, before binning).
_DEVICE_TRACKS: dict[tuple, tuple] = {}


def _device_ref_tracks(possible: np.ndarray, is_gc: np.ndarray, pad: int,
                       device: torch.device):
    """(packed_possible_dev, packed_is_gc_dev, total_possible) with caching.
    Tracks cross to the device bit-packed (np.packbits order) and are
    unpacked inside kernel B1."""
    key = (id(possible), str(device))
    hit = _DEVICE_TRACKS.get(key)
    if hit is not None and hit[0] is possible and hit[1] == pad:
        return hit[2], hit[3], hit[4]
    p = np.asarray(possible, dtype=bool)
    g = np.asarray(is_gc, dtype=bool)
    if pad:
        p = np.pad(p, (0, pad))
        g = np.pad(g, (0, pad))
    total = int(np.count_nonzero(p))
    dp = torch.as_tensor(prefix_cuda.pack_bits(p)).to(device)
    dg = torch.as_tensor(prefix_cuda.pack_bits(g)).to(device)
    # the cap covers contigs x devices (24 x 8 = 192 on an 8-card host)
    if len(_DEVICE_TRACKS) >= 256:
        _DEVICE_TRACKS.pop(next(iter(_DEVICE_TRACKS)))
    _DEVICE_TRACKS[key] = (possible, pad, dp, dg, total)
    return dp, dg, total


def contig_placement(tracks: dict[str, dict],
                     devices: list[torch.device]) -> dict[str, torch.device]:
    """Contigs round-robin over `devices`, longest first (the reference's
    process-per-chromosome fan-out, CanvasRunner.cs:333-389, and its
    OrderByDescending launch order, :343), so the long poles start
    first."""
    order = sorted(tracks, key=lambda c: -len(tracks[c]["possible"]))
    return {c: devices[i % len(devices)] for i, c in enumerate(order)}


def bin_sample(
    tracks: dict[str, dict],
    bin_size: int,
    mode: str = "TruncatedDynamicRange",
    force_fused: bool | None = None,
    device: str | torch.device = "cuda",
    devices=None,
):
    """Bin all contigs of one sample.

    `tracks[contig]` holds {"possible": bool[L], "observed": uint8[L],
    "is_gc": bool[L], "offset": int} and, for GCContentWeighted,
    "gc_weights": float32[L].  Returns dict contig -> (start, end, gc,
    count) numpy arrays.

    On a CUDA device the fused path runs kernel B1.  On the CPU the exact
    numpy path (bin_contig_np) runs by default, as in canvas_tpu;
    `force_fused=True` runs the fused path with B1's plain torch version.
    Both are exact (int32 prefix differences), so outputs are identical.
    GCContentWeighted takes bin_contig_weighted on the run's device, CUDA
    or CPU, as canvas_tpu takes its non-fused device pass on every backend.
    The device is resolved first: asking for a missing card raises.

    The fused path places the contigs round-robin (contig_placement) over
    the lane devices of parallel.mesh.lane_devices(device, devices): every
    visible card for an unindexed "cuda", the `devices` mesh where one is
    given (whose first device is then the run's device), one device with
    sharding disabled.  An indexed "cuda:k" pins every contig to card k.
    Each contig's B1 launches on its own device; every contig is
    dispatched before any result is copied back.
    """
    devs = lane_devices(device, devices)
    dev = resolve_device(device) if devices is None else devs[0]
    use_fused = (dev.type == "cuda") if force_fused is None else force_fused
    if mode == "GCContentWeighted":
        return {name: _bin_weighted(t, bin_size, dev)
                for name, t in tracks.items()}
    if mode not in _FUSED_CAPS:
        raise ValueError(f"unknown coverage mode {mode!r}")
    out = {}
    pending: dict[str, torch.Tensor] = {}
    host_batch: list[str] = []
    placement = contig_placement(tracks, devs) if use_fused else {}
    for name, t in tracks.items():
        if use_fused:
            off = int(t["offset"])
            L = len(t["possible"])
            pad = (-L) % prefix_cuda.TILE
            cdev = placement[name]
            p_dev, gc_dev, total = _device_ref_tracks(
                t["possible"], t["is_gc"], pad, cdev)
            obs_u8 = np.asarray(t["observed"], dtype=np.uint8)
            if pad:
                obs_u8 = np.pad(obs_u8, (0, pad))
            max_bins = _next_pow2(max(total // bin_size, 1))
            # every contig is dispatched before any result is copied back
            pending[name] = bin_contig_device_fused(
                p_dev, torch.as_tensor(obs_u8).to(cdev), gc_dev, off, L,
                bin_size, max_bins, cap=_FUSED_CAPS[mode])
        else:
            # CPU device: the exact numpy path (int-valued cumsums) is
            # byte-identical to the fused path for these integer modes.
            # Deferred and run on a small thread pool below — numpy
            # cumsums release the GIL.
            host_batch.append(name)
    if host_batch:
        def _host_one(name):
            t = tracks[name]
            obs = np.asarray(t["observed"])
            if mode == "Binary":
                obs = np.minimum(obs, 1)
            return bin_contig_np(t["possible"], obs, t["is_gc"], bin_size,
                                 t["offset"], mode)

        if len(host_batch) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(4, len(host_batch))) as ex:
                for name, res in zip(host_batch,
                                     ex.map(_host_one, host_batch)):
                    out[name] = res
        else:
            out[host_batch[0]] = _host_one(host_batch[0])

    for name, packed_dev in pending.items():
        packed = packed_dev.cpu().numpy()       # ONE copy back per contig
        v = packed[4].astype(bool)
        s = packed[0][v].astype(np.int64)
        e = packed[1][v].astype(np.int64)
        out[name] = (s, e, _gc_pct_host(packed[2][v], e - s),
                     packed[3][v].astype(np.float32))
    return out

# ---------------------------------------------------------------------------
# GC-content-weighted coverage mode preparation (CanvasBin.cs:330-506)
# ---------------------------------------------------------------------------

N_GC_BINS = 101


def non_zero_mean(x: np.ndarray) -> int:
    """Utilities.NonZeroMean: truncated integer mean over nonzero entries."""
    nz = x[x > 0]
    if len(nz) == 0:
        return 0
    return int(np.sum(nz, dtype=np.int64) // len(nz))


def mean_fragment_size(fragment_lengths: dict[str, np.ndarray]) -> int:
    """MeanFragmentSize (:155-168): NonZeroMean of per-contig NonZeroMeans."""
    per_chr = np.array([non_zero_mean(v) for v in fragment_lengths.values()],
                       dtype=np.int16)
    return non_zero_mean(per_chr)


def read_gc_content(
    is_gc: np.ndarray,
    fragment_lengths: np.ndarray,
    mean_fragment: int,
    mean_fragment_cutoff: int = 3,
) -> np.ndarray:
    """Per-position forward-fragment GC percent (CanvasBin.cs:450-506):
    window = stored fragment length (clamped at 3x mean; mean when 0);
    gc[pos] = min(100 * gcCount // windowLen, 101); tail positions beyond
    L - 3*mean - 1 stay 0.  Vectorized via prefix sums."""
    L = len(is_gc)
    out = np.zeros(L, dtype=np.uint8)
    limit = L - mean_fragment * mean_fragment_cutoff - 1
    if limit <= 0 or mean_fragment <= 0:
        return out
    frag = fragment_lengths[:limit].astype(np.int64)
    frag = np.where(frag == 0, mean_fragment,
                    np.minimum(frag, mean_fragment * mean_fragment_cutoff))
    gccum = np.concatenate([[0], np.cumsum(is_gc.astype(np.int64))])
    pos = np.arange(limit, dtype=np.int64)
    ends = np.minimum(pos + frag, L)
    gc_count = gccum[ends] - gccum[pos]
    out[:limit] = np.minimum(100 * gc_count // frag, N_GC_BINS).astype(np.uint8)
    return out


def observed_vs_expected_gc(
    read_gc_by_contig: dict[str, np.ndarray],
    observed_by_contig: dict[str, np.ndarray],
) -> np.ndarray:
    """Per-GC-bin observed/expected correction factors
    (ComputeObservedVsExpectedGC :330-405).  GC values of 101 are counted
    in their own (out-of-range-capped) bin like the reference byte cap."""
    expected = np.zeros(N_GC_BINS + 1, dtype=np.int64)
    observed = np.zeros(N_GC_BINS + 1, dtype=np.int64)
    for chrom, gc in read_gc_by_contig.items():
        if chrom not in observed_by_contig:
            continue
        gc64 = gc.astype(np.int64)
        expected += np.bincount(gc64, minlength=N_GC_BINS + 1)
        observed += np.bincount(
            gc64, weights=observed_by_contig[chrom].astype(np.int64),
            minlength=N_GC_BINS + 1).astype(np.int64)
    expected = expected[:N_GC_BINS]
    observed = observed[:N_GC_BINS]
    sum_obs = observed.sum()
    sum_exp = expected.sum()
    expected = np.where(expected == 0, 1, expected)
    observed = np.where(observed == 0, 1, observed)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (observed.astype(np.float32) / expected.astype(np.float32)) \
            * (np.float32(sum_exp) / np.float32(max(sum_obs, 1)))
    return ratio.astype(np.float32)


def gc_weights_for_contig(read_gc: np.ndarray,
                          obs_vs_exp: np.ndarray) -> np.ndarray:
    """Per-position weight = observedVsExpectedGC[readGC[pos]]
    (CanvasBin.cs:611)."""
    idx = np.minimum(read_gc.astype(np.int64), N_GC_BINS - 1)
    return obs_vs_exp[idx]


def bin_predefined_np(
    possible: np.ndarray,
    observed: np.ndarray,
    is_gc: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    mode: str = "TruncatedDynamicRange",
    gc_weights: np.ndarray | None = None,
):
    """Predefined-bins counting (enrichment manifests; CanvasBin.cs:640-647):
    same per-bin accumulation as variable binning but over given spans.
    Returns (gc, count) arrays aligned with starts/ends."""
    possible = np.asarray(possible, dtype=bool)
    obs = np.asarray(observed, dtype=np.float64)
    if mode == "TruncatedDynamicRange":
        vals = np.where(possible, np.minimum(obs, TRUNCATED_CAP), 0.0)
    elif mode == "GCContentWeighted":
        assert gc_weights is not None
        vals = np.where(possible,
                        np.minimum(TRUNCATED_CAP, obs / gc_weights), 0.0)
    else:
        vals = np.where(possible, obs, 0.0)
    ocum = np.concatenate([[0.0], np.cumsum(vals)])
    gccum = np.concatenate([[0], np.cumsum(is_gc.astype(np.int64))])
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    counts = ocum[ends] - ocum[starts]
    if mode == "GCContentWeighted":
        counts = np.round(counts)
    gc_count = gccum[ends] - gccum[starts]
    nuc = (ends - starts).astype(np.float32)
    gc_pct = (np.float32(100.0) * gc_count.astype(np.float32)
              / np.maximum(nuc, 1)).astype(np.int16)
    return gc_pct, counts.astype(np.float32)
