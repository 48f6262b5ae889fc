"""The general traffic generator: a pool of tumour samples from a
configuration (the deployment: contigs, binning, noise) and a traffic mix
(purity, events, copy numbers).

A sample is what CanvasPartition receives: contig -> f32 bin values.
The pool is drawn whole from the mix's design_seed, the same for every
run: each sample's event count, purity and depth (or noise level), evenly
spaced over the mix's ranges; its events, their lengths evenly spaced and
their copy numbers taken in turn from the mix's list, placed on the
contigs by length; and every bin's noise.  The run's seed draws only the
order in which the window takes the samples, so every seed does the same
work, and which samples the check draws.

Configuration kinds:
  bins.kind "fixed"     fixed-size bins of bin_bp: a contig holds
                        length // bin_bp bins.
  bins.kind "targets"   a manifest's targets, per_contig[contig] of them
                        a contig.
  coverage.kind "negative_binomial"  read counts around depth x bin_bp /
                        read_length x the sample's copy ratio (depth drawn
                        a sample from coverage.depth), with the negative
                        binomial's moments (size coverage.size), drawn as
                        a rounded normal clipped at 0; fixed bins only.
  coverage.kind "ratio_pseudo_counts"  f32(ratio x counts_per_ratio), the
                        ratio the copy ratio times 2^N(0, sd), sd drawn a
                        sample from coverage.log2_sd.
"""

from __future__ import annotations

import numpy as np
import torch


def _spaced(lo: float, hi: float, k: int) -> np.ndarray:
    """k values evenly spaced over [lo, hi], at the centres of k cells."""
    return lo + (hi - lo) * (np.arange(k) + 0.5) / k


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for the seed (any integer) and a stream number."""
    return np.random.default_rng([seed % (1 << 64), stream])


def contig_bins(config: dict) -> dict[str, int]:
    """Bins a contig."""
    bins = config["bins"]
    if bins["kind"] == "fixed":
        return {c: length // bins["bin_bp"]
                for c, length in config["contigs"].items()}
    if bins["kind"] == "targets":
        return {c: int(bins["per_contig"][c]) for c in config["contigs"]}
    raise ValueError(f"unknown bins kind {bins['kind']!r}")


def _levels(config: dict) -> tuple[float, float]:
    """The range of the per-sample level: depth, or the log2 noise sd."""
    cov = config["coverage"]
    return tuple(cov["depth"] if cov["kind"] == "negative_binomial"
                 else cov["log2_sd"])


def _copy_numbers(config: dict, mix: dict, nbins: dict[str, int],
                  n_events: int, rng: np.random.Generator) -> dict:
    """Per contig, the tumour copy number of every bin: 2, with n_events
    events.  round(arm_share x n_events) of them are arm-level, the rest
    focal; their lengths are evenly spaced over the mix's ranges and their
    copy numbers taken in turn from its list; `rng` draws their order,
    the first copy number, each event's contig (by contig length) and its
    start."""
    contigs = config["contigs"]
    names = list(contigs)
    lengths = np.asarray([contigs[c] for c in names], np.float64)
    cn = {c: np.full(nbins[c], 2, np.int64) for c in names}
    n_arm = int(round(mix["arm_share"] * n_events))
    arm_cns = [c for c in mix["copy_numbers"] if c not in mix["focal_only"]]
    events = [(bp, arm_cns) for bp in _spaced(*mix["arm_bp"], n_arm)] + \
        [(bp, mix["copy_numbers"])
         for bp in _spaced(*mix["focal_bp"], n_events - n_arm)]
    turn = int(rng.integers(0, 1 << 16))
    for e in rng.permutation(len(events)):
        bp, cns = events[e]
        c = names[int(rng.choice(len(names), p=lengths / lengths.sum()))]
        n = nbins[c]
        k = min(n, max(mix["min_event_bins"],
                       int(round(bp * n / contigs[c]))))
        start = int(rng.integers(0, n - k + 1))
        cn[c][start:start + k] = cns[(turn + int(e)) % len(cns)]
    return cn


def _values(config: dict, ratio: torch.Tensor, level: float,
            gen: torch.Generator) -> torch.Tensor:
    """f32 bin values around the copy ratios `ratio` (f32, on the
    generator's device)."""
    z = torch.randn(ratio.shape, generator=gen, device=ratio.device)
    cov = config["coverage"]
    if cov["kind"] == "negative_binomial":
        # the negative binomial's mean and variance, drawn as a rounded
        # normal clipped at 0
        mu = level * config["bins"]["bin_bp"] / cov["read_length"] * ratio
        sd = torch.sqrt(mu + mu * mu / cov["size"])
        return torch.clamp(torch.round(mu + sd * z), min=0.0)
    if cov["kind"] == "ratio_pseudo_counts":
        r = ratio * torch.exp2(level * z)
        return (r.double() * cov["counts_per_ratio"]).float()
    raise ValueError(f"unknown coverage kind {cov['kind']!r}")


def make_pool(config: dict, mix: dict, seed: int,
              device: torch.device) -> list[dict]:
    """The run's pool of mix["pool"] samples, each contig -> f32 numpy
    values.  The samples come from the mix's design_seed, the noise from
    a torch.Generator on `device`, one call a sample; the run's seed draws
    their order."""
    k = mix["pool"]
    design = rng_of(mix["design_seed"])
    lo, hi = mix["events"]
    events = lo + np.floor((hi - lo + 1) * (np.arange(k) + 0.5) / k) \
        .astype(np.int64)
    purity = _spaced(*mix["purity"], k)
    level = _spaced(*_levels(config), k)
    events, purity, level = (design.permutation(v) for v in (events, purity,
                                                            level))
    gen = torch.Generator(device=device)
    gen.manual_seed(mix["design_seed"])
    names = list(config["contigs"])
    nbins = contig_bins(config)
    ends = np.cumsum([nbins[c] for c in names])
    pool = []
    for i in range(k):
        cn = _copy_numbers(config, mix, nbins, int(events[i]),
                           rng_of(mix["design_seed"], i + 1))
        cat = np.concatenate([cn[c] for c in names]).astype(np.float32)
        ratio = ((purity[i] * cat + (1.0 - purity[i]) * 2.0) / 2.0) \
            .astype(np.float32)
        vals = _values(config, torch.as_tensor(ratio, device=device),
                       float(level[i]), gen).cpu().numpy()
        pool.append(dict(zip(names, np.split(vals, ends[:-1]))))
    return [pool[i] for i in rng_of(seed).permutation(k)]


def sample_bins(sample: dict) -> int:
    return sum(len(v) for v in sample.values())
