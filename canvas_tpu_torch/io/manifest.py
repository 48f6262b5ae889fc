"""Targeted-panel manifest support (Nextera manifest / BED).

The reference's enrichment modes drive binning and normalization off an
Isas NexteraManifest: 1-based inclusive target regions per chromosome.
This module parses both the Nextera TSV layout ([Regions]/[Targets]
section with Name/Chromosome/Start/End columns) and plain BED, and
implements the on-target sweeps:

  * GetOnTargetBins (EnrichmentUtilities.cs:16-56);
  * the partitioned-bin <-> target intersection
    (CanvasRunner.IntersectBinsWithTargetedRegions :549-616);
  * predefined bins: one bin per target region for enrichment binning
    (CanvasBin predefined-bins path, CanvasBin.cs:640-647).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from canvas_tpu_torch.io.bins import BinSet


@dataclass
class ManifestRegion:
    name: str
    chromosome: str
    start: int   # 1-based inclusive
    end: int     # 1-based inclusive


class Manifest:
    def __init__(self, regions: list[ManifestRegion]):
        self.regions = regions
        self._by_chrom: dict[str, list[ManifestRegion]] = {}
        for r in regions:
            self._by_chrom.setdefault(r.chromosome, []).append(r)
        for lst in self._by_chrom.values():
            lst.sort(key=lambda r: (r.start, r.end))

    def regions_by_chromosome(self) -> dict[str, list[ManifestRegion]]:
        return self._by_chrom

    @classmethod
    def read(cls, path: str | Path) -> "Manifest":
        opener = gzip.open if str(path).endswith(".gz") else open
        regions: list[ManifestRegion] = []
        with opener(str(path), "rt") as f:
            lines = [l.rstrip("\n") for l in f]
        section = None
        header: list[str] | None = None
        for line in lines:
            if not line.strip():
                continue
            if line.startswith("["):
                section = line.strip("[] \t").lower()
                header = None
                continue
            if section in ("regions", "targets", "probes" ) or section is None:
                fields = line.split("\t")
                if section is not None and header is None:
                    header = [h.lower() for h in fields]
                    continue
                if header is not None:
                    col = {h: fields[i] for i, h in enumerate(header)
                           if i < len(fields)}
                    chrom = col.get("chromosome") or col.get("chr")
                    start = col.get("start") or col.get("start position")
                    end = col.get("end") or col.get("end position")
                    if chrom and start and end:
                        regions.append(ManifestRegion(
                            col.get("name", ""), chrom, int(start), int(end)))
                elif section is None and len(fields) >= 3 \
                        and not line.startswith(("#", "track", "browser")):
                    # plain BED: 0-based half-open -> 1-based inclusive
                    regions.append(ManifestRegion(
                        fields[3] if len(fields) > 3 else "",
                        fields[0], int(fields[1]) + 1, int(fields[2])))
        return cls(regions)


def on_target_mask(bins: BinSet, manifest: Manifest) -> np.ndarray:
    """GetOnTargetBins as a boolean mask over the BinSet (bins 0-based,
    regions 1-based; overlap test region.End >= bin.Start+1 and
    region.Start <= bin.Stop)."""
    mask = np.zeros(len(bins), dtype=bool)
    by_chrom = manifest.regions_by_chromosome()
    for chrom, sl in bins.contig_slices().items():
        regions = by_chrom.get(chrom)
        if not regions:
            continue
        starts = bins.start[sl]
        stops = bins.end[sl]
        ri = 0
        m = np.zeros(sl.stop - sl.start, dtype=bool)
        for i in range(len(starts)):
            while ri < len(regions) and regions[ri].end < starts[i] + 1:
                ri += 1
            if ri < len(regions) and regions[ri].start <= stops[i]:
                m[i] = True
        mask[sl] = m
    return mask


def predefined_bins(manifest: Manifest) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """One bin per target region (0-based half-open), per chromosome."""
    out = {}
    for chrom, regions in manifest.regions_by_chromosome().items():
        starts = np.array([r.start - 1 for r in regions], dtype=np.int64)
        ends = np.array([r.end for r in regions], dtype=np.int64)
        out[chrom] = (starts, ends)
    return out


def intersect_bins_with_targets(bins: BinSet, manifest: Manifest) -> BinSet:
    """IntersectBinsWithTargetedRegions (CanvasRunner.cs:549-616): clip each
    bin to its overlapping target regions, emitting one row per overlap
    (counts carried through unchanged)."""
    by_chrom = manifest.regions_by_chromosome()
    cid, st, en, gc, cnt = [], [], [], [], []
    for chrom, sl in bins.contig_slices().items():
        regions = by_chrom.get(chrom)
        if not regions:
            continue
        contig_id = bins.contig_id[sl.start]
        ri = 0
        for i in range(sl.start, sl.stop):
            start1 = int(bins.start[i]) + 1   # 1-based inclusive
            end1 = int(bins.end[i])           # 1-based inclusive
            while ri < len(regions) and regions[ri].end < start1:
                ri += 1
            if ri >= len(regions) or end1 < regions[ri].start:
                continue
            rj = ri
            while rj < len(regions) and end1 >= regions[rj].start:
                s = max(start1, regions[rj].start)
                e = min(end1, regions[rj].end)
                cid.append(contig_id)
                st.append(s - 1)
                en.append(e)
                gc.append(bins.gc[i])
                cnt.append(bins.count[i])
                rj += 1
            # note: the reference advances the shared region index inside
            # the overlap loop (manifestRegionIdx++), reproduced via rj -> ri
            ri = rj
    import numpy as _np

    return BinSet(
        bins.contigs,
        _np.asarray(cid, dtype=_np.int32),
        _np.asarray(st, dtype=_np.int64),
        _np.asarray(en, dtype=_np.int64),
        _np.asarray(gc, dtype=_np.int16),
        _np.asarray(cnt, dtype=_np.float32),
    )
