"""Common-CNV alternative segmentations (SetA/SetB) for the pedigree caller.

Population (common) CNV intervals create an alternative segmentation per
region: SetA keeps the partitioner's segments, SetB respects the common-CNV
boundary; the caller picks the set whose summed per-sample maximum
likelihood is higher and flags SetB's common segments COMMONCNV.

Reference: CanvasSegment.MergeCommonCnvSegments (:775-857),
SplitCanvasSegments (:356-487, including its quirks), CanvasPedigreeCaller.
CreateSegmentSetsFromCommonCnvs (:211-331) and
GetHighestLogLikelihoodSegmentsSet / GetSegmentSetLogLikelihood (:316-366).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from canvas_tpu_torch.models.pedigree import (
    CopyNumberModel, SampleStats, single_sample_likelihoods)
from canvas_tpu_torch.models.segment_model import Segment

OVERLAP_WINDOW_THRESHOLD = 500   # CanvasSegment.OverlapWindowThreshold
SEGMENT_OVERLAP_THRESHOLD = 10


@dataclass
class OverlappingRegion:
    set_a: list[Segment] | None
    set_b: list[Segment] | None
    selected: str = "A"

    def segments(self) -> list[Segment]:
        chosen = self.set_a if self.selected == "A" else self.set_b
        if chosen is None:
            chosen = self.set_b if self.selected == "A" else self.set_a
        return chosen or []


def _subrange(seg: Segment, begin: int, end: int) -> Segment | None:
    """Bins with start >= begin and end <= end (GetSampleGenomicBinSubrange)
    plus alleles with begin <= pos <= end (GetBallelesSubrange)."""
    if seg.bin_starts is None:
        return None
    m = (seg.bin_starts >= begin) & (seg.bin_ends <= end)
    if not m.any():
        return None
    out = Segment(seg.chrom, begin, end, seg.bin_counts[m],
                  bin_starts=seg.bin_starts[m], bin_ends=seg.bin_ends[m])
    if len(seg.baf_frequencies):
        # allele positions are 1-based; approximate by interval membership
        am = np.ones(len(seg.baf_frequencies), dtype=bool)
        if hasattr(seg, "baf_positions") and seg.baf_positions is not None:
            am = (seg.baf_positions >= begin) & (seg.baf_positions <= end)
        out.baf_frequencies = seg.baf_frequencies[am]
        out.baf_total_coverage = seg.baf_total_coverage[am]
        out.baf_count_a = seg.baf_count_a[am]
        out.baf_count_b = seg.baf_count_b[am]
    return out


def split_canvas_segments(
    canvas: list[Segment], common: list[Segment], i: int, j: int,
) -> tuple[OverlappingRegion, int, int]:
    """SplitCanvasSegments overlap state machine (CanvasSegment.cs:356-487).
    Returns (region, new canvas index, new common index)."""
    set_a: list[Segment] = []
    set_b: list[Segment] = []
    cs, co = canvas[i], common[j]

    # common within canvas
    if co.begin > cs.begin and co.end < cs.end:
        left = _subrange(cs, cs.begin, co.begin)
        if left is not None:
            set_b.append(left)
        set_b.append(co)
        # canvas spans more than one common segment
        if j + 1 < len(common) and common[j + 1].begin < cs.end:
            j += 1
            while j < len(common) and common[j].begin < cs.end:
                set_b.append(common[j])
                j += 1
            set_a.append(cs)
            return OverlappingRegion(set_a, set_b), i + 1, j
        right = _subrange(cs, co.end, cs.end)
        if right is not None:
            set_b.append(right)
        set_a.append(cs)
        return OverlappingRegion(set_a, set_b), i + 1, j + 1

    # canvas part-overlaps common, canvas first
    if cs.begin < co.begin < cs.end and cs.end <= co.end:
        set_a.append(cs)
        left = _subrange(cs, cs.begin, co.begin)
        if left is not None:
            set_b.append(left)
        if cs.end == co.end:
            set_b.append(co)
            return OverlappingRegion(set_a, set_b), i + 1, j + 1
        # common spans more than one canvas segment
        if i + 1 < len(canvas) and co.end > canvas[i + 1].end:
            i += 1
            while i < len(canvas) and co.end > canvas[i].end:
                set_a.append(canvas[i])
                i += 1
            set_b.append(co)
            return OverlappingRegion(set_a, set_b), i, j + 1
        set_b.append(co)
        i += 1
        tail = _subrange(canvas[i], canvas[i].begin, co.end)
        if tail is not None:
            set_a.append(tail)
        return OverlappingRegion(set_a, set_b), i, j + 1

    # common part-overlaps canvas, common first
    if co.begin <= cs.begin and co.end > cs.begin and cs.end > co.end:
        set_b.append(co)
        right = _subrange(cs, co.end, cs.end)
        if right is not None:
            set_b.append(right)
        set_a.append(cs)
        return OverlappingRegion(set_a, set_b), i + 1, j + 1

    # default: unhandled scenario
    return OverlappingRegion([canvas[min(i + 1, len(canvas) - 1)]], None), \
        i + 1, j


def merge_common_cnv_segments(
    canvas: list[Segment], common: list[Segment],
) -> list[OverlappingRegion]:
    """MergeCommonCnvSegments (CanvasSegment.cs:775-857)."""
    out: list[OverlappingRegion] = []
    canvas = sorted(canvas, key=lambda s: s.begin)
    common = sorted(common, key=lambda s: s.begin)
    i = j = 0
    if canvas and common and canvas[0].end <= common[0].begin:
        out.append(OverlappingRegion([canvas[0]], None))
        i += 1
    while i < len(canvas) and j < len(common):
        cs, co = canvas[i], common[j]
        if co.length < OVERLAP_WINDOW_THRESHOLD * 2:
            j += 1
            continue
        if cs.end <= co.begin:
            out.append(OverlappingRegion([cs], None))
            i += 1
            continue
        if cs.begin >= co.end:
            out.append(OverlappingRegion(None, [co]))
            j += 1
            continue
        if cs.begin == co.begin and cs.end == co.end:
            out.append(OverlappingRegion(None, [co]))
            i += 1
            j += 1
            continue
        if (abs(cs.begin - co.begin) < OVERLAP_WINDOW_THRESHOLD
                and abs(cs.end - co.end) < OVERLAP_WINDOW_THRESHOLD
                and co.length > OVERLAP_WINDOW_THRESHOLD * 4):
            out.append(OverlappingRegion(None, [co]))
            i += 1
            j += 1
            continue
        if _size_overlap(cs, co) > SEGMENT_OVERLAP_THRESHOLD:
            region, i, j = split_canvas_segments(canvas, common, i, j)
            out.append(region)
        else:
            out.append(OverlappingRegion([cs], None))
            i += 1
            j += 1
    out.extend(OverlappingRegion([s], None) for s in canvas[i:])
    if i >= len(canvas):
        out.extend(OverlappingRegion(None, [s]) for s in common[j:])
    return out


def _size_overlap(a: Segment, b: Segment) -> int:
    """CanvasSegment.SizeOverlap (:336-345)."""
    if b.begin > a.begin and b.end < a.end:
        return a.length - b.length
    if a.begin < b.begin < a.end and a.end <= b.end:
        return a.end - b.begin
    if b.begin < a.begin and b.end > a.begin and a.end > b.end:
        return b.end - a.begin
    return 0


def common_segments_from_bed(
    intervals: list[tuple[int, int]],
    chrom: str,
    bin_starts: np.ndarray,
    bin_ends: np.ndarray,
    bin_counts: np.ndarray,
) -> list[Segment]:
    """CreateSegmentsFromCommonCnvs: bins spanned by each common interval ->
    one IsCommonCnv segment (alleles attached separately)."""
    out = []
    for start, end in intervals:
        m = (bin_starts < end) & (bin_ends > start)
        idx = np.flatnonzero(m)
        if len(idx) == 0:
            continue
        seg = Segment(chrom, int(bin_starts[idx[0]]), int(bin_ends[idx[-1]]),
                      bin_counts[idx],
                      bin_starts=bin_starts[idx], bin_ends=bin_ends[idx])
        seg.is_common_cnv = True
        out.append(seg)
    return out


def choose_best_sets(
    regions_by_sample: dict[str, list[OverlappingRegion]],
    stats_by_sample: dict[str, SampleStats],
    models: dict[str, CopyNumberModel],
    max_cn: int,
) -> None:
    """GetHighestLogLikelihoodSegmentsSet per region across samples
    (:316-366): pick the set whose summed max single-sample likelihood
    (log) across samples/segments is higher."""
    names = list(regions_by_sample)
    n_regions = len(regions_by_sample[names[0]])
    for r in range(n_regions):
        first = regions_by_sample[names[0]][r]
        if first.set_a is None:
            choice = "B"
        elif first.set_b is None:
            choice = "A"
        else:
            ll = {"A": 0.0, "B": 0.0}
            for which in ("A", "B"):
                for name in names:
                    region = regions_by_sample[name][r]
                    segs = region.set_a if which == "A" else region.set_b
                    for seg in segs or []:
                        liks = single_sample_likelihoods(
                            seg, stats_by_sample[name], models[name], max_cn)
                        best = float(np.max(liks))
                        ll[which] += np.log(best) if best > 0 else -1e30
            choice = "A" if ll["A"] > ll["B"] else "B"
        for name in names:
            regions_by_sample[name][r].selected = choice


def resolve_regions(regions: list[OverlappingRegion]) -> list[Segment]:
    """Flatten the selected sets into the final segment list."""
    out: list[Segment] = []
    for region in regions:
        out.extend(region.segments())
    return out
