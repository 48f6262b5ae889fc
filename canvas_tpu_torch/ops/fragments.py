"""Fragment-mode binning (CanvasBin Fragment coverage mode).

Counts properly-paired fragments into predefined bins by maximum overlap,
with pair-undo bookkeeping when the mate turns out to be a duplicate /
failed-QC / low-MAPQ read (FragmentBinner.cs:256-371)."""

from __future__ import annotations

import numpy as np

from canvas_tpu_torch.io.bam import (
    FLAG_DUPLICATE, FLAG_FAILQC, FLAG_PAIRED, FLAG_PROPER_PAIR,
    FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED, BamRecord)

MAPPING_QUALITY_NOT_AVAILABLE = 255


def _is_dup_failqc_lowq(rec: BamRecord, quality_threshold: int) -> bool:
    if rec.flag & FLAG_DUPLICATE or rec.flag & FLAG_FAILQC:
        return True
    return (rec.mapq == MAPPING_QUALITY_NOT_AVAILABLE
            or rec.mapq < quality_threshold)


def find_best_bin(bin_start: np.ndarray, bin_end: np.ndarray,
                  index_start: int, frag_start: int, frag_stop: int) -> int:
    """Max-overlap bin, first on ties (FragmentBinner.FindBestBin)."""
    best, best_overlap = -1, 0
    for i in range(index_start, len(bin_start)):
        overlap = min(int(bin_end[i]), frag_stop) - max(int(bin_start[i]),
                                                        frag_start)
        if overlap <= 0:
            break
        if overlap > best_overlap:
            best_overlap, best = overlap, i
    return best


def bin_fragments(
    records, bin_start: np.ndarray, bin_end: np.ndarray,
    quality_threshold: int = 0,
) -> tuple[np.ndarray, int]:
    """Count fragments into predefined bins (BinOneAlignment loop).

    `records` iterates one contig's alignments in coordinate order.
    Returns (counts per bin, usable fragment count)."""
    counts = np.zeros(len(bin_start), dtype=np.float64)
    usable = 0
    read_to_bin: dict[str, int] = {}
    same_pos: set[str] = set()
    bin_index_start = 0
    mate_unmapped = 0x8
    for rec in records:
        if rec.flag & FLAG_UNMAPPED or rec.flag & mate_unmapped:
            continue
        if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
            continue
        if not (rec.flag & FLAG_PAIRED and rec.flag & FLAG_PROPER_PAIR):
            continue
        bad = _is_dup_failqc_lowq(rec, quality_threshold)
        if rec.read_name in read_to_bin:
            if bad:
                usable -= 1
                counts[read_to_bin[rec.read_name]] -= 1
            del read_to_bin[rec.read_name]
            continue
        if bad:
            continue
        if rec.ref_id != rec.next_ref_id:
            continue
        if rec.pos > rec.next_pos:
            continue  # right-most in pair
        if rec.pos == rec.next_pos:
            if rec.read_name in same_pos:
                same_pos.remove(rec.read_name)
                continue
            same_pos.add(rec.read_name)
        if rec.tlen == 0:
            continue
        frag_start = rec.pos
        frag_stop = rec.pos + rec.tlen
        while bin_index_start < len(bin_start) and \
                bin_end[bin_index_start] <= frag_start:
            bin_index_start += 1
        if bin_index_start >= len(bin_start):
            continue
        best = find_best_bin(bin_start, bin_end, bin_index_start,
                             frag_start, frag_stop)
        if best >= 0:
            usable += 1
            counts[best] += 1
            read_to_bin[rec.read_name] = best
    return counts, usable
