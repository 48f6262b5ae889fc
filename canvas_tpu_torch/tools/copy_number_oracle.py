"""Known-copy-number truth set for model training/debugging
(CanvasCommon/CopyNumberOracle.cs).

BED lines carry chromosome, start, end, chromCountA, chromCountB
[, heterogeneity] (CN = A+B, :46-78); VCF records carry CN= / END= INFO
fields or a CN FORMAT column, with the reference's round-X.5-up quirk
(:137-206).  A segment's known CN is the first interval covering at least
half of it (:79-106)."""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass
from pathlib import Path


@dataclass
class CNInterval:
    start: int
    end: int
    cn: int
    heterogeneity: float = -1.0


class CopyNumberOracle:
    def __init__(self, oracle_path: str | Path):
        self.known_cn: dict[str, list[CNInterval]] = {}
        path = str(oracle_path)
        if not Path(path).exists():
            raise FileNotFoundError(f"Truth set not found at '{path}'")
        if path.endswith(".bed"):
            self._load_bed(path)
        else:
            self._load_vcf(path)

    def _load_bed(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                bits = line.rstrip("\n").split("\t")
                het = float(bits[5]) if len(bits) > 5 else -1.0
                self.known_cn.setdefault(bits[0], []).append(CNInterval(
                    int(bits[1]), int(bits[2]),
                    int(bits[3]) + int(bits[4]), het))

    def _load_vcf(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                bits = line.rstrip("\n").split("\t")
                start = int(bits[1])
                end, cn = 0, -1
                for sub in bits[7].split(";"):
                    if sub.startswith("CN="):
                        v = float(sub[3:])
                        # round X.5 UP (the reference adds 0.1 first, :168)
                        cn = int(math.floor(v + 0.1 + 0.5)) \
                            if sub.endswith(".5") else int(round(v))
                    elif sub.startswith("END="):
                        end = int(sub[4:])
                if len(bits) > 9:
                    fmt = bits[8].split(":")
                    vals = bits[9].split(":")
                    for k, v in zip(fmt, vals):
                        if k == "CN":
                            cn = int(v)
                if end and cn >= 0:
                    self.known_cn.setdefault(bits[0], []).append(
                        CNInterval(start, end, cn))

    def _chrom_key(self, chrom: str) -> str | None:
        if chrom in self.known_cn:
            return chrom
        alt = chrom.replace("chr", "")
        if alt in self.known_cn:
            return alt
        alt = "chr" + chrom
        return alt if alt in self.known_cn else None

    def _lookup(self, chrom: str, begin: int, end: int):
        key = self._chrom_key(chrom)
        if key is None:
            return None
        for iv in self.known_cn[key]:
            if iv.end < begin or iv.start > end:
                continue
            if (min(end, iv.end) - max(begin, iv.start)) * 2 >= end - begin:
                return iv
        return None

    def known_cn_for_segment(self, segment) -> int:
        """CN of the first truth interval covering >= half the segment."""
        iv = self._lookup(segment.chrom, segment.begin, segment.end)
        return iv.cn if iv else -1

    def known_clonality_for_segment(self, segment) -> float:
        iv = self._lookup(segment.chrom, segment.begin, segment.end)
        return iv.heterogeneity if iv else -1.0

    def accuracy_report(self, segments, max_cn: int = 10):
        """known-vs-called base-count confusion, the caller debug report
        (CanvasDiploidCaller.DebugEvaluateCopyNumberCallAccuracy shape)."""
        import numpy as np

        counts = np.zeros((max_cn + 1, max_cn + 1), dtype=np.int64)
        for seg in segments:
            known = self.known_cn_for_segment(seg)
            if known < 0 or seg.copy_number < 0:
                continue
            counts[min(known, max_cn), min(seg.copy_number, max_cn)] \
                += seg.length
        total = counts.sum()
        correct = np.trace(counts)
        return {
            "base_counts": counts,
            "accuracy": float(correct) / total if total else float("nan"),
        }
