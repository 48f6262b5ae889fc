"""EvaluateCNV — the accuracy acceptance harness (Tools/EvaluateCNV).

Compares a CNV VCF against a truth set at base resolution:
  * 3D base-count array [truthCN, callCN, refPloidy] plus a no-call array
    (CNVEvaluator.cs:13-35);
  * excluded-region subtraction with the reference's majority-exclusion
    quirk (overlapBases/excludedOverlap < 0.1 kills the overlap,
    CNVEvaluator.cs:237-257);
  * Recall/Precision/F1/Accuracy and direction variants from the count
    array (MetricsCalculator.cs);
  * per-event accuracy mean/median (CalculateMedianAndMeanAccuracies);
  * PASS-only and all-variant passes; optional DQ threshold for de novo
    evaluation; size-stratified splits.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

MAX_CN = 5


@dataclass
class TruthInterval:
    chromosome: str
    start: int          # 0-based inclusive
    end: int            # exclusive
    cn: int
    reference_cn: int | None = None
    bases_covered: int = 0
    bases_called_correctly: int = 0
    bases_called_incorrectly: int = 0
    bases_excluded: int = 0

    @property
    def length(self) -> int:
        return self.end - self.start


@dataclass
class CnvCall:
    chrom: str
    start: int          # 0-based inclusive
    end: int            # exclusive
    cn: int
    ref_ploidy: int
    alt_allele: str
    pass_filter: bool
    qscore: float = 0.0
    dq: float | None = None

    @property
    def length(self) -> int:
        return self.end - self.start

    @property
    def is_alt_variant(self) -> bool:
        return self.alt_allele not in (".",) and self.cn != self.ref_ploidy


def load_truth_bed(
    path: str | Path,
    heterogeneity_fraction: float = 1.0,
) -> dict[str, list[TruthInterval]]:
    """Truth set bed (CNVChecker.LoadIntervalsFromBed, CNVChecker.cs:133-169).

    Two layouts: 4-column chr/start/end/cn, or the reference's allele-pair
    layout chr/start/end/cnA/cnB[/hetFraction] where CN = cnA + cnB and,
    with --het < 1, heterogeneous-normal rows (alleles 1/1 with
    hetFraction < the option) are dropped (CNVChecker.cs:157-160)."""
    out: dict[str, list[TruthInterval]] = {}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(str(path), "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("#", "track")):
                continue
            fields = line.rstrip("\t\n").split("\t")
            if len(fields) < 4:
                continue
            cn_a = int(fields[3])
            if len(fields) >= 5 and fields[4].lstrip("-").isdigit():
                cn_b = int(fields[4])
                if (heterogeneity_fraction < 1 and len(fields) > 5
                        and cn_a == 1 and cn_b == 1
                        and heterogeneity_fraction > float(fields[5])):
                    continue
                cn = cn_a + cn_b
            else:
                cn = cn_a
            iv = TruthInterval(fields[0], int(fields[1]), int(fields[2]), cn)
            out.setdefault(iv.chromosome, []).append(iv)
    return out


def load_truth_vcf(path: str | Path) -> dict[str, list[TruthInterval]]:
    """Truth set in VCF form (CNVChecker.LoadKnownCNVCF + ParseCnInterval,
    :171-253): CN from INFO CN= (x.5 rounds UP) or the sample CN field;
    END from INFO."""
    out: dict[str, list[TruthInterval]] = {}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(str(path), "rt") as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            bits = line.rstrip("\n").split("\t")
            cn, end = -1, 0
            for sub in bits[7].split(";"):
                if sub.startswith("CN="):
                    v = float(sub[3:])
                    cn = int(round(v + 0.1)) if sub.endswith(".5") \
                        else int(round(v))
                elif sub.startswith("END="):
                    end = int(sub[4:])
            if len(bits) > 9:
                fmt = bits[8].split(":")
                col = bits[9].split(":")
                for k, v in zip(fmt, col):
                    if k == "CN":
                        cn = int(v)
            if end == 0 or cn < 0:
                raise ValueError(f"Invalid VCF truth record: {line!r}")
            iv = TruthInterval(bits[0], int(bits[1]), end, cn)
            out.setdefault(iv.chromosome, []).append(iv)
    return out


def load_known_cn(path: str | Path,
                  heterogeneity_fraction: float = 1.0
                  ) -> dict[str, list[TruthInterval]]:
    """LoadKnownCn (:271-283): .bed -> bed loader, else VCF loader."""
    if str(path).endswith(".bed") or str(path).endswith(".bed.gz"):
        return load_truth_bed(path, heterogeneity_fraction)
    return load_truth_vcf(path)


def sex_ploidy_fn(ploidy_x: int, ploidy_y: int,
                  par_bed: str | Path | None = None):
    """ploidy_fn(chrom, start, end) from allosome ploidies + X PAR regions
    (the reference's --ploidy-x/--ploidy-y/--par-bed triple; chrY PAR is
    assumed N-masked in the reference genome, Program.cs:77-79).  Majority
    ploidy over the span, PAR regions on X staying diploid."""
    from canvas_tpu_torch.io.ploidy import PloidyInfo, PloidyInterval

    par: list[tuple[int, int]] = []
    if par_bed is not None:
        for chrom, ivs in load_exclude_bed(par_bed).items():
            if chrom.replace("chr", "") == "X":
                par.extend(ivs)
    par.sort()
    info = PloidyInfo()
    big = 2 ** 31 - 1
    for x_name in ("chrX", "X"):
        pos = 1
        ivs = []
        for p_start, p_end in par:   # bed 0-based -> 1-based intervals
            if p_start + 1 > pos:
                ivs.append(PloidyInterval(x_name, pos, p_start, ploidy_x))
            pos = p_end + 1
        ivs.append(PloidyInterval(x_name, pos, big, ploidy_x))
        info.by_chromosome[x_name] = ivs
    for y_name in ("chrY", "Y"):
        info.by_chromosome[y_name] = [
            PloidyInterval(y_name, 1, big, ploidy_y)]
    return info.reference_copy_number


def load_exclude_bed(path: str | Path) -> dict[str, list[tuple[int, int]]]:
    out: dict[str, list[tuple[int, int]]] = {}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(str(path), "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("#", "track")):
                continue
            fields = line.rstrip("\n").split("\t")
            out.setdefault(fields[0], []).append(
                (int(fields[1]), int(fields[2])))
    return out


_END_RE = re.compile(r"END=(\d+)")


def load_cnv_calls(
    vcf_path: str | Path,
    sample_index: int = 0,
    ploidy_fn=None,
    dq_threshold: float | None = None,
) -> dict[str, list[CnvCall]]:
    """Parse a Canvas CNV VCF into calls.

    ploidy_fn(chrom, start, end) -> reference ploidy (default 2).
    With dq_threshold set, only calls with DQ >= threshold are kept
    (de novo evaluation mode)."""
    out: dict[str, list[CnvCall]] = {}
    opener = gzip.open if str(vcf_path).endswith(".gz") else open
    with opener(str(vcf_path), "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, _, _, alt, _, filt, info = fields[:8]
            fmt = fields[8].split(":")
            sample = fields[9 + sample_index].split(":")
            col = dict(zip(fmt, sample))
            m = _END_RE.search(info)
            end = int(m.group(1)) if m else int(pos)
            symbolic = alt.startswith("<")
            start = int(pos) if symbolic else int(pos) - 1
            cn = int(col["CN"]) if col.get("CN", ".") != "." else 2
            ploidy = int(ploidy_fn(chrom, start, end)) if ploidy_fn else 2
            record_pass = filt == "PASS" and col.get("FT", "PASS") == "PASS"
            dq = None
            if "DQ" in col and col["DQ"] != ".":
                dq = float(col["DQ"])
            if dq_threshold is not None:
                if dq is None or dq < dq_threshold:
                    continue
            out.setdefault(chrom, []).append(CnvCall(
                chrom, start, end, cn, ploidy, alt, record_pass,
                float(col.get("QS", 0) or 0), dq))
    return out


# the reference's -s/--splitBySize bins (CNVEvaluator.cs:57-64)
SIZE_SPLITS = [(0, 4999), (5000, 9999), (10000, 99999),
               (100000, 499999), (500000, 2 ** 31 - 1)]


@dataclass
class BaseCounter:
    min_size: int = 0
    max_size: int = 2 ** 31 - 1
    has_roi: bool = False
    base_count: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CN + 1, MAX_CN + 1, 3), np.int64))
    no_calls: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CN + 1, 3), np.int64))
    roi_base_count: np.ndarray | None = None
    total_variants: int = 0
    total_variant_bases: int = 0
    mean_accuracy: float = 0.0
    median_accuracy: float = float("nan")

    def __post_init__(self):
        if self.has_roi and self.roi_base_count is None:
            self.roi_base_count = np.zeros(
                (MAX_CN + 1, MAX_CN + 1, 3), np.int64)


@dataclass
class Metrics:
    """MetricsCalculator output (percentages)."""
    accuracy: float
    direction_accuracy: float
    f1: float
    recall: float
    direction_recall: float
    precision: float
    direction_precision: float
    gain_recall: float
    gain_direction_recall: float
    gain_precision: float
    gain_direction_precision: float
    loss_recall: float
    loss_direction_recall: float
    loss_precision: float
    loss_direction_precision: float
    total_bases: int
    roi_bases: int = 0
    roi_accuracy: float = float("nan")
    roi_direction_accuracy: float = float("nan")


def count_bases(
    truth: dict[str, list[TruthInterval]],
    calls: dict[str, list[CnvCall]],
    counter: BaseCounter,
    exclude: dict[str, list[tuple[int, int]]] | None = None,
    passing_only: bool = True,
    skip_diploid: bool = False,
    roi: dict[str, list[tuple[int, int]]] | None = None,
    mappable: dict[str, np.ndarray] | None = None,
) -> None:
    """CalculateMetrics base-count core (CNVEvaluator.cs:115-334).

    roi: regions-of-interest intervals whose overlap feeds the separate
    ROI confusion array.  mappable: per-chromosome bool arrays (uppercase
    kmer.fa positions); truth variants with >=80% unmappable bases are
    skipped (CNVEvaluator.cs:131-166)."""
    exclude = exclude or {}
    if roi and counter.roi_base_count is None:
        counter.roi_base_count = np.zeros((MAX_CN + 1, MAX_CN + 1, 3),
                                          np.int64)
    for calls_chrom in calls.values():
        for call in calls_chrom:
            if not (call.is_alt_variant
                    and counter.min_size <= call.length <= counter.max_size):
                continue
            if passing_only and not call.pass_filter:
                continue
            counter.total_variant_bases += call.length
            counter.total_variants += 1

    for intervals in truth.values():
        for interval in intervals:
            if not (counter.min_size <= interval.length <= counter.max_size):
                continue
            if (mappable is not None and interval.chromosome in mappable
                    and interval.cn != interval.reference_cn):
                m = mappable[interval.chromosome]
                unmapped = int(np.sum(~m[interval.start:interval.end]))
                if unmapped / max(1, interval.length) >= 0.8:
                    continue
            chromosome = interval.chromosome
            if chromosome not in calls:
                chromosome = chromosome.replace("chr", "")
            if chromosome not in calls:
                chromosome = "chr" + interval.chromosome.replace("chr", "")
            chrom_calls = calls.get(chromosome, [])
            known_cn = min(interval.cn, MAX_CN)
            total_overlap = 0
            exclude_bases = 0
            ploidy_weights: list[tuple[int, int]] = []
            for call in chrom_calls:
                ref_ploidy = (interval.reference_cn
                              if interval.reference_cn is not None
                              else call.ref_ploidy)
                cn = min(call.cn, MAX_CN)
                if call.alt_allele == "." and skip_diploid:
                    continue
                o_start = max(call.start, interval.start)
                o_end = min(call.end, interval.end)
                if o_start >= o_end:
                    continue
                overlap = o_end - o_start
                call_excluded = 0
                for ex_start, ex_end in exclude.get(call.chrom, []):
                    e_start = max(ex_start, o_start)
                    e_end = min(ex_end, o_end)
                    if e_start >= e_end:
                        continue
                    ex_bases = e_end - e_start
                    exclude_bases += ex_bases
                    call_excluded += ex_bases
                    overlap -= ex_bases
                    # reference's majority-exclusion quirk
                    if overlap / max(ex_bases, 1) < 0.1:
                        call_excluded += overlap
                        exclude_bases += overlap
                        overlap = 0
                        break
                ploidy_weights.append((ref_ploidy, overlap))
                if call.pass_filter or not passing_only:
                    total_overlap += overlap
                    counter.base_count[known_cn, cn, ref_ploidy] += overlap
                interval.bases_covered += overlap
                if known_cn == cn:
                    interval.bases_called_correctly += overlap
                else:
                    interval.bases_called_incorrectly += overlap
                interval.bases_excluded += call_excluded
                # ROI overlap uses the raw call/truth overlap window, not
                # the exclusion-reduced count (CNVEvaluator.cs:295-309)
                if roi and call.chrom in roi \
                        and (call.pass_filter or not passing_only):
                    for r_start, r_end in roi[call.chrom]:
                        rs = max(r_start, o_start)
                        re_ = min(r_end, o_end)
                        if rs < re_:
                            counter.roi_base_count[known_cn, cn, ref_ploidy] \
                                += re_ - rs

            non_overlap = interval.length - total_overlap - exclude_bases
            if interval.reference_cn is None:
                if not ploidy_weights:
                    raise ValueError(
                        f"truth interval {interval.chromosome}:"
                        f"{interval.start}-{interval.end} has no overlapping "
                        f"calls; provide reference ploidy")
                w = np.array([max(x[1], 1) for x in ploidy_weights], float)
                p = np.array([x[0] for x in ploidy_weights], float)
                interval.reference_cn = int(np.round(np.sum(p * w) / np.sum(w)))
            if non_overlap < 0:
                raise ValueError("negative non-overlap bases")
            counter.no_calls[known_cn, interval.reference_cn] += non_overlap

    # event-level accuracies
    accs = []
    for intervals in truth.values():
        for interval in intervals:
            if interval.cn == interval.reference_cn:
                continue
            basecount = interval.length - interval.bases_excluded
            if basecount <= 0:
                continue
            accs.append(interval.bases_called_correctly / basecount)
    counter.mean_accuracy = float(np.sum(accs) / max(1, len(accs)))
    accs.sort()
    counter.median_accuracy = accs[len(accs) // 2] if accs else float("nan")


def calculate_metrics(counter: BaseCounter, max_ploidy: int = 2) -> Metrics:
    """MetricsCalculator.CalculateMetrics."""
    bc, nc = counter.base_count, counter.no_calls
    total = total_right = total_right_dir = 0
    is_gain = call_gain = gain_ok = gain_dir = 0
    is_loss = call_loss = loss_ok = loss_dir = 0
    for ploidy in range(max_ploidy + 1):
        for t in range(MAX_CN + 1):
            ncb = int(nc[t, ploidy])
            if t < ploidy:
                is_loss += ncb
            if t > ploidy:
                is_gain += ncb
            total += ncb
            for c in range(MAX_CN + 1):
                b = int(bc[t, c, ploidy])
                total += b
                if t == c:
                    total_right += b
                if (t < ploidy and c < ploidy) or (t == ploidy and c == ploidy) \
                        or (t > ploidy and c > ploidy):
                    total_right_dir += b
                if t < ploidy:
                    is_loss += b
                if t > ploidy:
                    is_gain += b
                if c < ploidy:
                    call_loss += b
                if c > ploidy:
                    call_gain += b
                if t == c and t < ploidy:
                    loss_ok += b
                if t == c and t > ploidy:
                    gain_ok += b
                if t > ploidy and c > ploidy:
                    gain_dir += b
                if t < ploidy and c < ploidy:
                    loss_dir += b

    def pct(a, b):
        return 100.0 * a / b if b else float("nan")

    frac_prec = (gain_ok + loss_ok) / (call_gain + call_loss) \
        if (call_gain + call_loss) else float("nan")
    frac_rec = (gain_ok + loss_ok) / (is_gain + is_loss) \
        if (is_gain + is_loss) else float("nan")
    f1 = (2 * frac_prec * frac_rec / (frac_prec + frac_rec)
          if (frac_prec + frac_rec) else float("nan"))

    roi_bases = roi_ok = roi_dir = 0
    if counter.roi_base_count is not None:
        rc = counter.roi_base_count
        for ploidy in range(max_ploidy + 1):
            for t in range(MAX_CN + 1):
                for c in range(MAX_CN + 1):
                    b = int(rc[t, c, ploidy])
                    roi_bases += b
                    if t == c:
                        roi_ok += b
                    if (t < ploidy and c < ploidy) \
                            or (t == ploidy and c == ploidy) \
                            or (t > ploidy and c > ploidy):
                        roi_dir += b

    return Metrics(
        accuracy=pct(total_right, total),
        direction_accuracy=pct(total_right_dir, total),
        f1=f1,
        recall=frac_rec * 100,
        direction_recall=pct(gain_dir + loss_dir, is_gain + is_loss),
        precision=frac_prec * 100,
        direction_precision=pct(gain_dir + loss_dir, call_gain + call_loss),
        gain_recall=pct(gain_ok, is_gain),
        gain_direction_recall=pct(gain_dir, is_gain),
        gain_precision=pct(gain_ok, call_gain),
        gain_direction_precision=pct(gain_dir, call_gain),
        loss_recall=pct(loss_ok, is_loss),
        loss_direction_recall=pct(loss_dir, is_loss),
        loss_precision=pct(loss_ok, call_loss),
        loss_direction_precision=pct(loss_dir, call_loss),
        total_bases=total,
        roi_bases=roi_bases,
        roi_accuracy=pct(roi_ok, roi_bases),
        roi_direction_accuracy=pct(roi_dir, roi_bases),
    )


def load_mappability(kmer_fa: str | Path,
                     chromosomes) -> dict[str, np.ndarray]:
    """Per-chromosome bool arrays: True where the kmer.fa base is uppercase
    (unique 35-mer start; CNVEvaluator.cs:70-85)."""
    from canvas_tpu_torch.genome.reference import read_fasta

    seqs = read_fasta(kmer_fa)   # contig -> uint8 byte array
    out = {}
    for chrom in chromosomes:
        if chrom in seqs:
            arr = seqs[chrom]
            out[chrom] = (arr >= ord("A")) & (arr <= ord("Z"))
    return out


def evaluate(
    truth_path: str | Path,
    vcf_path: str | Path,
    exclude_path: str | Path | None = None,
    passing_only: bool = True,
    dq_threshold: float | None = None,
    ploidy_fn=None,
    sample_index: int = 0,
    min_size: int = 0,
    max_size: int = 2 ** 31 - 1,
    roi_path: str | Path | None = None,
    kmer_fa: str | Path | None = None,
    return_counter: bool = False,
    min_entry_size: int = 0,
    heterogeneity_fraction: float = 1.0,
    skip_diploid: bool = False,
):
    """End-to-end evaluation (CNVChecker.Evaluate equivalent).

    ploidy_fn(chrom, start, end) -> reference ploidy; when given it also
    pre-sets truth-interval reference CNs (the reference's --ploidy-x/-y
    options), which is required when the DQ filter leaves truth intervals
    without any overlapping call.  min_entry_size drops truth AND query
    entries spanning fewer bases (CNVChecker.cs:478-482, default 10000 in
    the reference CLI)."""
    truth = load_known_cn(truth_path, heterogeneity_fraction)
    calls = load_cnv_calls(vcf_path, sample_index=sample_index,
                           ploidy_fn=ploidy_fn, dq_threshold=dq_threshold)
    if min_entry_size > 0:
        truth = {c: [iv for iv in ivs if iv.length >= min_entry_size]
                 for c, ivs in truth.items()}
        calls = {c: [cl for cl in cls if cl.length >= min_entry_size]
                 for c, cls in calls.items()}
    if ploidy_fn is not None:
        for intervals in truth.values():
            for iv in intervals:
                if iv.reference_cn is None:
                    iv.reference_cn = int(
                        ploidy_fn(iv.chromosome, iv.start, iv.end))
    exclude = load_exclude_bed(exclude_path) if exclude_path else None
    roi = load_exclude_bed(roi_path) if roi_path else None
    mappable = load_mappability(kmer_fa, truth.keys()) if kmer_fa else None
    counter = BaseCounter(min_size, max_size, has_roi=roi is not None)
    count_bases(truth, calls, counter, exclude, passing_only,
                skip_diploid=skip_diploid, roi=roi, mappable=mappable)
    metrics = calculate_metrics(counter)
    if return_counter:
        return metrics, counter
    return metrics


def compute_callability(
    calls: dict[str, list[CnvCall]],
    filter_bed: str | Path,
    contig_lengths: dict[str, int],
    exclude_chr_y: bool = False,
) -> tuple[int, int]:
    """Callability = PASS-called bases / non-filtered genome bases
    (CallabilityMetricsComputer + CallabilityCalculator).  Included
    intervals are the complement of the filter bed over each contig;
    chrY is dropped for female samples (--ploidy-y 0)."""
    filt = load_exclude_bed(filter_bed)
    total = called = 0
    for contig, length in contig_lengths.items():
        if exclude_chr_y and contig.replace("chr", "") == "Y":
            continue
        included: list[tuple[int, int]] = []
        pos = 0
        for f_start, f_end in sorted(filt.get(contig, [])):
            if f_start > pos:
                included.append((pos, f_start))
            pos = max(pos, f_end)
        if pos < length:
            included.append((pos, length))
        total += sum(e - s for s, e in included)
        # merge PASS call intervals, then sweep both sorted lists
        merged: list[list[int]] = []
        for c_start, c_end in sorted((c.start, c.end)
                                     for c in calls.get(contig, [])
                                     if c.pass_filter):
            if merged and c_start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], c_end)
            else:
                merged.append([c_start, c_end])
        i = j = 0
        while i < len(merged) and j < len(included):
            o = (min(merged[i][1], included[j][1])
                 - max(merged[i][0], included[j][0]))
            if o > 0:
                called += o
            if merged[i][1] < included[j][1]:
                i += 1
            else:
                j += 1
    return called, total


def format_callability(called: int, total: int) -> str:
    """CallabilityMetric.GetMetrics as the reference's tab-separated lines."""
    pct = 100.0 * called / total if total else float("nan")
    return (f"Total base positions\t{total}\n"
            f"Called base positions\t{called}\n"
            f"Percent callability\t{pct:.4f}\n")


def format_report(metrics: Metrics, counter: BaseCounter | None = None,
                  passing_only: bool = True) -> str:
    """WriteResults line set (CNVEvaluator.cs:393-422), including the
    reference's LossDirectionRecall-prints-LossRecall quirk (:408)."""
    lines = [
        "Results for PASSing variants" if passing_only
        else "Results for all variants",
        f"Accuracy\t{metrics.accuracy:.4f}",
        f"DirectionAccuracy\t{metrics.direction_accuracy:.4f}",
        f"F-score\t{metrics.f1:.4f}",
        f"Recall\t{metrics.recall:.4f}",
        f"DirectionRecall\t{metrics.direction_recall:.4f}",
        f"Precision\t{metrics.precision:.4f}",
        f"DirectionPrecision\t{metrics.direction_precision:.4f}",
        f"GainRecall\t{metrics.gain_recall:.4f}",
        f"GainDirectionRecall\t{metrics.gain_direction_recall:.4f}",
        f"GainPrecision\t{metrics.gain_precision:.4f}",
        f"GainDirectionPrecision\t{metrics.gain_direction_precision:.4f}",
        f"LossRecall\t{metrics.loss_recall:.4f}",
        f"LossDirectionRecall\t{metrics.loss_recall:.4f}",
        f"LossPrecision\t{metrics.loss_precision:.4f}",
        f"LossDirectionPrecision\t{metrics.loss_direction_precision:.4f}",
    ]
    if counter is not None:
        lines.append(f"MeanEventAccuracy\t{100 * counter.mean_accuracy:.4f}")
        lines.append(
            f"MedianEventAccuracy\t{100 * counter.median_accuracy:.4f}")
        lines.append(f"VariantEventsCalled\t{counter.total_variants}")
        lines.append(f"VariantBasesCalled\t{counter.total_variant_bases}")
        if counter.roi_base_count is not None and metrics.roi_bases > 0:
            lines.append(f"ROIAccuracy\t{metrics.roi_accuracy:.4f}")
            lines.append(
                f"ROIDirectionAccuracy\t{metrics.roi_direction_accuracy:.4f}")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI: EvaluateCNV truth.bed CNV.vcf[.gz] [excluded.bed] output_dir
    (Tools/EvaluateCNV/Program.cs:59)."""
    import argparse
    import sys
    from pathlib import Path as _Path

    p = argparse.ArgumentParser(prog="evaluate_cnv")
    p.add_argument("truth")
    p.add_argument("cnv_vcf")
    p.add_argument("excluded", nargs="?", default=None)
    p.add_argument("output_dir", nargs="?", default=None)
    p.add_argument("-q", "--dq-threshold", type=float, default=None,
                   help="only evaluate calls with DQ >= threshold (de novo)")
    p.add_argument("-s", "--split-by-size", action="store_true",
                   help="also report per size bin (0-5kb ... 500kb+)")
    p.add_argument("-r", "--roi", "--roi-bed", dest="roi_bed", default=None,
                   help="regions of interest for ROI accuracy metrics "
                        "(reference -r/--roi)")
    p.add_argument("-k", "--kmerFa", "--kmer-fa", dest="kmer_fa", default=None,
                   help="kmer.fa for skipping >=80%% unmappable truth CNVs "
                        "and for callability")
    p.add_argument("--sample-index", type=int, default=0)
    p.add_argument("--ploidy", type=int, default=None,
                   help="uniform reference ploidy override")
    p.add_argument("--ploidy-x", type=int, default=None,
                   help="reference ploidy for chromosome X")
    p.add_argument("--ploidy-y", type=int, default=None,
                   help="reference ploidy for chromosome Y")
    p.add_argument("--par-bed", default=None,
                   help="bed of chrX PAR regions (stay diploid); chrY PAR "
                        "assumed N-masked")
    p.add_argument("-f", "--base-name", default="EvaluateCNVResults",
                   help="base output file name (without extension)")
    p.add_argument("--het", type=float, default=1.0, dest="het",
                   help="HeterogeneityFraction: drop 1/1 truth rows whose "
                        "het fraction column is below this")
    p.add_argument("-d", "--skip-diploid", action="store_true",
                   help="skip diploid (REF) calls")
    p.add_argument("--min-size", type=int, default=10000,
                   help="minimum truth/query entry size (reference default "
                        "10000)")
    p.add_argument("--filter-bed", default=None,
                   help="filter bed for the callability metric (the "
                        "reference uses filter13.bed next to kmer.fa)")
    args = p.parse_args(argv)
    # `EvaluateCNV truth vcf outdir`: a third positional that is not an
    # existing bed file is the output directory, not the excluded bed
    if args.output_dir is None and args.excluded is not None \
            and not _Path(args.excluded).is_file():
        args.output_dir, args.excluded = args.excluded, None
    ploidy_fn = (lambda c, s, e: args.ploidy) if args.ploidy else None
    if args.ploidy_x is not None or args.ploidy_y is not None:
        ploidy_fn = sex_ploidy_fn(
            args.ploidy_x if args.ploidy_x is not None else 2,
            args.ploidy_y if args.ploidy_y is not None else 0,
            args.par_bed)

    size_bins = [(0, 2 ** 31 - 1)]
    if args.split_by_size:
        size_bins += SIZE_SPLITS
    out = None
    if args.output_dir:
        out = _Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
    for min_size, max_size in size_bins:
        report_parts = []
        for passing in (True, False):
            m, counter = evaluate(
                args.truth, args.cnv_vcf, args.excluded,
                passing_only=passing, dq_threshold=args.dq_threshold,
                ploidy_fn=ploidy_fn, sample_index=args.sample_index,
                min_size=min_size, max_size=max_size,
                roi_path=args.roi_bed, kmer_fa=args.kmer_fa,
                return_counter=True, min_entry_size=args.min_size,
                heterogeneity_fraction=args.het,
                skip_diploid=args.skip_diploid)
            report_parts.append(
                format_report(m, counter, passing_only=passing))
        report = "\n".join(report_parts) + "\n"
        name = args.base_name
        if args.dq_threshold is not None:
            name += "_denovo"
        if min_size != 0 or max_size != 2 ** 31 - 1:
            name += f"_{round(min_size / 1000)}kb"
            name += "+" if max_size == 2 ** 31 - 1 \
                else f"_{round(max_size / 1000)}kb"
        if out is not None:
            (out / f"{name}.txt").write_text(report)
        if min_size == 0 and max_size == 2 ** 31 - 1:
            sys.stdout.write(report)
        else:
            sys.stdout.write(f"== {name} ==\n" + report)

    filter_bed = args.filter_bed
    if filter_bed is None and args.kmer_fa:
        cand = _Path(args.kmer_fa).parent / "filter13.bed"
        if cand.exists():
            filter_bed = str(cand)
    if filter_bed and args.kmer_fa:
        from canvas_tpu_torch.genome.reference import read_fasta

        lengths = {c: len(a) for c, a in read_fasta(args.kmer_fa).items()}
        calls = load_cnv_calls(args.cnv_vcf, sample_index=args.sample_index,
                               ploidy_fn=ploidy_fn,
                               dq_threshold=args.dq_threshold)
        called, total = compute_callability(
            calls, filter_bed, lengths, exclude_chr_y=(args.ploidy_y == 0))
        text = format_callability(called, total)
        if out is not None:
            (out / f"{args.base_name}_callability.txt").write_text(text)
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
