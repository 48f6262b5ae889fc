"""Workflow orchestration — the CanvasRunner replacement.

The reference chains nine executables through checkpointed subprocess
launches with files as transport (CanvasRunner.cs:783-881).  Here each mode
is one in-process pipeline; stage outputs are still checkpointed to the
work directory (BinSet text files, partitioned files, VF files) so a rerun
resumes from completed stages — the same contract as Isas
ICheckpointRunner (SURVEY.md §5).

Modes (Canvas/Program.cs:13-23):
  Germline-WGS             single sample, wavelets (germline), diploid caller
  Somatic-WGS              tumor[/normal], wavelets, somatic caller
  Somatic-Enrichment       manifest-driven, CBS, somatic caller
  Tumor-normal-enrichment  as above with a normal ratio
  SmallPedigree-WGS        per-sample HMM, joint pedigree caller

With more than one device (WorkflowContext.devices, or every visible card
for an unindexed "cuda"), binning places its contigs round-robin on them
and the HMM decodes split their lanes over them; with more than one
process (torch.distributed, see pipeline/cli.py), CanvasBin splits its BAM
scan over the processes and all-gathers the read starts.

The run's device (WorkflowContext.device) is explicit: binning runs kernel
B1 there (GCContentWeighted its float32 row sums in position order), the
PerSampleHMM and joint (HMM) decodes kernels B2 and B3, the joint HMM its
genotype-permutation emissions, the pedigree joint likelihood and the
somatic model grid their float64 contractions, and CBS its frontier engine
with the arc-scan kernel B4 (on a CUDA device; on the CPU the host CBS path
runs).  The wavelet partition, the coverage metrics and the common-CNV set
choice are host numpy on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from canvas_tpu_torch.config import CanvasConfig, resolve_device
from canvas_tpu_torch.genome.contigs import ContigTable, is_canonical
from canvas_tpu_torch.genome.reference import load_reference_tracks
from canvas_tpu_torch.io import bam as bamio
from canvas_tpu_torch.io import snv as snvio
from canvas_tpu_torch.io import vcf_write
from canvas_tpu_torch.io.bins import BinSet
from canvas_tpu_torch.io.ploidy import PloidyInfo, load_ploidy_vcf
from canvas_tpu_torch.models import diploid as diploid_caller
from canvas_tpu_torch.models import pedigree as pedigree_caller
from canvas_tpu_torch.models import qscore
from canvas_tpu_torch.models import somatic as somatic_caller
from canvas_tpu_torch.models.segment_model import (
    SEGMENT_SIZE_CUTOFF, merge_segments, merge_segments_multisample,
    merge_segments_using_excluded_intervals, set_filters)
from canvas_tpu_torch.ops import (binning, cbs, cbs_mega, hmm, metrics,
                                  normalize, ratio, wavelets)
from canvas_tpu_torch.ops import stats as seg_stats
from canvas_tpu_torch.ops import segments as segops
from canvas_tpu_torch.parallel import distributed
from canvas_tpu_torch.pipeline import profiling, segments_io


class StopAfterCheckpoint(Exception):
    """Raised at the first stage boundary past --stop-checkpoint; the CLI
    catches it and exits 0 (the Isas checkpointer's stop semantics)."""

    def __init__(self, checkpoint: str):
        super().__init__(f"stopping after checkpoint {checkpoint!r}")
        self.checkpoint = checkpoint


@dataclass
class Checkpointer:
    """File-based stage checkpointing (ICheckpointRunner contract).

    start_checkpoint / stop_checkpoint implement the reference's
    `-c` / `-s` flags (CommonOptionsParser.cs:13-14, wired through
    IsasFrameworkFactory.RunWithCheckpointer, MainParser.cs:223): a value
    is a stage name ("CanvasPartition") or its 1-based number in
    execution order.  Stages before the start checkpoint load their saved
    results; the start checkpoint and everything after re-run even when
    their artifacts exist.  The workflow stops at the first stage boundary
    after the stop checkpoint completes."""

    work_dir: Path
    resume: bool = True
    start_checkpoint: str | None = None
    stop_checkpoint: str | None = None

    def __post_init__(self):
        self.work_dir = Path(self.work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._order: list[str] = []      # stage names in first-seen order
        self._started = self.start_checkpoint is None
        self._stop_seen = False

    def path(self, name: str) -> Path:
        return self.work_dir / name

    def _matches(self, spec: str, stage_name: str) -> bool:
        if spec.isdigit():
            return len(self._order) == int(spec) \
                and self._order[-1] == stage_name
        return spec == stage_name

    def stage(self, name: str) -> None:
        """Stage-boundary notification (workflows call this at every
        prof.stage entry).

        Stage names are assumed UNIQUE and non-re-entrant per workflow
        (true of every current workflow): an A,B,A re-entry would not be
        re-appended to _order, so numeric -c/-s specs could never match
        the re-entry and the stop gate would key off the last distinct
        name.  Give a repeated pass a distinct name (e.g. "bin:pass2")."""
        if self._stop_seen and name != self._order[-1]:
            raise StopAfterCheckpoint(self.stop_checkpoint)
        if not self._order or self._order[-1] != name:
            if name not in self._order:
                self._order.append(name)
        if self.start_checkpoint is not None \
                and self._matches(self.start_checkpoint, name):
            self._started = True
        if self.stop_checkpoint is not None \
                and self._matches(self.stop_checkpoint, name):
            self._stop_seen = True

    def done(self, name: str) -> bool:
        if self._started and self.start_checkpoint is not None:
            return False                 # at/after -c: always re-run
        return self.resume and self.path(name).exists()

    def finish(self, partial: bool = False) -> None:
        """Called after a workflow completes: a -c/-s spec that never
        matched any stage is an error, not a silent no-op (otherwise a
        typo'd -c loads every checkpoint and re-runs nothing).

        With partial=True (a -s/--stop-checkpoint run that exited early)
        only the start checkpoint is validated: the truncated run still
        walked every stage up to the stop point, so a -c that never
        matched is just as much a typo there — but later stages never ran,
        so the stop spec itself is exempt (it necessarily matched to get
        here)."""
        if self.start_checkpoint is not None and not self._started:
            raise ValueError(
                f"--start-checkpoint {self.start_checkpoint!r} matched no "
                f"stage; stages were: {', '.join(self._order)}")
        if partial:
            return
        if self.stop_checkpoint is not None and not self._stop_seen:
            raise ValueError(
                f"--stop-checkpoint {self.stop_checkpoint!r} matched no "
                f"stage; stages were: {', '.join(self._order)}")

    def run(self, name: str, produce, load, save):
        """Run `produce()` unless checkpoint `name` exists; persist via
        save(value, path) / load(path).

        The fresh value is re-read through its serialized form so a run and
        a resume see bit-identical inputs (the reference pipes every stage
        through text files, so e.g. bin counts are always %.2f-rounded)."""
        p = self.path(name)
        if self.done(name):
            return load(p)
        value = produce()
        save(value, p)
        return load(p)


@dataclass
class Sample:
    name: str
    bam_path: str
    sample_type: str = "Other"   # Father/Mother/Proband/Sibling/Other
    normal_vcf: str | None = None
    ploidy_vcf: str | None = None
    # --population-b-allele-vcf (dbSNP sites; no genotype filtering,
    # SingleSampleCommonOptionsParser.cs:8-13 + SNVReviewer IsDbSnpVcf)
    is_dbsnp_vcf: bool = False
    # genotype column to use when normal_vcf is a multisample VCF (the
    # reference passes a single pedigree VCF to every sample's CanvasSNV)
    vcf_sample_name: str | None = None


@dataclass
class WorkflowContext:
    reference_folder: str                 # contains kmer.fa (+ GenomeSize.xml)
    output_dir: str
    config: CanvasConfig = field(default_factory=CanvasConfig)
    filter_bed: str | None = None
    resume: bool = True
    start_checkpoint: str | None = None   # -c (CommonOptionsParser.cs:13)
    stop_checkpoint: str | None = None    # -s (CommonOptionsParser.cs:14)
    # -g genome folder (CommonOptionsParser.cs:10): where genome.fa and
    # GenomeSize.xml live when not next to kmer.fa
    genome_folder: str | None = None
    # the run's device, "cuda" or "cpu"; a CUDA device that is not there
    # raises here instead of running on the CPU
    device: str | torch.device = "cuda"
    # the devices binning and the HMM decodes split their contigs over (a
    # parallel.mesh.Mesh or a list, entries may repeat); None: every
    # visible card for an unindexed "cuda", else `device` alone
    devices: object = None

    @staticmethod
    def resolve_kmer(reference: str) -> Path:
        """-r accepts the kmer.fa file itself (the reference's KmerFasta
        FileOption, CommonOptionsParser.cs:8) or a folder containing
        kmer.fa — one resolver shared by the CLI's existence check and
        the loader below."""
        ref = Path(reference)
        return ref if ref.is_file() else ref / "kmer.fa"

    @property
    def genome_fasta(self) -> Path:
        """genome.fa for the VCF ##reference header: the -g genome folder
        when given (CommonOptionsParser.cs:10), else next to kmer.fa."""
        if self.genome_folder:
            g = Path(self.genome_folder) / "genome.fa"
            if g.exists():
                return g
        return Path(self.reference_folder) / "genome.fa"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        kmer = self.resolve_kmer(self.reference_folder)
        ref = kmer.parent
        self.reference_folder = str(ref)
        gs = ref / "GenomeSize.xml"
        if not gs.exists() and self.genome_folder:
            gs = Path(self.genome_folder) / "GenomeSize.xml"
        contigs = (ContigTable.from_genome_size_xml(gs) if gs.exists() else None)
        self.contigs, self.tracks = load_reference_tracks(kmer, contigs)
        self.excluded_intervals = None
        if self.filter_bed:
            from canvas_tpu_torch.io.bed import load_bed_intervals

            # filter-bed positions stop being 'possible' alignment starts
            # (CanvasBin.ExcludeTagsOverlappingFilterFile, CanvasBin.cs:668-691)
            self.excluded_intervals = load_bed_intervals(self.filter_bed)
            for chrom, ivals in self.excluded_intervals.items():
                if chrom not in self.tracks:
                    continue
                possible = self.tracks[chrom]["possible"]
                for s, e in ivals:
                    possible[s:min(e, len(possible))] = False
        self.canonical = [n for n in self.contigs.names
                          if is_canonical(n) and n in self.tracks]
        self.checkpointer = Checkpointer(Path(self.output_dir) / "Checkpoints",
                                         self.resume,
                                         self.start_checkpoint,
                                         self.stop_checkpoint)


# ---------------------------------------------------------------------------
# Stage functions
# ---------------------------------------------------------------------------

def ingest_observed(ctx: WorkflowContext, sample: Sample,
                    contigs: list[str] | None = None
                    ) -> dict[str, np.ndarray]:
    """Per-contig observed read-start counts from the sample BAM.

    Uses the native C++ scanner (multithreaded BGZF + single-pass filter)
    when available; falls back to the pure-Python reader.  `contigs`
    restricts the scan to a subset (the multi-process contig split)."""
    from canvas_tpu_torch import native

    canonical = contigs if contigs is not None else ctx.canonical
    refs = native.read_bam_refs(sample.bam_path) if native.available() else None
    if refs is not None:
        # ONE streaming pass for all contigs; non-canonical refs get a
        # zero-length slot so their records are skipped without memory
        wanted = set(canonical)
        lengths = [L if name in wanted else 0 for name, L in refs]
        per_ref = native.scan_read_starts_all(sample.bam_path, lengths)
        if per_ref is not None:
            by_name = {name: per_ref[i] for i, (name, _) in enumerate(refs)}
            return {c: by_name.get(c,
                                   np.zeros(ctx.contigs.length(c), np.uint8))
                    for c in canonical}
        ref_index = {name: i for i, (name, _) in enumerate(refs)}
        ref_len = {name: L for name, L in refs}
        observed = {}
        for contig in canonical:
            if contig in ref_index:
                obs = native.scan_read_starts(
                    sample.bam_path, ref_index[contig], ref_len[contig])
                if obs is not None:
                    observed[contig] = obs
                    continue
            observed[contig] = np.zeros(ctx.contigs.length(contig), np.uint8)
        return observed
    bam = bamio.BamFile.read(sample.bam_path)
    observed = {}
    for contig in canonical:
        obs, _ = bamio.read_start_counts(bam, contig)
        observed[contig] = obs
    return observed


def ingest_observed_with_fragments(
    ctx: WorkflowContext, sample: Sample,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """GCContentWeighted ingest: per-contig observed counts AND stored
    forward-fragment lengths (CanvasBin.cs:261-266); one native streaming
    pass when available, else the Python reader."""
    from canvas_tpu_torch import native

    refs = native.read_bam_refs(sample.bam_path) if native.available() else None
    if refs is not None:
        wanted = set(ctx.canonical)
        lengths = [L if name in wanted else 0 for name, L in refs]
        res = native.scan_with_fragments_all(sample.bam_path, lengths)
        if res is not None:
            per_obs, per_frag = res
            obs_by = {name: per_obs[i] for i, (name, _) in enumerate(refs)}
            frag_by = {name: per_frag[i] for i, (name, _) in enumerate(refs)}
            zeros = lambda c, dt: np.zeros(ctx.contigs.length(c), dt)
            return ({c: obs_by.get(c, zeros(c, np.uint8))
                     for c in ctx.canonical},
                    {c: frag_by.get(c, zeros(c, np.int16))
                     for c in ctx.canonical})
    bam = bamio.BamFile.read(sample.bam_path)
    observed, fragments = {}, {}
    for contig in ctx.canonical:
        obs, frag = bamio.read_start_counts(bam, contig,
                                            mode="GCContentWeighted")
        observed[contig], fragments[contig] = obs, frag
    return observed, fragments


def _gc_weight_tracks(ctx: WorkflowContext,
                      observed: dict[str, np.ndarray],
                      fragments: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Per-position GC-correction weights (CanvasBin.cs:330-506): per-read
    fragment GC percent -> genome-wide observed/expected-by-GC ratio ->
    weight = ratio[readGC[pos]]."""
    mean_frag = binning.mean_fragment_size(fragments)
    read_gc = {c: binning.read_gc_content(
        np.asarray(ctx.tracks[c]["is_gc"], bool), fragments[c], mean_frag)
        for c in fragments}
    obs_vs_exp = binning.observed_vs_expected_gc(read_gc, observed)
    return {c: binning.gc_weights_for_contig(read_gc[c], obs_vs_exp)
            for c in read_gc}


def autosome_rates(ctx: WorkflowContext,
                   observed: dict[str, np.ndarray]) -> list[float]:
    from canvas_tpu_torch.genome.contigs import is_autosome

    return [binning.contig_rate(ctx.tracks[c]["possible"], observed[c])
            for c in ctx.canonical if is_autosome(c)]


def run_bin(ctx: WorkflowContext, sample: Sample,
            bin_size: int | None = None,
            observed: dict[str, np.ndarray] | None = None) -> tuple[BinSet, int]:
    """CanvasBin: ingest BAM read starts + device binning.

    With bin_size given, uses the shared multi-sample bin size (the
    reference's CalculateMultiSampleBinSize harmonization,
    CanvasRunner.cs:258-278) so bin boundaries align across samples."""
    ckpt = ctx.checkpointer
    name = f"CanvasBin_{sample.name}.binned.gz"

    size_file = ckpt.path(f"CanvasBin_{sample.name}.binsize.txt")

    def produce():
        mode = ctx.config.coverage_mode
        if mode == "Fragment":
            raise ValueError(
                "Fragment coverage mode needs predefined bins (enrichment "
                "manifest); CanvasBin requires -n with -m Fragment")
        gc_weights = None
        if mode == "GCContentWeighted" and observed is None:
            obs, fragments = ingest_observed_with_fragments(ctx, sample)
            gc_weights = _gc_weight_tracks(ctx, obs, fragments)
        elif observed is not None:
            # SmallPedigree-WGS hands its observed counts in, so no weights
            # are made and GCContentWeighted bins as TruncatedDynamicRange,
            # as canvas_tpu does (ROADMAP Queue C, C1)
            obs = observed
        elif distributed.world_size() > 1:
            # several processes: each scans its size-balanced contig
            # subset, then the per-contig tracks are all-gathered so every
            # process holds the full genome (the reference's
            # per-chromosome intermediate-file merge, CanvasBin.cs:965-1035)
            mine = distributed.my_contigs(
                {c: ctx.contigs.length(c) for c in ctx.canonical})
            profiling.current().note(
                "CanvasBinScan", process=distributed.rank(),
                processes=distributed.world_size(), contigs=mine)
            local = ingest_observed(ctx, sample, contigs=mine)
            obs = distributed.all_gather_host_data(
                local, shapes={c: (ctx.contigs.length(c), np.uint8)
                               for c in ctx.canonical})
        else:
            obs = ingest_observed(ctx, sample)
        bs = bin_size or ctx.config.fixed_bin_size or \
            binning.bin_size_from_rates(
                ctx.config.counts_per_bin, autosome_rates(ctx, obs))
        size_file.write_text(f"{bs}\n")
        tracks = {c: dict(possible=ctx.tracks[c]["possible"],
                          observed=obs[c],
                          is_gc=ctx.tracks[c]["is_gc"],
                          offset=ctx.tracks[c]["offset"],
                          gc_weights=(gc_weights or {}).get(c))
                  for c in ctx.canonical}
        if mode == "GCContentWeighted" and gc_weights is None:
            mode = "TruncatedDynamicRange"
        per_contig = binning.bin_sample(tracks, bs, mode=mode,
                                        device=ctx.device,
                                        devices=ctx.devices)
        cid, st, en, gc, cnt = [], [], [], [], []
        for i, cname in enumerate(ctx.contigs.names):
            if cname not in per_contig:
                continue
            s, e, g, c = per_contig[cname]
            cid.append(np.full(len(s), i, np.int32))
            st.append(s); en.append(e); gc.append(g); cnt.append(c)
        bins = BinSet(ctx.contigs, np.concatenate(cid), np.concatenate(st),
                      np.concatenate(en), np.concatenate(gc),
                      np.concatenate(cnt))
        return bins

    bins = ckpt.run(name, produce,
                    load=lambda p: BinSet.read_text(p, ctx.contigs),
                    save=lambda b, p: b.write_text(p))
    used = int(size_file.read_text()) if size_file.exists() else 0
    return bins, used


def run_clean(ctx: WorkflowContext, sample: Sample, bins: BinSet,
              compute_local_sd: bool = False) -> tuple[BinSet, float | None]:
    ckpt = ctx.checkpointer
    name = f"CanvasClean_{sample.name}.cleaned.gz"
    sd_name = f"LocalSdMetric_{sample.name}.txt"

    def produce():
        cleaned, local_sd = normalize.clean(
            bins, compute_local_sd=compute_local_sd,
            mode=ctx.config.gc_norm_mode,
            min_bins_per_gc=ctx.config.min_bins_per_gc_weighted_median)
        return cleaned, local_sd

    if ckpt.done(name):
        cleaned = BinSet.read_text(ckpt.path(name), ctx.contigs)
        local_sd = None
        if ckpt.path(sd_name).exists():
            local_sd = float(ckpt.path(sd_name).read_text().strip())
        return cleaned, local_sd
    cleaned, local_sd = produce()
    cleaned.write_text(ckpt.path(name))
    if local_sd is not None:
        ckpt.path(sd_name).write_text(f"{local_sd}\n")
    # re-read through the text form for run/resume bit-consistency
    return BinSet.read_text(ckpt.path(name), ctx.contigs), local_sd


def run_snv(ctx: WorkflowContext, sample: Sample,
            is_somatic: bool = False) -> Path | None:
    """CanvasSNV: b-allele counts at het sites -> VFResults file."""
    if sample.normal_vcf is None:
        return None
    ckpt = ctx.checkpointer
    out = ckpt.path(f"VFResults_{sample.name}.txt.gz")
    if ckpt.done(out.name):
        return out
    by_chrom = snvio.load_het_snvs_multi(sample.normal_vcf,
                                         list(ctx.canonical),
                                         sample_name=sample.vcf_sample_name,
                                         is_somatic=is_somatic,
                                         is_dbsnp=sample.is_dbsnp_vcf)
    if not snvio.pileup_counts_native(sample.bam_path, by_chrom):
        bam = bamio.BamFile.read(sample.bam_path)
        for contig in ctx.canonical:
            snvio.pileup_counts(bam, contig, by_chrom[contig])
    all_sites: list[snvio.SnvSite] = []
    for contig in ctx.canonical:
        contig_sites = [s for s in by_chrom[contig]
                        if snvio.is_variant_site(s, sample.is_dbsnp_vcf)]
        # per-chromosome interop file the reference's CanvasSNV emits
        # before concatenation (<chr>-<sample>.SNV.txt.gz,
        # SNVReviewer.cs:283-297 + CanvasRunner.cs:688-710) — enables
        # differential debugging against reference stage outputs
        snvio.write_frequencies(
            ckpt.path(f"{contig}-{sample.name}.SNV.txt.gz"), contig_sites)
        all_sites.extend(contig_sites)
    snvio.write_frequencies(out, all_sites)
    # VFResults baf companion (ConcatenateCanvasSNVBafResults target,
    # CanvasRunner.cs:677-683)
    snvio.write_baf_csv(ckpt.path(f"VFResults_{sample.name}.baf"), all_sites)
    return out


def coverage_by_contig(bins: BinSet) -> dict[str, np.ndarray]:
    return {name: bins.count[sl].astype(np.float64)
            for name, sl in bins.contig_slices().items()}


def _cbs_work() -> dict:
    """The whole-recursion CBS engine's counters, cumulative in the
    process (cbs_mega.WORK, GRAPHS' replays, SYNCS' reads): a stage's
    differences are its engine runs and their work."""
    return {"engine_calls": cbs_mega.WORK["calls"],
            "arc_pairs": cbs_mega.WORK["arc_pairs"],
            "walk_chunks": cbs_mega.WORK["walk_chunks"],
            "graph_replays": cbs_mega.GRAPHS["replays"],
            "engine_reads": cbs_mega.SYNCS["cbs_mega"]}


def run_partition(
    ctx: WorkflowContext, samples_bins: dict[str, BinSet], method: str,
    is_germline: bool, ploidy: PloidyInfo | None = None,
) -> dict[str, dict[str, list]]:
    """CanvasPartition: segmentation + post-processing per sample.

    Returns sample -> contig -> list[Segment] (with confidence intervals)."""
    cfg = ctx.config
    if method not in ("PerSampleHMM", "HMM", "Wavelets", "CBS"):
        raise ValueError(f"unknown partition method {method}")
    per_sample_spans: dict[str, dict[str, list[segops.Span]]] = {}
    cov_cache = {name: coverage_by_contig(b) for name, b in samples_bins.items()}
    # reset so post-stage attribution is never stale
    cbs._LAST_ENGINE.update(engine=None, host_workers=None, levels=None)

    for name, bins in samples_bins.items():
        cov = cov_cache[name]
        if method == "PerSampleHMM":
            # all contigs in one batched decode on the run's device
            bps = hmm.segment_coverage_batched(cov, device=ctx.device,
                                               devices=ctx.devices)
        elif method == "HMM":
            # joint multi-sample decode: every contig's [T, D] coverage of
            # all samples as lanes of one decode on the run's device
            bps = hmm.segment_coverage_joint_batched(
                {c: np.stack([cov_cache[n][c] for n in samples_bins], axis=1)
                 for c in cov}, device=ctx.device, devices=ctx.devices)
        elif method == "Wavelets":
            # host numpy on every device, as in canvas_tpu
            cv = metrics.coverage_variability(cov, cfg.evenness_score_window)
            cmads = metrics.factor_of_three_cmads(cov)
            bps = wavelets.segment_coverage(
                cov, is_germline, cv, cmads, mad_factor=cfg.mad_factor,
                threshold_lower=cfg.threshold_lower_maf)
        else:
            # the frontier engine (kernel B4) on a CUDA device, the host
            # path on the CPU
            lens = cbs.run_cbs(cov, alpha=cfg.cbs_alpha, device=ctx.device)
            bps = {}
            for c, lengths in lens.items():
                ends = np.cumsum(lengths)
                bps[c] = [0] + [int(e) for e in ends[:-1]]
        spans = {}
        slices = bins.contig_slices()
        for c, sl in slices.items():
            starts, ends = bins.start[sl], bins.end[sl]
            spans[c] = segops.derive_segments(
                bps.get(c, [0]) or [0], len(starts), starts, ends)
        per_sample_spans[name] = spans
        if method == "HMM":
            break  # joint segmentation: one pass covers all samples

    if method == "HMM":
        for name in samples_bins:
            per_sample_spans[name] = per_sample_spans[next(iter(
                per_sample_spans))]
    elif len(samples_bins) > 1:
        # SplitOverlappingSegments across samples (PerSampleHMM / CBS paths)
        contigs_all = set()
        for spans in per_sample_spans.values():
            contigs_all.update(spans)
        union: dict[str, list[segops.Span]] = {}
        for c in contigs_all:
            union[c] = segops.split_overlapping_segments(
                [per_sample_spans[n].get(c, []) for n in samples_bins])
        for name in samples_bins:
            per_sample_spans[name] = union

    # post-process into numbered segments per sample
    out: dict[str, dict[str, list]] = {}
    for name, bins in samples_bins.items():
        slices = bins.contig_slices()
        bin_start = {c: bins.start[sl] for c, sl in slices.items()}
        bin_end = {c: bins.end[sl] for c, sl in slices.items()}
        covd = {c: bins.count[sl] for c, sl in slices.items()}
        span_starts = {c: {sp.start for sp in spans}
                       for c, spans in per_sample_spans[name].items()}
        ploidy_breaks = ({c: ploidy.breaks_for_contig(c) for c in bin_start}
                         if ploidy else None)
        numbered = segops.post_process_segments(
            span_starts, {}, bin_start, bin_end,
            # forbidden-interval midpoints force segment breaks
            # (SegmentationResultsProcessor.cs:95-110); the filter bed is the
            # ForbiddenIntervalBedPath the orchestrator feeds CanvasPartition
            excluded_by_contig=ctx.excluded_intervals,
            max_inter_bin_dist=cfg.max_inter_bin_dist_in_segment,
            ploidy_breaks_by_contig=ploidy_breaks)
        # interop stage output matching CanvasPartition's
        # <sample>.partitioned (Segmentation.cs:235-252) for differential
        # debugging against reference runs
        segops.write_partitioned(
            ctx.checkpointer.path(f"{name}.partitioned"),
            numbered, bin_start, bin_end, covd)
        by_contig: dict[str, list] = {}
        for c, segs in numbered.items():
            ids = np.concatenate([
                np.full(len(s.bin_indices), s.identifier) for s in segs]) \
                if segs else np.zeros(0, np.int64)
            by_contig[c] = segments_io.segments_from_rows(
                c, bin_start[c], bin_end[c], covd[c], ids)
        out[name] = by_contig
    return out


def attach_alleles(ctx: WorkflowContext, sample: Sample,
                   segments_by_contig: dict[str, list],
                   vf_path) -> float | None:
    """Attach b-allele counts to segments.

    Returns the mean per-site total allele coverage over all loaded sites
    (countRef+countAlt averaged), which the reference uses as MeanCoverage
    for the balanced-MAF model (CanvasDiploidCaller.cs:298), or None when
    no VF file / no sites."""
    if vf_path is None:
        return None
    intervals = segments_io.segment_intervals(segments_by_contig)
    freqs = snvio.read_frequencies(vf_path, intervals)
    segments_io.add_alleles(segments_by_contig, freqs)
    total, n = 0, 0
    for lists in freqs.values():
        for sites in lists:
            for _, count_ref, count_alt in sites:
                total += count_ref + count_alt
                n += 1
    return (total / n) if n else None


def _flatten(segments_by_contig: dict[str, list], contigs: ContigTable):
    out = []
    for c in contigs.names:
        out.extend(segments_by_contig.get(c, []))
    return out


# ---------------------------------------------------------------------------
# Mode workflows
# ---------------------------------------------------------------------------

def germline_wgs(ctx: WorkflowContext, sample: Sample) -> Path:
    """Germline-WGS: bin -> clean -> wavelets (germline) -> diploid caller."""
    prof = profiling.reset(ctx.device)
    prof.gate = ctx.checkpointer.stage   # -c/-s start/stop-checkpoint
    ploidy = load_ploidy_vcf(sample.ploidy_vcf) if sample.ploidy_vcf else None
    with prof.stage("CanvasBin"):
        bins, _ = run_bin(ctx, sample)
    with prof.stage("CanvasClean", bins=len(bins)):
        cleaned, _ = run_clean(ctx, sample, bins)
    with prof.stage("CanvasSNV"):
        vf = run_snv(ctx, sample, is_somatic=False)
    with prof.stage("CanvasPartition", bins=len(cleaned)):
        parts = run_partition(ctx, {sample.name: cleaned},
                              ctx.config.partition_method or "Wavelets",
                              is_germline=True, ploidy=ploidy)
    segs_by_contig = parts[sample.name]
    mean_allele_cov = attach_alleles(ctx, sample, segs_by_contig, vf)
    segs = _flatten(segs_by_contig, ctx.contigs)
    with prof.stage("CanvasDiploidCaller", segments=len(segs)):
        called, dip_cov = diploid_caller.call_variants(
            segs, ctx.config.quality_filter_threshold, ctx.config.qscore,
            mean_allele_coverage=mean_allele_cov)
    out = Path(ctx.output_dir) / f"{sample.name}_CNV.vcf.gz"
    vcf_write.write_segments(
        out, [called], [sample.name], ctx.contigs, diploid_coverage=dip_cov,
        reference_cn_fn=(lambda i, s: ploidy.reference_copy_number(
            s.chrom, s.begin, s.end)) if ploidy else None,
        quality_threshold=ctx.config.quality_filter_threshold,
        reference_path=str(ctx.genome_fasta))
    _write_visualization(ctx, sample.name, called, dip_cov, ploidy)
    prof.write(Path(ctx.output_dir) / f"{sample.name}_profile.json")
    return out


def _write_visualization(ctx, sample_name, segments, diploid_coverage,
                         ploidy=None):
    """Coverage/VF plot data + bedgraph tracks (SingleSampleCallset outputs).

    Visualization outputs are debug artifacts written AFTER the VCF; a
    degenerate callset (e.g. no CN!=0 segment carrying bins, which makes
    compute_normalization_factor raise) must not fail the workflow, so
    each track is written under a log-and-continue guard, mirroring the
    reference's non-fatal handling of its bedgraph/bigwig debug outputs.
    """
    import logging

    from canvas_tpu_torch.io import visualization as viz

    log = logging.getLogger(__name__)
    out = Path(ctx.output_dir)

    def _guarded(what, fn, *args):
        try:
            fn(*args)
        except Exception as e:      # noqa: BLE001 - debug outputs only
            log.warning("skipping visualization output %s: %s", what, e)

    _guarded("coverage plot data", viz.write_coverage_plot_data,
             out / f"{sample_name}_CNV.CoverageAndVariantFrequency.txt",
             segments, ctx.contigs, diploid_coverage, ploidy)
    _guarded("copy-number bedgraph", viz.write_copy_number_bedgraph,
             out / f"{sample_name}_CNV.CopyNumber.bedgraph", segments, ploidy)
    _guarded("b-allele bedgraph", viz.write_ballele_bedgraph,
             out / f"{sample_name}_CNV.BAlleleFrequency.bedgraph", segments)
    cov_bg = out / f"{sample_name}_CNV.Coverage.bedgraph"
    _guarded("coverage bedgraph", viz.write_coverage_bedgraph,
             cov_bg, segments)
    # bigwig only when the external converter exists (reference behavior)
    _guarded("coverage bigwig", viz.bedgraph_to_bigwig,
             cov_bg, ctx.contigs, out / f"{sample_name}_CNV.Coverage.bw")


def run_bin_predefined(ctx: WorkflowContext, sample: Sample,
                       manifest) -> BinSet:
    """Enrichment binning: count into manifest target bins (host numpy)."""
    from canvas_tpu_torch.io.manifest import predefined_bins

    ckpt = ctx.checkpointer
    name = f"CanvasBin_{sample.name}.binned.gz"

    def produce():
        mode = ctx.config.coverage_mode
        pb = predefined_bins(manifest)
        if mode == "Fragment":
            # FragmentBinner: properly-paired fragments assigned to the
            # max-overlap bin with pair-undo bookkeeping
            # (FragmentBinner.cs:26-81,256-312)
            from canvas_tpu_torch.ops import fragments as fragops

            bam = bamio.BamFile.read(sample.bam_path)
            cid, st, en, gc, cnt = [], [], [], [], []
            for i, cname in enumerate(ctx.contigs.names):
                if cname not in pb or cname not in ctx.tracks:
                    continue
                starts, ends = pb[cname]
                t = ctx.tracks[cname]
                idx = bam.ref_index(cname)
                recs = (r for r in bam.records(want_seq=False)
                        if r.ref_id == idx)
                counts, _ = fragops.bin_fragments(recs, starts, ends)
                g, _ = binning.bin_predefined_np(
                    t["possible"], np.zeros(t["length"], np.uint8),
                    t["is_gc"], starts, ends)
                cid.append(np.full(len(starts), i, np.int32))
                st.append(starts); en.append(ends); gc.append(g)
                cnt.append(counts.astype(np.float32))
            return BinSet(ctx.contigs, np.concatenate(cid),
                          np.concatenate(st), np.concatenate(en),
                          np.concatenate(gc), np.concatenate(cnt))
        gc_weights = {}
        if mode == "GCContentWeighted":
            obs, fragments = ingest_observed_with_fragments(ctx, sample)
            gc_weights = _gc_weight_tracks(ctx, obs, fragments)
        else:
            obs = ingest_observed(ctx, sample)
        cid, st, en, gc, cnt = [], [], [], [], []
        for i, cname in enumerate(ctx.contigs.names):
            if cname not in pb or cname not in ctx.tracks:
                continue
            starts, ends = pb[cname]
            t = ctx.tracks[cname]
            g, c = binning.bin_predefined_np(
                t["possible"], obs.get(cname, np.zeros(t["length"], np.uint8)),
                t["is_gc"], starts, ends, mode=mode,
                gc_weights=gc_weights.get(cname))
            cid.append(np.full(len(starts), i, np.int32))
            st.append(starts); en.append(ends); gc.append(g); cnt.append(c)
        return BinSet(ctx.contigs, np.concatenate(cid), np.concatenate(st),
                      np.concatenate(en), np.concatenate(gc),
                      np.concatenate(cnt))

    return ckpt.run(name, produce,
                    load=lambda p: BinSet.read_text(p, ctx.contigs),
                    save=lambda b, p: b.write_text(p))


def _bin_ploidy_array(bins: BinSet, ploidy: PloidyInfo | None) -> np.ndarray | None:
    """Per-bin reference ploidy from a ploidy VCF
    (CanvasNormalizeUtilities.RatiosToCounts honors the ploidy VCF)."""
    if ploidy is None:
        return None
    out = np.full(len(bins), 2.0)
    names = bins.contigs.names
    for chrom in ploidy.by_chromosome:
        if chrom not in names:
            continue
        ci = names.index(chrom)
        idx = np.flatnonzero(bins.contig_id == ci)
        for i in idx:
            out[i] = ploidy.reference_copy_number(
                chrom, int(bins.start[i]), int(bins.end[i]))
    return out


def somatic_wgs(ctx: WorkflowContext, tumor: Sample,
                normal: Sample | None = None,
                somatic_vcf: str | None = None,
                manifest_path: str | None = None,
                controls: list[Sample] | None = None,
                control_binned: str | None = None,
                control_ploidy_vcf: str | None = None,
                pca_model_file: str | None = None) -> Path:
    """Somatic-WGS (wavelets) / Somatic-Enrichment (manifest bins + CBS):
    bin -> [T/N(panel) ratio] -> clean -> partition -> somatic caller.
    Normalization runs on BINNED counts and CanvasClean on the ratio
    pseudo-counts, matching the reference stage order
    (CanvasRunner.NormalizeCoverage inside InvokeCanvasBin, :246-251,473-481
    -> CanvasClean :810)."""
    from canvas_tpu_torch.io.manifest import Manifest
    from canvas_tpu_torch.ops import smooth as smooth_ops

    is_enrichment = manifest_path is not None
    manifest = Manifest.read(manifest_path) if is_enrichment else None
    ploidy = load_ploidy_vcf(tumor.ploidy_vcf) if tumor.ploidy_vcf else None
    prof = profiling.reset(ctx.device)
    prof.gate = ctx.checkpointer.stage   # -c/-s start/stop-checkpoint
    all_controls = ([normal] if normal else []) + list(controls or [])
    with prof.stage("CanvasBin"):
        if is_enrichment:
            t_bins = run_bin_predefined(ctx, tumor, manifest)
            if ctx.config.smooth_enrichment_bins:
                t_bins = smooth_ops.smooth(t_bins)
            t_bs = None
        else:
            t_bins, t_bs = run_bin(ctx, tumor)
    work_bins = t_bins
    if all_controls or pca_model_file or control_binned:
        with prof.stage("CanvasNormalize"):
            c_bins: list[BinSet] = []
            if control_binned:
                # precomputed Canvas control .binned data
                # (SomaticEnrichmentModeParser ControlBinned ->
                # Manifest.CanvasControlBinnedPath, CanvasRunner.cs:501-505)
                c_bins.append(BinSet.read_text(control_binned, ctx.contigs))
            for c in all_controls:
                if is_enrichment:
                    cb = run_bin_predefined(ctx, c, manifest)
                    if ctx.config.smooth_enrichment_bins:
                        cb = smooth_ops.smooth(cb)
                else:
                    # shared bin size -> identical boundaries (bins
                    # accumulate possible positions, not observed counts)
                    cb, _ = run_bin(ctx, c, bin_size=t_bs or None)
                c_bins.append(cb)
            mode = ctx.config.normalize_mode
            if pca_model_file or mode == "PCA":
                if not pca_model_file:
                    raise ValueError("PCA normalize mode needs a model file")
                _, mu, axes = ratio.load_pca_model(pca_model_file)
                if len(mu) != len(t_bins):
                    raise ValueError(
                        f"PCA model has {len(mu)} bins but the sample has "
                        f"{len(t_bins)}; bins must match the model")
                reference = ratio.pca_reference(t_bins, axes, mu)
                ratios = ratio.raw_ratios(t_bins, reference)
            elif mode == "BestLR2":
                reference = ratio.best_lr2_reference(t_bins, c_bins)
                ratios = ratio.lsnorm_ratios(t_bins, reference)
            else:   # WeightedAverage (default)
                reference = ratio.weighted_average_reference(c_bins)
                ratios = ratio.lsnorm_ratios(t_bins, reference)
            ratio.write_cnd_file(
                t_bins, reference, ratios,
                Path(ctx.output_dir) / f"{tumor.name}.cnd")
            ref_ploidy = ploidy
            if ref_ploidy is None and control_ploidy_vcf:
                ref_ploidy = load_ploidy_vcf(control_ploidy_vcf)
            work_bins = ratio.ratios_to_counts(
                ratios, _bin_ploidy_array(ratios, ref_ploidy))
    with prof.stage("CanvasClean", bins=len(work_bins)):
        work, local_sd = run_clean(ctx, tumor, work_bins,
                                   compute_local_sd=not is_enrichment)
    with prof.stage("CanvasSNV"):
        vf = run_snv(ctx, tumor, is_somatic=True)
    evenness = None
    if not is_enrichment:
        # canvas_tpu's one guard here, kept as it is: a coverage whose
        # evenness cannot be scored (too few bins for a window, so no
        # quartiles) leaves the score None and writes no EvennessMetric
        # file; it sends no stage to another device
        try:
            evenness = metrics.evenness_score(
                coverage_by_contig(work), ctx.config.evenness_score_window)
            # EvennessMetric file, CanvasPartition -> SomaticCaller handoff
            # (Segmentation.cs:260-268, CanvasRunner.cs:950-960)
            ctx.checkpointer.path(
                f"EvennessMetric_{tumor.name}.txt").write_text(
                    f"{evenness:.4f}\n")
        except Exception:
            pass
    work0 = _cbs_work()
    with prof.stage("CanvasPartition", bins=len(work)):
        parts = run_partition(
            ctx, {tumor.name: work},
            ctx.config.partition_method
            or ("CBS" if is_enrichment else "Wavelets"),
            is_germline=False, ploidy=ploidy)
    if cbs.last_engine():   # attribute which CBS engine ran, and its work
        prof.note("CanvasPartitionCbsEngine", cbs_engine=cbs.last_engine(),
                  host_workers=cbs._LAST_ENGINE["host_workers"],
                  frontier_levels=cbs._LAST_ENGINE["levels"],
                  **{k: v - work0[k] for k, v in _cbs_work().items()})
    segs_by_contig = parts[tumor.name]
    attach_alleles(ctx, tumor, segs_by_contig, vf)
    segs = _flatten(segs_by_contig, ctx.contigs)
    genome_length = int(np.sum(ctx.contigs.lengths_array))
    ploidy_fn = ploidy.segment_ploidy_fn() if ploidy else None
    with prof.stage("CanvasSomaticCaller", segments=len(segs)):
        # failure policy (SomaticCaller.cs:404-438): too-few usable
        # segments -> no CNV calls but a valid VCF; uncallable data is
        # fatal for the workflow
        vafs = snvio.load_somatic_snv_vafs(somatic_vcf) \
            if somatic_vcf else None
        try:
            model, headers = somatic_caller.call_somatic(
                segs, genome_length, evenness_score=evenness,
                somatic_vafs=vafs, ref_ploidy_fn=ploidy_fn,
                is_enrichment=is_enrichment,
                debug_dir=Path(ctx.output_dir) / f"TempCNV_{tumor.name}",
                device=ctx.device)
        except Exception as e:
            import logging

            log = logging.getLogger(__name__)
            if ctx.config.somatic_training_mode:
                # training mode (SomaticCaller.cs:409-422): a parameter
                # trial outside the testable range must terminate normally
                # with an EMPTY vcf so the sweep penalizes it
                log.warning("Training mode: not calling any CNVs. "
                            "Reason: %s", e)
                segs = []
                model = somatic_caller.PurityModel(0.0, 0.0)
                headers = []
            elif isinstance(
                    e, somatic_caller.NotEnoughUsableSegmentsException):
                log.error("Not calling any CNVs. Reason: %s", e)
                model = somatic_caller.PurityModel(0.0, 0.0)
                headers = []
            else:
                # UncallableDataException and the rest are fatal for the
                # workflow in production (SomaticCaller.cs:423-438)
                raise
    if local_sd is not None:
        headers.append(f"##LocalSDmetric={local_sd:.2f}")
    qscore.assign_quality_scores(segs, "Logistic", ctx.config.qscore)
    # enrichment merges with a 1 bp span so calls never bridge the gaps
    # between off-adjacent targets; WGS merges across everything except
    # filter-bed intervals (SomaticCaller.cs:455-456)
    if is_enrichment:
        merged = merge_segments(segs, somatic_caller.MINIMUM_CALL_SIZE,
                                maximum_merge_span=1)
    else:
        merged = merge_segments_using_excluded_intervals(
            segs, somatic_caller.MINIMUM_CALL_SIZE, ctx.excluded_intervals)
    qscore.assign_quality_scores(merged, "Logistic", ctx.config.qscore)
    set_filters(merged, ctx.config.quality_filter_threshold,
                SEGMENT_SIZE_CUTOFF)
    headers.append(
        f"##EstimatedChromosomeCount={somatic_caller.estimate_chromosome_count(merged):.2f}")
    out = Path(ctx.output_dir) / f"{tumor.name}_CNV.vcf.gz"
    vcf_write.write_segments(
        out, [merged], [tumor.name], ctx.contigs,
        diploid_coverage=model.diploid_coverage, extra_headers=headers,
        reference_cn_fn=(lambda i, s: ploidy.reference_copy_number(
            s.chrom, s.begin, s.end)) if ploidy else None,
        quality_threshold=ctx.config.quality_filter_threshold,
        reference_path=str(ctx.genome_fasta))
    prof.write(Path(ctx.output_dir) / f"{tumor.name}_profile.json")
    return out


def _apply_common_cnvs(
    ctx: WorkflowContext,
    samples: list[Sample],
    parts: dict[str, dict[str, list]],
    common_cnvs_bed: str,
) -> dict[str, dict[str, list]]:
    """Common-CNV SetA/SetB alternative segmentation
    (CanvasPedigreeCaller.CreateSegmentSetsFromCommonCnvs :211-331)."""
    from canvas_tpu_torch.models import common_cnv as cc
    from canvas_tpu_torch.models import pedigree as ped
    from canvas_tpu_torch.tools.evaluate_cnv import load_exclude_bed

    intervals_by_contig = load_exclude_bed(common_cnvs_bed)
    names = [s.name for s in samples]
    # build regions per sample/contig
    regions_by_contig: dict[str, dict[str, list[cc.OverlappingRegion]]] = {}
    for contig, intervals in intervals_by_contig.items():
        per_sample = {}
        ok = True
        for name in names:
            segs = parts[name].get(contig)
            if not segs:
                ok = False
                break
            starts = np.concatenate([s.bin_starts for s in segs])
            ends = np.concatenate([s.bin_ends for s in segs])
            counts = np.concatenate([s.bin_counts for s in segs])
            common_segs = cc.common_segments_from_bed(
                intervals, contig, starts, ends, counts)
            per_sample[name] = cc.merge_common_cnv_segments(segs, common_segs)
        if not ok:
            continue
        n_regions = {len(v) for v in per_sample.values()}
        if len(n_regions) != 1:
            continue  # asymmetric merges; keep original segmentation
        regions_by_contig[contig] = per_sample
    if not regions_by_contig:
        return parts
    # per-sample stats/models for the set choice
    stats_by_sample = {
        n: ped.SampleStats.from_segments(_flatten(parts[n], ctx.contigs))
        for n in names}
    models = {
        n: ped.CopyNumberModel(ped.MAX_COPY_NUMBER,
                               stats_by_sample[n].max_coverage,
                               stats_by_sample[n].mean_coverage,
                               stats_by_sample[n].mean_maf_coverage)
        for n in names}
    out = {n: dict(parts[n]) for n in names}
    for contig, per_sample in regions_by_contig.items():
        cc.choose_best_sets(per_sample, stats_by_sample, models,
                            ped.MAX_COPY_NUMBER)
        for n in names:
            out[n][contig] = cc.resolve_regions(per_sample[n])
    return out


def small_pedigree_wgs(ctx: WorkflowContext, samples: list[Sample],
                       common_cnvs_bed: str | None = None) -> Path:
    """SmallPedigree-WGS: per-sample bin/clean -> multisample intersection ->
    PerSampleHMM (or the joint HMM) [-> common-CNV segment sets] -> joint
    pedigree caller -> multi-sample VCF."""
    cleaned: dict[str, BinSet] = {}
    ploidies: dict[str, PloidyInfo | None] = {}
    prof = profiling.reset(ctx.device)
    prof.gate = ctx.checkpointer.stage   # -c/-s start/stop-checkpoint
    with prof.stage("CanvasBin", samples=len(samples)):
        # shared multi-sample bin size: median rate over ALL samples so bin
        # boundaries align (CanvasBin.CalculateMultiSampleBinSize :842-865).
        # done() must be consulted INSIDE the stage: the stage gate flips
        # the -c start-checkpoint state, and deciding ingestion on the
        # pre-gate answer would re-bin without the shared size on
        # `-c CanvasBin` resumes.
        need_ingest = [
            s for s in samples
            if not ctx.checkpointer.done(f"CanvasBin_{s.name}.binned.gz")]
        # samples scan serially ON PURPOSE: the native scanner already
        # multithreads BGZF inflate across all cores, and measured
        # sample-concurrent scans are 2.9x SLOWER on a 2-vCPU host (pool
        # thrash; benchmarks/roofline_scanner.py documents the per-core
        # inflate roofline and the scanner's attainment)
        observed_by_sample = {s.name: ingest_observed(ctx, s)
                              for s in need_ingest}
        all_rates: list[float] = []
        for s in need_ingest:
            all_rates.extend(autosome_rates(ctx, observed_by_sample[s.name]))
        shared_bs = binning.bin_size_from_rates(
            ctx.config.counts_per_bin, all_rates) if all_rates else None
        bins_by_sample = {}
        for s in samples:
            bins_by_sample[s.name], _ = run_bin(
                ctx, s, bin_size=shared_bs,
                observed=observed_by_sample.get(s.name))
    with prof.stage("CanvasClean"):
        for s in samples:
            cleaned[s.name], _ = run_clean(ctx, s, bins_by_sample[s.name])
            ploidies[s.name] = load_ploidy_vcf(s.ploidy_vcf, s.name) \
                if s.ploidy_vcf else None
        # multi-sample bin intersection
        # (Utilities.MergeMultiSampleCleanedBedFile)
        cleaned = intersect_bins(cleaned)
    with prof.stage("CanvasPartition",
                    bins=sum(len(b) for b in cleaned.values())):
        parts = run_partition(ctx, cleaned,
                              ctx.config.partition_method or "PerSampleHMM",
                              is_germline=True)
        if common_cnvs_bed:
            parts = _apply_common_cnvs(ctx, samples, parts, common_cnvs_bed)
    segs_by_sample: dict[str, list] = {}
    with prof.stage("CanvasSNV"):
        for s in samples:
            by_contig = parts[s.name]
            vf = run_snv(ctx, s, is_somatic=False)
            attach_alleles(ctx, s, by_contig, vf)
            segs_by_sample[s.name] = _flatten(by_contig, ctx.contigs)
    types = {s.name: s.sample_type for s in samples}
    ploidy_fns = {n: p.segment_ploidy_fn() for n, p in ploidies.items() if p}
    with prof.stage("CanvasPedigreeCaller",
                    segments=sum(len(v) for v in segs_by_sample.values())):
        if ctx.config.pedigree_caller == "HaplotypeVariantCaller":
            pedigree_caller.call_pedigree_haplotype(
                segs_by_sample, types, ploidy_fns,
                ctx.config.quality_filter_threshold)
        else:
            pedigree_caller.call_pedigree(
                segs_by_sample, types, ploidy_fns,
                ctx.config.quality_filter_threshold, device=ctx.device)
        # pre-merge partition segments + sample mean coverage, needed for
        # the per-sample outputs below: the reference computes
        # SampleMetrics.MeanCoverage (median over all bin counts,
        # SampleMetrics.cs:42) and the partition bedgraph entries
        # (CanvasPedigreeCaller.cs:154-155) from the ORIGINAL partition
        # segments, not the merged callset
        partition_segs = {n: list(v) for n, v in segs_by_sample.items()}
        mean_cov_by_sample = {
            n: (float(seg_stats.median(np.concatenate(
                [s.bin_counts for s in v]))) if any(
                    len(s.bin_counts) for s in v) else None)
            for n, v in partition_segs.items()}
        # multisample merge: cross-sample CN vectors + mean q-scores
        # (CanvasPedigreeCaller.MergeSegments :179-205)
        segs_by_sample = merge_segments_multisample(
            segs_by_sample, pedigree_caller.MINIMUM_CALL_SIZE,
            ctx.config.quality_filter_threshold)
    for name, segs in segs_by_sample.items():
        set_filters(segs, ctx.config.quality_filter_threshold,
                    SEGMENT_SIZE_CUTOFF)
        for seg in segs:
            if seg.qscore < ctx.config.quality_filter_threshold and \
                    f"q{ctx.config.quality_filter_threshold}" not in seg.filter_tags:
                seg.filter_tags.append(f"q{ctx.config.quality_filter_threshold}")
    out = Path(ctx.output_dir) / "CNV.vcf.gz"
    names = [s.name for s in samples]
    vcf_write.write_segments(
        out, [segs_by_sample[n] for n in names], names, ctx.contigs,
        denovo_quality_threshold=ctx.config.denovo_quality_threshold,
        quality_threshold=ctx.config.quality_filter_threshold,
        reference_path=str(ctx.genome_fasta))
    # per-sample output surface: after the multi-sample VCF the reference
    # writes, for every pedigree member, a single-sample VCF plus the
    # coverage/copy-number/partition visualization tracks
    # (CanvasPedigreeCaller.cs:137-156; names per SingleSampleCallset.cs:
    # 85-93,105-123 — this repo uses its flat <sample>_CNV.* convention)
    from canvas_tpu_torch.io import visualization as viz

    for name in names:
        segs = segs_by_sample[name]
        ploidy = ploidies.get(name)
        mean_cov = mean_cov_by_sample.get(name)
        vcf_write.write_segments(
            Path(ctx.output_dir) / f"{name}_CNV.vcf.gz", [segs], [name],
            ctx.contigs, diploid_coverage=mean_cov,
            reference_cn_fn=(lambda i, s, _p=ploidy:
                             _p.reference_copy_number(s.chrom, s.begin,
                                                      s.end))
            if ploidy else None,
            quality_threshold=ctx.config.quality_filter_threshold,
            denovo_quality_threshold=ctx.config.denovo_quality_threshold,
            reference_path=str(ctx.genome_fasta))
        _write_visualization(ctx, name, segs, mean_cov, ploidy)
        try:
            factor = viz.compute_normalization_factor(segs)
            viz.write_partition_bedgraph(
                Path(ctx.output_dir) / f"{name}_CNV.Partition.bedgraph",
                partition_segs[name], factor)
        except Exception as e:      # noqa: BLE001 - debug output only
            import logging

            logging.getLogger(__name__).warning(
                "skipping partition bedgraph for %s: %s", name, e)
    prof.write(Path(ctx.output_dir) / "pedigree_profile.json")
    return out


def intersect_bins(samples_bins: dict[str, BinSet]) -> dict[str, BinSet]:
    """Multi-sample bin intersection on (contig, start, end) keys
    (Utilities.MergeMultiSampleCleanedBedFile: keep bins present in every
    sample, in the first sample's order)."""
    if len(samples_bins) <= 1:
        return samples_bins
    keysets = []
    for b in samples_bins.values():
        keysets.append(set(zip(b.contig_id.tolist(), b.start.tolist(),
                               b.end.tolist())))
    common = set.intersection(*keysets)
    out = {}
    for name, b in samples_bins.items():
        mask = np.fromiter(
            ((c, s, e) in common
             for c, s, e in zip(b.contig_id, b.start, b.end)),
            dtype=bool, count=len(b))
        out[name] = b.select(mask)
    return out
