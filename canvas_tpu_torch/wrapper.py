"""Embedding API: run canvas_tpu_torch as a checkpointed step of a pipeline.

The reference ships `Canvas.Wrapper` so Illumina ISAS workflows can embed
Canvas as one checkpointed stage: a per-workflow `ICanvasCnvCaller<TIn,TOut>`
(`Canvas.Wrapper/ICanvasCnvCaller.cs:6-10`), a `CanvasOutput` whose files are
located/moved by filename-stub conventions (`CanvasOutput.cs:32-62`), and a
`CanvasCheckpoint` that loads the outputs from the convention instead of
re-running when they already exist (`CanvasCheckpoint.cs:35-49,80-93`), gated
on the annotation files being available for the genome
(`CanvasAnnotationFileProvider`).

This module is the same contract for canvas_tpu_torch: typed per-workflow
inputs, callers that run the in-process workflows into a sandbox directory
on their `device` (default "cuda", which raises where there is no CUDA
device), stub naming conventions for the outputs, and a load-or-run
checkpoint wrapper.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Protocol

from canvas_tpu_torch.config import CanvasConfig
from canvas_tpu_torch.pipeline import runner

MoveFn = Callable[[Path, Path], None]


def _default_move(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(src), str(dst))


@dataclass
class CanvasOutput:
    """Output-file bundle located by a filename stub (CanvasOutput.cs:32-43:
    stub -> stub.vcf.gz / .CoverageAndVariantFrequency.txt / .VFResults.txt.gz
    / .VFResults.baf / .partitioned)."""

    cnv_vcf: Path
    coverage_and_variant_frequencies: Path
    variant_frequencies: Path | None = None
    variant_frequencies_baf: Path | None = None
    partitioned: Path | None = None

    @classmethod
    def from_stub(cls, stub: Path) -> "CanvasOutput":
        stub = Path(stub)
        return cls(
            cnv_vcf=stub.with_name(stub.name + ".vcf.gz"),
            coverage_and_variant_frequencies=stub.with_name(
                stub.name + ".CoverageAndVariantFrequency.txt"),
            variant_frequencies=stub.with_name(stub.name + ".VFResults.txt.gz"),
            variant_frequencies_baf=stub.with_name(stub.name + ".VFResults.baf"),
            partitioned=stub.with_name(stub.name + ".partitioned"),
        )

    def exists(self) -> bool:
        """Loadable iff the required members exist (optional ones may be
        absent, as in the reference where they default to null)."""
        return (self.cnv_vcf.exists()
                and self.coverage_and_variant_frequencies.exists())

    def move(self, stub: Path, move: MoveFn = _default_move) -> "CanvasOutput":
        """Relocate every present member to the destination convention
        (CanvasOutput.Move, CanvasOutput.cs:54-62)."""
        dest = CanvasOutput.from_stub(stub)
        move(self.cnv_vcf, dest.cnv_vcf)
        move(self.coverage_and_variant_frequencies,
             dest.coverage_and_variant_frequencies)
        for src, dst in ((self.variant_frequencies, dest.variant_frequencies),
                         (self.variant_frequencies_baf,
                          dest.variant_frequencies_baf),
                         (self.partitioned, dest.partitioned)):
            if src is not None and src.exists():
                move(src, dst)
        return dest


class AnnotationFileProvider:
    """Genome-support gate (CanvasAnnotationFileProvider.IsSupported): the
    reference folder must carry the kmer-uniqueness FASTA."""

    def __init__(self, reference_folder: str | Path):
        self.reference_folder = Path(reference_folder)

    def is_supported(self) -> bool:
        return (self.reference_folder / "kmer.fa").exists()


# ---------------------------------------------------------------------------
# Per-workflow inputs (Canvas.Wrapper/Canvas*Input.cs)
# ---------------------------------------------------------------------------

@dataclass
class GermlineWgsInput:
    bam: str
    b_allele_vcf: str | None = None
    is_dbsnp_vcf: bool = False
    ploidy_vcf: str | None = None


@dataclass
class TumorNormalWgsInput:
    tumor_bam: str
    normal_bam: str | None = None
    b_allele_vcf: str | None = None
    is_dbsnp_vcf: bool = False
    somatic_vcf: str | None = None
    ploidy_vcf: str | None = None


@dataclass
class EnrichmentInput:
    """Somatic-Enrichment (CanvasEnrichmentInput.cs): targeted panel."""

    bam: str
    manifest: str
    normal_bam: str | None = None
    b_allele_vcf: str | None = None
    is_dbsnp_vcf: bool = False
    ploidy_vcf: str | None = None


@dataclass
class SmallPedigreeInput:
    bams: list[str]
    sample_types: list[str]                       # Father/Mother/Proband/...
    b_allele_vcfs: list[str | None] | None = None
    common_cnvs_bed: str | None = None


class CanvasCnvCaller(Protocol):
    """ICanvasCnvCaller.Run(inputs, sandbox) (ICanvasCnvCaller.cs:6-10)."""

    def run(self, inputs: dict[str, object],
            sandbox: Path) -> dict[str, CanvasOutput]: ...


@dataclass
class _CallerBase:
    reference_folder: str
    config: CanvasConfig = field(default_factory=CanvasConfig)
    filter_bed: str | None = None
    device: str = "cuda"

    def _ctx(self, sandbox: Path) -> runner.WorkflowContext:
        if not AnnotationFileProvider(self.reference_folder).is_supported():
            raise FileNotFoundError(
                f"no kmer.fa under {self.reference_folder} — genome not "
                "supported (CanvasAnnotationFileProvider contract)")
        return runner.WorkflowContext(
            reference_folder=self.reference_folder, output_dir=str(sandbox),
            config=self.config, filter_bed=self.filter_bed,
            device=self.device)

    def _collect(self, ctx: runner.WorkflowContext, sandbox: Path,
                 name: str, vcf: Path) -> CanvasOutput:
        ckpt = ctx.checkpointer
        vf = ckpt.path(f"VFResults_{name}.txt.gz")
        baf = ckpt.path(f"VFResults_{name}.baf")
        return CanvasOutput(
            cnv_vcf=vcf,
            coverage_and_variant_frequencies=(
                sandbox / f"{name}_CNV.CoverageAndVariantFrequency.txt"),
            variant_frequencies=vf if vf.exists() else None,
            variant_frequencies_baf=baf if baf.exists() else None,
        )


class GermlineWgsCnvCaller(_CallerBase):
    def run(self, inputs: dict[str, GermlineWgsInput],
            sandbox: Path) -> dict[str, CanvasOutput]:
        out: dict[str, CanvasOutput] = {}
        for name, inp in inputs.items():
            ctx = self._ctx(Path(sandbox) / name)
            sample = runner.Sample(name, inp.bam, normal_vcf=inp.b_allele_vcf,
                                   ploidy_vcf=inp.ploidy_vcf,
                                   is_dbsnp_vcf=inp.is_dbsnp_vcf)
            vcf = runner.germline_wgs(ctx, sample)
            out[name] = self._collect(ctx, Path(sandbox) / name, name, vcf)
        return out


class TumorNormalWgsCnvCaller(_CallerBase):
    """CanvasTumorNormalWgsCnvCaller analogue."""

    def run(self, inputs: dict[str, TumorNormalWgsInput],
            sandbox: Path) -> dict[str, CanvasOutput]:
        out: dict[str, CanvasOutput] = {}
        for name, inp in inputs.items():
            ctx = self._ctx(Path(sandbox) / name)
            tumor = runner.Sample(name, inp.tumor_bam,
                                  normal_vcf=inp.b_allele_vcf,
                                  ploidy_vcf=inp.ploidy_vcf,
                                  is_dbsnp_vcf=inp.is_dbsnp_vcf)
            normal = (runner.Sample(f"{name}_normal", inp.normal_bam)
                      if inp.normal_bam else None)
            vcf = runner.somatic_wgs(ctx, tumor, normal=normal,
                                     somatic_vcf=inp.somatic_vcf)
            out[name] = self._collect(ctx, Path(sandbox) / name, name, vcf)
        return out


class EnrichmentCnvCaller(_CallerBase):
    """CanvasEnrichmentCnvCaller / CanvasTumorNormalEnrichmentCnvCaller
    analogue (manifest-driven predefined bins)."""

    def run(self, inputs: dict[str, EnrichmentInput],
            sandbox: Path) -> dict[str, CanvasOutput]:
        out: dict[str, CanvasOutput] = {}
        for name, inp in inputs.items():
            ctx = self._ctx(Path(sandbox) / name)
            tumor = runner.Sample(name, inp.bam, normal_vcf=inp.b_allele_vcf,
                                  ploidy_vcf=inp.ploidy_vcf,
                                  is_dbsnp_vcf=inp.is_dbsnp_vcf)
            normal = (runner.Sample(f"{name}_normal", inp.normal_bam)
                      if inp.normal_bam else None)
            vcf = runner.somatic_wgs(ctx, tumor, normal=normal,
                                     manifest_path=inp.manifest)
            out[name] = self._collect(ctx, Path(sandbox) / name, name, vcf)
        return out


class SmallPedigreeCnvCaller(_CallerBase):
    def run(self, inputs: dict[str, SmallPedigreeInput],
            sandbox: Path) -> dict[str, CanvasOutput]:
        out: dict[str, CanvasOutput] = {}
        for name, inp in inputs.items():
            ctx = self._ctx(Path(sandbox) / name)
            vcfs = inp.b_allele_vcfs or [None] * len(inp.bams)
            samples = [
                runner.Sample(f"{name}_{t}", bam, sample_type=t, normal_vcf=v)
                for bam, t, v in zip(inp.bams, inp.sample_types, vcfs)]
            vcf = runner.small_pedigree_wgs(
                ctx, samples, common_cnvs_bed=inp.common_cnvs_bed)
            out[name] = CanvasOutput(
                cnv_vcf=vcf,
                coverage_and_variant_frequencies=(
                    Path(sandbox) / name /
                    f"{samples[-1].name}_CNV.CoverageAndVariantFrequency.txt"))
        return out


@dataclass
class CanvasCheckpoint:
    """Load-or-run wrapper (CanvasCheckpoint.cs:35-49 + the loading
    convention's Load/Move, :80-93): outputs already present at the stub
    convention are loaded without running; otherwise the caller runs in the
    sandbox and its outputs are moved to the convention."""

    caller: CanvasCnvCaller
    stub_fn: Callable[[str], Path]        # SampleStubNamingConvention
    step_name: str = "Detect CNV"

    def run(self, inputs: dict[str, object], sandbox: str | Path,
            move: MoveFn = _default_move) -> dict[str, CanvasOutput]:
        loaded: dict[str, CanvasOutput] = {}
        pending: dict[str, object] = {}
        for name, inp in inputs.items():
            existing = CanvasOutput.from_stub(self.stub_fn(name))
            if existing.exists():
                loaded[name] = existing
            else:
                pending[name] = inp
        if pending:
            produced = self.caller.run(pending, Path(sandbox))
            for name, output in produced.items():
                loaded[name] = output.move(self.stub_fn(name), move)
        return loaded
