"""Entry points for a one-card compile check and a multi-device dryrun.

    from canvas_tpu_torch import graft_entry
    fn, args = graft_entry.entry()          # segmentation_step on the card
    fn(*args)
    graft_entry.dryrun_multichip(4)         # the first 4 cards
    graft_entry.dryrun_multichip(4, devices=[torch.device("cuda", 0)] * 4)

The devices default to the visible CUDA devices and a missing card
raises; pass devices=[torch.device("cpu")] * n to run on the CPU.
"""

from __future__ import annotations

import gzip
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device

# the dryrun's trio: 4 contigs of 120 kbp at 0.25 read starts a position
# (12.5x of 50 bp reads), a CN 3 gain shared by father and proband and a
# CN 1 loss in the proband alone
TRIO_LEN = 120_000
TRIO_CONTIGS = ("chr1", "chr2", "chr3", "chr4")
TRIO_PLANS = {
    "father": {"chr1": [(30_000, 60_000, 3)]},
    "mother": {},
    "proband": {"chr1": [(30_000, 60_000, 3)],
                "chr2": [(20_000, 50_000, 1)]},
}
TRIO_TYPES = {"father": "Father", "mother": "Mother", "proband": "Proband"}


def _demo_segmentation_inputs(B=8, T=512, D=1, S=5, seed=0,
                              device="cuda"):
    """Coverage [B, T, D] with a halved stretch, its all-True mask, the NB
    log tables [S, D, V], log transitions and log initial probabilities,
    as tensors on `device`."""
    from canvas_tpu_torch.ops import hmm

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cov = np.abs(rng.normal(100.0, 12.0, size=(B, T, D))).astype(np.float32)
    cov[:, T // 4: T // 2] *= 0.5
    mask = np.ones((B, T), dtype=bool)
    tables, _, clamped = hmm.build_emission_tables(
        cov.reshape(-1, D), n_states=S)
    log_tables = np.where(tables > 0, np.log(np.maximum(tables, 1e-300)),
                          hmm.NEG_INF).astype(np.float32)
    log_trans = np.asarray(hmm.log_transition(S), np.float32)
    log_init = np.log(np.full(S, 1.0 / S, np.float32))
    return tuple(torch.as_tensor(x, device=dev) for x in (
        np.minimum(cov, clamped.max()), mask, log_tables, log_trans,
        log_init))


def entry(device="cuda"):
    """(fn, example_args): the segmentation forward step on `device` —
    emission lookup and the chunked Viterbi (kernels B2, K5, B3 and K6 on
    a CUDA device)."""
    from canvas_tpu_torch.pipeline.device_pipeline import segmentation_step

    args = _demo_segmentation_inputs(device=device)

    def fn(coverage, mask, log_tables, log_trans, log_init):
        return segmentation_step(coverage, mask, log_tables, log_trans,
                                 log_init, use_all_states=True, n_dim=1)

    return fn, args


def _synthetic_step_inputs(n_lanes: int, device: torch.device):
    """One lane of 4,096 positions a device: tracks from seed 0, offsets
    0, and NB log tables over 64 values."""
    from canvas_tpu_torch.ops import hmm

    L = 4096
    rng = np.random.default_rng(0)
    possible = rng.random((n_lanes, L)) < 0.8
    observed = rng.poisson(0.5, size=(n_lanes, L)).astype(np.float32)
    observed[~possible] = 0.0
    is_gc = rng.random((n_lanes, L)) < 0.41
    offsets = np.zeros(n_lanes, dtype=np.int32)
    S, V = 5, 64
    means = np.maximum(np.arange(S)[:, None], 0.1) * 50.0
    tables = hmm.negative_binomial_table(means, np.full((S, 1), 400.0), V)
    log_tables = np.where(tables > 0, np.log(np.maximum(tables, 1e-300)),
                          hmm.NEG_INF).astype(np.float32)
    log_trans = np.asarray(hmm.log_transition(S), np.float32)
    log_init = np.log(np.full(S, 1.0 / S, np.float32))
    return tuple(torch.as_tensor(x, device=device) for x in (
        possible, observed, is_gc, offsets, log_tables, log_trans,
        log_init))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run ONE full pipeline step (binning -> normalize -> Viterbi ->
    caller) on an n-device mesh, one contig lane a device, then the
    SmallPedigree-WGS workflow on the mesh and pinned to one device, whose
    VCFs must be equal.  `devices` defaults to the first n visible cards;
    fewer than n raises.  A failed check raises RuntimeError."""
    from canvas_tpu_torch.parallel.mesh import make_mesh
    from canvas_tpu_torch.pipeline.device_pipeline import full_pipeline_step

    mesh = make_mesh(n_devices, axes=("contig",), devices=devices)
    home = mesh.devices.flat[0]
    C, bin_size, max_bins = n_devices, 16, 4096 // 16
    possible, observed, is_gc, offsets, logt, lt, li = \
        _synthetic_step_inputs(C, home)
    states, called_cn, (_s, _e, _g, _c, valid) = full_pipeline_step(
        possible, observed, is_gc, offsets, bin_size, max_bins, logt, lt,
        li, mesh=mesh)
    n_valid = int(valid.sum())
    if states.shape != (C, max_bins) or called_cn.shape != (C, max_bins) \
            or n_valid == 0:
        raise RuntimeError(f"synthetic step: states {tuple(states.shape)}, "
                           f"called {tuple(called_cn.shape)}, {n_valid} "
                           f"valid bins")
    print(f"dryrun_multichip({n_devices}): synthetic step OK — states "
          f"{tuple(states.shape)}, caller CN assigned, {n_valid} bins "
          f"across {C} split lanes")
    _dryrun_real_workflow(mesh)


def write_demo_trio(base: Path) -> tuple[Path, dict[str, Path]]:
    """The dryrun's trio under `base`: a reference folder (genome.fa,
    kmer.fa) and one BAM a sample; returns (reference folder, name ->
    BAM)."""
    from canvas_tpu_torch.genome.reference import write_fasta
    from canvas_tpu_torch.io import bam as bamio
    from canvas_tpu_torch.tools.flag_unique_kmers import flag_unique_kmers

    L = TRIO_LEN

    def make_bam(path, seed, plan):
        positions = []
        for ci, contig in enumerate(TRIO_CONTIGS):
            cn = np.full(L, 2.0)
            for s, e, c in plan.get(contig, []):
                cn[s:e] = c
            rng = np.random.default_rng(seed + ci)
            n_reads = rng.poisson(0.25 * cn / 2.0)
            positions.append(np.repeat(np.arange(L), n_reads))
        _write_read_bam(path, [(c, L) for c in TRIO_CONTIGS], positions)

    ref = base / "ref"
    ref.mkdir(parents=True)
    rng = np.random.default_rng(42)
    write_fasta(ref / "genome.fa",
                {c: "".join(rng.choice(list("ACGT"), size=L))
                 for c in TRIO_CONTIGS})
    flag_unique_kmers(ref / "genome.fa", ref / "kmer.fa")
    bams = {}
    for name, plan in TRIO_PLANS.items():
        bams[name] = base / f"{name}.bam"
        make_bam(bams[name], 1000, plan)
    return ref, bams


def _write_read_bam(path: Path, refs: list[tuple[str, int]],
                    positions: list[np.ndarray]) -> None:
    """A BAM of 50M properly paired reads (MAPQ 50, all A, quality 30),
    named r<contig>_<k>, starting at `positions[contig]` (sorted): the
    bytes io.bam.write_bam writes for these records, without building
    one record object a read."""
    import struct

    from canvas_tpu_torch.io import bam as bamio

    body = bytearray(bamio.BAM_MAGIC)
    text = b"@HD\tVN:1.6\tSO:coordinate\n"
    body += struct.pack("<i", len(text)) + text
    body += struct.pack("<i", len(refs))
    for name, length in refs:
        nb = name.encode() + b"\x00"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    read_len = 50
    cigar = struct.pack("<I", (read_len << 4) | bamio.CIGAR_OPS.index("M"))
    code = bamio.SEQ_NT.index("A")
    seq = bytes([(code << 4) | code]) * (read_len // 2)
    tail = cigar + seq + bytes([30]) * read_len
    for ci, pos in enumerate(positions):
        for k, p in enumerate(pos.tolist()):
            name = f"r{ci}_{k}".encode() + b"\x00"
            payload = struct.pack(
                "<iiBBHHHiiii", ci, p, len(name), 50, 0, 1, 0x1 | 0x2,
                read_len, -1, -1, 0) + name + tail
            body += struct.pack("<i", len(payload)) + payload
    path.write_bytes(bamio.bgzf_compress(bytes(body)))


def vcf_body(vcf: bytes) -> bytes:
    """A VCF's decompressed bytes without its ##fileDate line."""
    return b"\n".join(ln for ln in vcf.split(b"\n")
                      if not ln.startswith(b"##fileDate"))


def _dryrun_real_workflow(mesh) -> None:
    """Run the SmallPedigree-WGS workflow (tiny synthetic trio) on the
    mesh, then again pinned to its first device
    (CANVAS_TPU_FORCE_SINGLE_DEVICE=1), and require equal multi-sample
    VCFs: splitting over devices must not change any call."""
    from canvas_tpu_torch.pipeline import runner

    n = mesh.size
    with tempfile.TemporaryDirectory() as td:
        base = Path(td)
        ref, bams = write_demo_trio(base)
        samples = [runner.Sample(name, str(bam),
                                 sample_type=TRIO_TYPES[name])
                   for name, bam in bams.items()]

        def run(tag):
            ctx = runner.WorkflowContext(
                reference_folder=str(ref), output_dir=str(base / tag),
                device=mesh.devices.flat[0], devices=mesh)
            return gzip.open(runner.small_pedigree_wgs(ctx, samples)).read()

        split = run("out_split")
        before = os.environ.get("CANVAS_TPU_FORCE_SINGLE_DEVICE")
        os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = "1"
        try:
            single = run("out_single")
        finally:
            if before is None:
                del os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"]
            else:
                os.environ["CANVAS_TPU_FORCE_SINGLE_DEVICE"] = before
        if vcf_body(split) != vcf_body(single):
            raise RuntimeError("the VCF split over the mesh differs from "
                               "the single-device VCF")
        n_records = sum(1 for ln in split.split(b"\n")
                        if ln and not ln.startswith(b"#"))
        print(f"dryrun_multichip({n}): SmallPedigree-WGS workflow OK — "
              f"{n_records} VCF records, split == single-device")
