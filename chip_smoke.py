#!/usr/bin/env python3
"""Smoke run of canvas_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:

  1. build   nvcc-builds the kernels from csrc/ and prints the build time
             and the card's name and power limit;
  2. B1      the prefix-scan kernel at chr1 length (248,956,422 positions,
             tracks made by numpy from --seed) against its plain torch
             version on the card: int32 equality, both times;
  3. B2/B3   the chunked-Viterbi kernels at the production decode shape
             (24 contigs padded to 32 lanes x 524,288 bins x 5 states,
             chunk 256, NB emissions, ragged prefix masks) against their
             plain versions on the card: exact equality, both times;
  4. e2e     SmallPedigree-WGS through the CLI entry point on a synthetic
             trio (4 contigs, 20 Mbp, 12.5x) with --device cuda and again
             with --device cpu: identical VCFs, the planted shared gain and
             de novo loss called, and every kernel launched by the CUDA run;
  5. B4      the CBS arc-scan kernel at two synthetic frontier shapes
             (8 x 32,768: eight segments of 19,661-32,768 bins, as the top
             level of 20,000-target contigs would bucket them; 64 x 4,096:
             a deep level; cumsums of noise with planted steps from --seed)
             against its plain torch version on the card: best bit for
             bit, bl0 and the derived t2/ti/tj equal, both times;
  6. e2e-enrichment
             the host CBS stopping boundary that every CBS run of a process
             needs first (timed, then cached), then Tumor-normal-enrichment
             through the CLI entry point on a synthetic panel (3 contigs,
             30 Mbp, 400 bp targets every 500 bp, CN 1/3/0/4 events of
             0.8-1.6 Mb on a diploid normal) with --device cuda (frontier
             CBS engine, kernel B4) and again with --device cpu (host CBS
             engine): identical VCFs, every planted event called with its
             copy number, the stage times of both runs;
  7. CBS     the frontier engine on the tumor's ratio coverage of that
             panel, on CUDA tensors (B4) and on CPU tensors (plain B4):
             equal segments and the per-level profile; then one more CUDA
             run under torch.profiler: device busy time and kernel launches.

It then prints the card's name and power limit, one JSON line with the
kernels' results, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

CHR1_LEN = 248_956_422
# hg38 chromosome lengths (chr1..chr22, chrX, chrY), the production decode's
# contigs at 500 bp bins
HG38 = [248_956_422, 242_193_529, 198_295_559, 190_214_555, 181_538_259,
        170_805_979, 159_345_973, 145_138_636, 138_394_717, 133_797_422,
        135_086_622, 133_275_309, 114_364_328, 107_043_718, 101_991_189,
        90_338_345, 83_257_441, 80_373_285, 58_617_616, 64_444_167,
        46_709_983, 50_818_468, 156_040_895, 57_227_415]
DECODE_BIN = 500
CHUNK = 256

TRIO_CONTIGS = {f"chr{i}": 5_000_000 for i in range(1, 5)}
TRIO_RATE = 0.25            # read starts per position: 12.5x of 50 bp reads
GAIN = ("chr1", 1_000_000, 1_600_000)      # father + proband, CN 3
LOSS = ("chr2", 2_000_000, 2_500_000)      # proband only (de novo), CN 1
PLANS = {
    "father": {GAIN[0]: [(GAIN[1], GAIN[2], 3.0)]},
    "mother": {},
    "proband": {GAIN[0]: [(GAIN[1], GAIN[2], 3.0)],
                LOSS[0]: [(LOSS[1], LOSS[2], 1.0)]},
}
TYPES = {"father": "Father", "mother": "Mother", "proband": "Proband"}

KERNEL_SOURCES = ("prefix_scan", "viterbi", "arc_scan")

# B4 at two frontier shapes: (segments, padded length)
B4_SHAPES = ((8, 32_768), (64, 4_096))

# the Tumor-normal-enrichment panel, after benchmarks/e2e_enrichment.py
ENR_CONTIGS = {f"chr{i}": 10_000_000 for i in range(1, 4)}
ENR_RATE = 0.3               # read starts per position, diploid
TARGET_LEN, TARGET_SPACING = 400, 500
EVENT_KINDS = [(1, 0), (3, 1), (0, 0), (4, 1)]   # (total CN, B alleles)
MARGIN_BP, GAP_BP = 500_000, 1_200_000
SIZE_RANGE = (800_000, 1_600_000)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase_build() -> dict:
    from canvas_tpu_torch import native
    from canvas_tpu_torch.ops import cuda_lib

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    for name in KERNEL_SOURCES:
        out = cuda_lib.BUILD_DIR / f"lib{name}.so"
        if out.exists():
            out.unlink()              # always build from the checkout
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(cuda_lib.build, KERNEL_SOURCES))
    secs = time.perf_counter() - t0
    # the host BAM scanner (g++), so that neither timed run builds it
    t0 = time.perf_counter()
    if not native.available():
        fail("the native BAM scanner did not build")
    return {"phase": "build", "seconds": secs,
            "native_seconds": time.perf_counter() - t0, "gpu": gpu_line()}


def phase_b1(seed: int, dev: torch.device) -> dict:
    from canvas_tpu_torch.ops import prefix_cuda as pc

    rng = np.random.default_rng(seed)
    L = CHR1_LEN
    Lp = L + (-L) % pc.TILE
    offset = 10_000                            # leading 'n' run
    p_bits = rng.integers(0, 256, Lp // 8, dtype=np.uint8)
    gc_bits = rng.integers(0, 256, Lp // 8, dtype=np.uint8)
    obs = rng.integers(0, 16, Lp, dtype=np.uint8)
    obs[L:] = 0
    p_t = torch.as_tensor(p_bits).to(dev)
    g_t = torch.as_tensor(gc_bits).to(dev)
    o_t = torch.as_tensor(obs).to(dev)
    cap = 10

    got = pc.fused_prefix_sums(p_t, o_t, g_t, offset, L, cap)
    torch.cuda.synchronize()
    want = pc.fused_prefix_sums_plain(p_t, o_t, g_t, offset, L, cap)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    if err:
        fail(f"B1 differs from its plain version (max |diff| {err})")
    del got, want
    ms = cuda_ms(lambda: pc.fused_prefix_sums(p_t, o_t, g_t, offset, L, cap),
                 reps=20)
    plain_ms = cuda_ms(
        lambda: pc.fused_prefix_sums_plain(p_t, o_t, g_t, offset, L, cap),
        reps=3)
    torch.cuda.empty_cache()
    return {"phase": "B1", "positions": L, "padded": Lp, "equal": True,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "write_GBps": 12 * Lp / (ms * 1e-3) / 1e9}


def decode_inputs(seed: int, dev: torch.device):
    """24 hg38-sized contigs of Poisson(100) coverage at 500 bp bins with
    planted CN 1 and CN 3 segments, through the port's PerSampleHMM
    emission construction."""
    from canvas_tpu_torch.ops import hmm

    rng = np.random.default_rng(seed + 1)
    cov = {}
    for i, length in enumerate(HG38):
        n = -(-length // DECODE_BIN)
        c = rng.poisson(100.0, n).astype(np.float64)
        for s in rng.integers(0, n - 2000, 3):
            cn = rng.choice([1, 3])
            c[s:s + 1000] = rng.poisson(50.0 * cn, 1000)
        cov[f"chr{i + 1}"] = c
    live, lengths, log_em, mask, lt, li = hmm.batched_emissions(
        cov, device=dev)
    return log_em, mask, lt, li


def phase_b2_b3(seed: int, dev: torch.device) -> tuple[dict, dict]:
    from canvas_tpu_torch.ops import hmm
    from canvas_tpu_torch.ops import viterbi_cuda as vc

    log_em, mask, lt, li = decode_inputs(seed, dev)
    B, T, S = log_em.shape
    if (B, T, S) != (32, 524_288, 5):
        fail(f"decode shape {(B, T, S)} is not the production shape")
    nC = T // CHUNK
    L = B * nC
    em = log_em.reshape(B, nC, CHUNK, S).permute(2, 3, 0, 1) \
        .reshape(CHUNK, S, L).contiguous()
    lengths = mask.sum(dim=1).to(torch.int32)
    base = (torch.arange(nC, device=dev, dtype=torch.int32) * CHUNK).repeat(B)
    lane_len = lengths.repeat_interleave(nC)

    # B2 against its plain version
    m_k = vc.chunk_matrices(em, base, lane_len, lt, li)
    torch.cuda.synchronize()
    m_p = vc.chunk_matrices_plain(em, base, lane_len, lt, li)
    b2_err = float((m_k - m_p).abs().max())
    if not torch.equal(m_k, m_p):
        fail(f"B2 differs from its plain version (max |diff| {b2_err})")
    # B3 against its plain version, from the same chunk-start scores
    ss = torch.randn((S, L), generator=torch.Generator(dev).manual_seed(seed),
                     device=dev) * 1000.0
    p_k, e_k = vc.forward_backtrack(em, base, lane_len, ss, lt, li)
    torch.cuda.synchronize()
    p_p, e_p = vc.forward_backtrack_plain(em, base, lane_len, ss, lt, li)
    b3_err = int(max((p_k.to(torch.int32) - p_p.to(torch.int32)).abs().max(),
                     (e_k.to(torch.int32) - e_p.to(torch.int32)).abs().max()))
    if b3_err:
        fail(f"B3 differs from its plain version (max |diff| {b3_err})")
    # the whole decode, kernels against plain versions
    path_k = hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK)
    torch.cuda.synchronize()
    path_p = hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                        plain=True)
    if not torch.equal(path_k, path_p):
        n = int((path_k != path_p).sum())
        fail(f"decoded paths differ from the plain decode at {n} bins")
    called = int(((path_k != 2) & mask).sum())

    b2_ms = cuda_ms(lambda: vc.chunk_matrices(em, base, lane_len, lt, li), 10)
    b2_plain = cuda_ms(
        lambda: vc.chunk_matrices_plain(em, base, lane_len, lt, li), 2)
    b3_ms = cuda_ms(
        lambda: vc.forward_backtrack(em, base, lane_len, ss, lt, li), 10)
    b3_plain = cuda_ms(
        lambda: vc.forward_backtrack_plain(em, base, lane_len, ss, lt, li), 2)
    dec_ms = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK),
        3)
    dec_plain = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                           plain=True), 1)
    shape = [B, T, S]
    b2 = {"phase": "B2", "shape": shape, "chunk": CHUNK, "lanes": L,
          "equal": True, "max_abs_err": b2_err, "ms": b2_ms,
          "plain_ms": b2_plain}
    b3 = {"phase": "B3", "shape": shape, "chunk": CHUNK, "lanes": L,
          "equal": True, "max_abs_err": b3_err, "ms": b3_ms,
          "plain_ms": b3_plain, "decode_ms": dec_ms,
          "decode_plain_ms": dec_plain, "non_diploid_bins": called}
    return b2, b3


def make_trio(base: Path, seed: int) -> dict[str, Path]:
    sys.path.insert(0, str(REPO))
    from benchmarks._synth import write_sample_bam
    from canvas_tpu_torch.genome.reference import (load_reference_tracks,
                                                   write_fasta)
    from canvas_tpu_torch.tools.flag_unique_kmers import flag_unique_kmers

    ref = base / "ref"
    ref.mkdir(parents=True)
    rng = np.random.default_rng(seed + 2)
    seqs = {name: bytes(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n, dtype=np.uint8)])
        for name, n in TRIO_CONTIGS.items()}
    write_fasta(ref / "genome.fa", seqs)
    flag_unique_kmers(ref / "genome.fa", ref / "kmer.fa")
    load_reference_tracks(ref / "kmer.fa")    # writes the track sidecar
    bams = {}
    for i, (name, plan) in enumerate(PLANS.items()):
        bams[name] = base / f"{name}.bam"
        write_sample_bam(bams[name], TRIO_CONTIGS, TRIO_RATE, plan,
                         seed=seed + 10 + i)
    return bams


def vcf_records(path: Path) -> tuple[list[str], list[list[str]]]:
    lines = gzip.open(path, "rt").read().splitlines()
    header = [ln for ln in lines if ln.startswith("#CHROM")][0].split("\t")
    return header[9:], [ln.split("\t") for ln in lines
                        if ln and not ln.startswith("#")]


def check_calls(vcf: Path) -> dict:
    """The planted events in the multi-sample VCF: the shared gain in father
    and proband (CN 3), the de novo loss in the proband only (CN 1, with a
    de novo quality), nothing but CN 2 over either event in the mother."""
    samples, recs = vcf_records(vcf)

    def calls(sample, event, cn):
        chrom, s, e = event
        hits = []
        for r in recs:
            end = int(dict(kv.split("=", 1) for kv in r[7].split(";")
                           if "=" in kv)["END"])
            if r[0] != chrom or int(r[1]) >= e or end <= s:
                continue
            f = dict(zip(r[8].split(":"), r[9 + samples.index(sample)]
                         .split(":")))
            if f.get("CN") == str(cn):
                hits.append((int(r[1]), end, f.get("DQ", ".")))
        return hits

    got = {"father_gain": calls("father", GAIN, 3),
           "proband_gain": calls("proband", GAIN, 3),
           "proband_loss": calls("proband", LOSS, 1),
           "mother_gain": calls("mother", GAIN, 3),
           "mother_loss": calls("mother", LOSS, 1)}
    if not (got["father_gain"] and got["proband_gain"]
            and got["proband_loss"]):
        fail(f"planted events not called: {got}")
    if got["mother_gain"] or got["mother_loss"]:
        fail(f"mother carries a planted event: {got}")
    if not any(dq != "." for _, _, dq in got["proband_loss"]):
        fail(f"de novo loss has no DQ: {got['proband_loss']}")
    return got


def vcf_body(path: Path) -> list[str]:
    return [ln for ln in gzip.open(path, "rt").read().splitlines()
            if not ln.startswith("##fileDate")]


def all_launch_counts() -> list[dict]:
    from canvas_tpu_torch.ops import arc_scan_cuda, prefix_cuda, viterbi_cuda

    return [prefix_cuda.LAUNCHES, viterbi_cuda.LAUNCHES,
            arc_scan_cuda.LAUNCHES]


def reset_launches() -> None:
    for counts in all_launch_counts():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    out = {}
    for counts in all_launch_counts():
        out.update(counts)
    return out


def phase_e2e(seed: int, workdir: Path) -> dict:
    from canvas_tpu_torch.pipeline import cli

    t0 = time.perf_counter()
    bams = make_trio(workdir, seed)
    gen_s = time.perf_counter() - t0
    args = ["SmallPedigree-WGS", "--bams", *[str(b) for b in bams.values()],
            "--names", *bams, "--types", *[TYPES[n] for n in bams],
            "-r", str(workdir / "ref")]
    runs = {}
    for dev in ("cuda", "cpu"):
        out = workdir / f"out_{dev}"
        if dev == "cuda":
            reset_launches()
        t0 = time.perf_counter()
        rc = cli.main([*args, "-o", str(out), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI run on {dev} exited {rc}")
        prof = json.loads((out / "pedigree_profile.json").read_text())
        runs[dev] = {"wall_s": wall,
                     "stages": {s["name"]: s["seconds"]
                                for s in prof["stages"]}}
    n_contigs, n_samples = len(TRIO_CONTIGS), len(PLANS)
    need = {"prefix_scan": n_contigs * n_samples,
            "chunk_matrix": n_samples, "forward_backtrack": n_samples}
    short = {k: (launches[k], v) for k, v in need.items() if launches[k] < v}
    if short:
        fail(f"kernels launched fewer times than the path needs: {short}")
    for vcf in ["CNV.vcf.gz", *[f"{n}_CNV.vcf.gz" for n in PLANS]]:
        if vcf_body(workdir / "out_cuda" / vcf) != \
                vcf_body(workdir / "out_cpu" / vcf):
            fail(f"{vcf} differs between --device cuda and --device cpu")
    calls = check_calls(workdir / "out_cuda" / "CNV.vcf.gz")
    return {"phase": "e2e", "genome_bp": sum(TRIO_CONTIGS.values()),
            "contigs": n_contigs, "samples": n_samples,
            "depth_x": TRIO_RATE * 50, "generate_s": gen_s,
            "vcf_cuda_equals_cpu": True, "launches": launches,
            "calls": calls, "cuda": runs["cuda"], "cpu": runs["cpu"]}


def b4_inputs(seed: int, B: int, npad: int, dev: torch.device):
    """Cumsums f32 [B, npad] of centred unit noise with two planted steps
    (0.3-1.0 sd, 2-10 % of the segment each) per row, lengths in
    (0.6 npad, npad], and their sums of squares, made by numpy."""
    rng = np.random.default_rng(seed + 3)
    cs = np.zeros((B, npad), np.float32)
    n = np.zeros(B, np.int32)
    tss = np.zeros(B, np.float32)
    for i in range(B):
        L = int(rng.integers(int(0.6 * npad) + 1, npad + 1))
        r = rng.normal(0.0, 1.0, L)
        for _ in range(2):
            w = int(rng.uniform(0.02, 0.10) * L)
            s0 = int(rng.integers(0, L - w))
            r[s0:s0 + w] += rng.choice([-1, 1]) * rng.uniform(0.3, 1.0)
        r -= r.mean()
        cs[i, :L] = np.cumsum(r)
        n[i] = L
        tss[i] = np.sum(r * r)
    return (torch.as_tensor(cs, device=dev), torch.as_tensor(n, device=dev),
            torch.as_tensor(tss, device=dev))


def phase_b4(seed: int, dev: torch.device) -> dict:
    """B4 at the frontier shapes, against its plain version on the card."""
    from canvas_tpu_torch.ops import arc_scan_cuda as ac
    from canvas_tpu_torch.ops import cbs_device as cd

    al0 = 2
    shapes = []
    for B, npad in B4_SHAPES:
        cs, n, tss = b4_inputs(seed + npad, B, npad, dev)
        blk = ac.geometry(npad)[0]
        seed_v, lag_hi, psd2, _ti0, _tj0 = cd.arc_scan_inputs(cs, n, npad,
                                                               al0)
        args = (cs, n, lag_hi, seed_v, psd2, al0)
        best_k, bl0_k = ac.arc_scan(*args)
        torch.cuda.synchronize()
        best_p, bl0_p = ac.arc_scan_plain(*args)
        torch.cuda.synchronize()
        bits_equal = torch.equal(best_k.view(torch.int32),
                                 best_p.view(torch.int32))
        err = float((best_k - best_p).abs().max())
        if not bits_equal or not torch.equal(bl0_k, bl0_p):
            fail(f"B4 differs from its plain version at {B} x {npad}: "
                 f"max |best diff| {err}, bl0 {bl0_k.tolist()} vs "
                 f"{bl0_p.tolist()}")
        # t2/ti/tj through tmax_batch: kernel on the card, plain on the CPU
        t_k = cd.tmax_batch(cs, n, tss, npad, al0)
        t_p = cd.tmax_batch(cs.cpu(), n.cpu(), tss.cpu(), npad, al0)
        for name, a, b in zip(("t2", "ti", "tj"), t_k, t_p):
            if not torch.equal(a.cpu(), b):
                fail(f"tmax_batch {name} differs between B4 and its plain "
                     f"version at {B} x {npad}")
        nblk = psd2.shape[1]
        # blocks phase 1 computes: those the bound admits against the seed
        admitted = 0
        for k in range(nblk):
            in_range, gate = ac._block_gate(k, blk, n, lag_hi, psd2, al0)
            admitted += int((in_range & (gate > seed_v)).sum())
        ms = cuda_ms(lambda: ac.arc_scan(*args), reps=20)
        plain_ms = cuda_ms(lambda: ac.arc_scan_plain(*args), reps=2)
        tmax_ms = cuda_ms(lambda: cd.tmax_batch(cs, n, tss, npad, al0),
                          reps=10)
        shapes.append({
            "segments": B, "npad": npad, "blocks": nblk * B,
            "blocks_admitted": admitted, "hits": int((bl0_k >= 0).sum()),
            "equal": True, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "tmax_batch_ms": tmax_ms,
            "pairs_dense": int(B * npad * (npad - 1) // 2)})
    torch.cuda.empty_cache()
    return {"phase": "B4", "shapes": shapes}


def plan_events(contigs: dict[str, int], seed: int) -> dict[str, list]:
    """CN events cycled over EVENT_KINDS along each contig, as
    benchmarks/e2e_enrichment.py plans them: (start, end, cn, b)."""
    rng = np.random.default_rng(seed)
    plan, kind_i = {}, 0
    for name, length in contigs.items():
        plan[name] = []
        pos = MARGIN_BP
        while pos + SIZE_RANGE[1] + MARGIN_BP < length:
            size = int(rng.integers(*SIZE_RANGE))
            cn, b = EVENT_KINDS[kind_i % len(EVENT_KINDS)]
            kind_i += 1
            plan[name].append((pos, pos + size, cn, b))
            pos += size + GAP_BP + int(rng.integers(0, GAP_BP))
    return plan


def make_panel(base: Path, seed: int, contigs: dict[str, int]) -> dict:
    """Reference, target BED, het-site VCF, diploid normal BAM and tumor BAM
    with planted events (pure tumor: VAF b/cn at het sites)."""
    sys.path.insert(0, str(REPO))
    from benchmarks._synth import (assign_alt_reads, make_het_vcf,
                                   synth_positions, write_bam_vectorized)
    from canvas_tpu_torch.genome.reference import (load_reference_tracks,
                                                   write_fasta)
    from canvas_tpu_torch.tools.flag_unique_kmers import flag_unique_kmers

    ref = base / "ref"
    ref.mkdir(parents=True)
    rng = np.random.default_rng(seed + 20)
    seqs = {name: bytes(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n, dtype=np.uint8)])
        for name, n in contigs.items()}
    write_fasta(ref / "genome.fa", seqs)
    flag_unique_kmers(ref / "genome.fa", ref / "kmer.fa")
    load_reference_tracks(ref / "kmer.fa")    # writes the track sidecar
    bed = base / "targets.bed"
    with open(bed, "w") as f:
        for name, length in contigs.items():
            for s0 in range(1_000, length - TARGET_LEN - 1_000,
                            TARGET_SPACING):
                f.write(f"{name}\t{s0}\t{s0 + TARGET_LEN}\ttarget\n")
    het = base / "het.vcf"
    sites = make_het_vcf(het, contigs)
    plan = plan_events(contigs, seed + 31)
    rng = np.random.default_rng(seed + 9)
    refs = list(contigs.items())
    pos = [synth_positions(rng, length, ENR_RATE, [])
           for length in contigs.values()]
    alt = [assign_alt_reads(rng, p, sites[name],
                            np.full(len(sites[name]), 0.5))
           for p, name in zip(pos, contigs)]
    write_bam_vectorized(base / "normal.bam", refs, pos, alt)
    pos, alt = [], []
    for name, length in contigs.items():
        evs = plan[name]
        starts = synth_positions(rng, length, ENR_RATE,
                                 [(s0, e, float(cn)) for s0, e, cn, _ in evs])
        vaf = np.full(len(sites[name]), 0.5)
        for s0, e, cn, b in evs:
            inside = (sites[name] >= s0) & (sites[name] < e)
            vaf[inside] = b / cn if cn else 0.0
        pos.append(starts)
        alt.append(assign_alt_reads(rng, starts, sites[name], vaf))
    write_bam_vectorized(base / "tumor.bam", refs, pos, alt)
    return {"ref": ref, "bed": bed, "het": het, "normal": base / "normal.bam",
            "tumor": base / "tumor.bam", "plan": plan,
            "targets": sum(1 for _ in open(bed))}


def check_enrichment_calls(vcf: Path, plan: dict) -> list[dict]:
    """Every planted event is covered, for at least half its length, by
    records of its copy number."""
    _samples, recs = vcf_records(vcf)
    got = []
    for chrom, evs in plan.items():
        for s0, e, cn, _b in evs:
            covered = 0
            for r in recs:
                info = dict(kv.split("=", 1) for kv in r[7].split(";")
                            if "=" in kv)
                end = int(info["END"])
                f = dict(zip(r[8].split(":"), r[9].split(":")))
                if r[0] == chrom and f.get("CN") == str(cn):
                    covered += max(0, min(e, end) - max(s0, int(r[1])))
            got.append({"chrom": chrom, "start": s0, "end": e, "cn": cn,
                        "covered": covered / (e - s0)})
    missed = [g for g in got if g["covered"] < 0.5]
    if missed:
        fail(f"planted events not called with their CN: {missed}")
    return got


def phase_e2e_enrichment(seed: int, workdir: Path) -> dict:
    from canvas_tpu_torch.ops import cbs
    from canvas_tpu_torch.pipeline import cli

    t0 = time.perf_counter()
    panel = make_panel(workdir / "panel", seed, ENR_CONTIGS)
    gen_s = time.perf_counter() - t0
    # both CBS engines start from this boundary (cached per process, keyed
    # as run_cbs calls it); timed here so neither run's stage times hold it
    t0 = time.perf_counter()
    cbs.compute_boundary(cbs.DEFAULT_NPERM, cbs.DEFAULT_ALPHA, cbs.DEFAULT_ETA)
    boundary_s = time.perf_counter() - t0
    args = ["Tumor-normal-enrichment", "-b", str(panel["tumor"]),
            "-n", "tumor", "--normal-bam", str(panel["normal"]),
            "--sample-b-allele-vcf", str(panel["het"]),
            "--manifest", str(panel["bed"]), "-r", str(panel["ref"])]
    runs = {}
    for dev in ("cuda", "cpu"):
        out = workdir / f"enr_{dev}"
        if dev == "cuda":
            reset_launches()
        t0 = time.perf_counter()
        rc = cli.main([*args, "-o", str(out), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"Tumor-normal-enrichment on {dev} exited {rc}")
        prof = json.loads((out / "tumor_profile.json").read_text())
        note = [st for st in prof["stages"]
                if st["name"] == "CanvasPartitionCbsEngine"]
        runs[dev] = {"wall_s": wall,
                     "stages": {st["name"]: st["seconds"]
                                for st in prof["stages"] if "seconds" in st},
                     "cbs": note[0] if note else None}
    if (runs["cuda"]["cbs"] or {}).get("cbs_engine") != "frontier":
        fail(f"the CUDA run did not take the frontier CBS engine: "
             f"{runs['cuda']['cbs']}")
    if (runs["cpu"]["cbs"] or {}).get("cbs_engine") != "host":
        fail(f"the CPU run did not take the host CBS engine: "
             f"{runs['cpu']['cbs']}")
    n_levels = runs["cuda"]["cbs"]["frontier_levels"]
    if launches["arc_scan"] < max(n_levels, 1):
        fail(f"B4 launched {launches['arc_scan']} times over {n_levels} "
             f"frontier levels")
    body_cuda = vcf_body(workdir / "enr_cuda" / "tumor_CNV.vcf.gz")
    body_cpu = vcf_body(workdir / "enr_cpu" / "tumor_CNV.vcf.gz")
    if body_cuda != body_cpu:
        diff = [ln for ln in set(body_cuda) ^ set(body_cpu)]
        fail(f"tumor_CNV.vcf.gz differs between --device cuda and --device "
             f"cpu: {sorted(diff)[:12]}")
    calls = check_enrichment_calls(workdir / "enr_cuda" / "tumor_CNV.vcf.gz",
                                   panel["plan"])
    return {"phase": "e2e-enrichment",
            "genome_bp": sum(ENR_CONTIGS.values()),
            "contigs": len(ENR_CONTIGS), "targets": panel["targets"],
            "rate": ENR_RATE, "generate_s": gen_s,
            "cbs_boundary_s": boundary_s, "vcf_cuda_equals_cpu": True, "launches": launches,
            "frontier_levels": n_levels, "events": calls,
            "cuda": runs["cuda"], "cpu": runs["cpu"]}


def phase_cbs(workdir: Path, dev: torch.device) -> dict:
    """The frontier engine on the panel's tumor ratio coverage (the CUDA
    run's CanvasClean output), on CUDA tensors and on CPU tensors."""
    from canvas_tpu_torch.genome.contigs import ContigTable
    from canvas_tpu_torch.io.bins import BinSet
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device
    from canvas_tpu_torch.pipeline.runner import coverage_by_contig

    contigs = ContigTable(tuple(ENR_CONTIGS), tuple(ENR_CONTIGS.values()))
    bins = BinSet.read_text(
        workdir / "enr_cuda" / "Checkpoints" / "CanvasClean_tumor.cleaned.gz",
        contigs)
    cov = coverage_by_contig(bins)
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        levels: list[dict] = []
        arc_scan_cuda.LAUNCHES["arc_scan"] = 0
        t0 = time.perf_counter()
        lens = cbs_device.run_cbs_device(cov, device=d, levels=levels)
        out[name] = {"seconds": time.perf_counter() - t0,
                     "arc_scan_launches": arc_scan_cuda.LAUNCHES["arc_scan"],
                     "levels": levels, "lengths": lens}
    for c in cov:
        if not np.array_equal(out["cuda"]["lengths"][c],
                              out["cpu"]["lengths"][c]):
            fail(f"frontier segments on {c} differ between CUDA and CPU "
                 f"tensors: {out['cuda']['lengths'][c].tolist()} vs "
                 f"{out['cpu']['lengths'][c].tolist()}")
    if out["cuda"]["arc_scan_launches"] < len(out["cuda"]["levels"]):
        fail("B4 launched fewer times than the engine ran levels")
    traced = trace_frontier(cov, dev)
    if traced["lengths"] != {c: v.tolist()
                             for c, v in out["cuda"]["lengths"].items()}:
        fail("the profiled frontier run gave other segments")
    return {"phase": "CBS", "bins": {c: len(v) for c, v in cov.items()},
            "segments": {c: len(v) for c, v in out["cuda"]["lengths"].items()},
            "lengths_equal": True,
            "n_levels": len(out["cuda"]["levels"]),
            "cuda_s": out["cuda"]["seconds"], "cpu_s": out["cpu"]["seconds"],
            "arc_scan_launches": out["cuda"]["arc_scan_launches"],
            "levels_cuda": out["cuda"]["levels"],
            "levels_cpu": out["cpu"]["levels"],
            "profiled_cuda": traced["profile"]}


def trace_frontier(cov: dict, dev: torch.device) -> dict:
    """One more frontier run on CUDA tensors under torch.profiler: its wall
    seconds, the device time of its kernels and copies (the events on the
    card, summed: its busy time on one stream), and its kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from canvas_tpu_torch.ops import cbs_device

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lens = cbs_device.run_cbs_device(cov, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = prof.key_averages()
    device_us = 0.0
    top = []
    for ev in stats:
        if ev.device_type != DeviceType.CUDA:   # host ops repeat their kernels
            continue
        us = ev.self_device_time_total
        device_us += us
        top.append((us, ev.key, ev.count))
    launches = sum(ev.count for ev in stats
                   if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                 "cudaLaunchKernelExC"))
    top.sort(reverse=True)
    return {"lengths": {c: v.tolist() for c, v in lens.items()},
            "profile": {
                "wall_s": wall, "device_busy_s": device_us / 1e6,
                "busy_share": device_us / 1e6 / wall,
                "kernel_launches": launches,
                "top_device": [{"name": k[:80], "ms": us / 1e3, "count": n}
                               for us, k, n in top[:8]]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    build = phase_build()
    emit(build)
    b1 = phase_b1(args.seed, dev)
    emit(b1)
    b2, b3 = phase_b2_b3(args.seed, dev)
    emit(b2)
    emit(b3)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        e2e = phase_e2e(args.seed, Path(workdir))
    emit(e2e)
    b4 = phase_b4(args.seed, dev)
    emit(b4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_enr_") as workdir:
        enr = phase_e2e_enrichment(args.seed, Path(workdir))
        emit(enr)
        emit(phase_cbs(Path(workdir), dev))

    launches = e2e["launches"]
    top = b4["shapes"][0]
    kernels = [
        {"name": "prefix_scan", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/prefix_scan.cu",
         "replaces": "canvas_tpu/ops/prefix_pallas.py:80",
         "launches": launches["prefix_scan"],
         "max_abs_err": b1["max_abs_err"], "ms": b1["ms"],
         "plain_ms": b1["plain_ms"]},
        {"name": "chunk_matrix", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/viterbi.cu",
         "replaces": "canvas_tpu/ops/viterbi_pallas.py:100",
         "launches": launches["chunk_matrix"],
         "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "plain_ms": b2["plain_ms"]},
        {"name": "forward_backtrack", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/viterbi.cu",
         "replaces": "canvas_tpu/ops/viterbi_pallas.py:139",
         "launches": launches["forward_backtrack"],
         "max_abs_err": b3["max_abs_err"], "ms": b3["ms"],
         "plain_ms": b3["plain_ms"]},
        {"name": "arc_scan", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/arc_scan.cu",
         "replaces": "canvas_tpu/ops/cbs_device.py:200",
         "launches": enr["launches"]["arc_scan"],
         "max_abs_err": max(sh["max_abs_err"] for sh in b4["shapes"]),
         "ms": top["ms"], "plain_ms": top["plain_ms"]},
    ]
    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
