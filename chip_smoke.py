#!/usr/bin/env python3
"""Smoke run of canvas_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:

  1. build   nvcc-builds the kernels from csrc/ and prints the build time,
             ptxas's lines on each kernel's registers, shared memory and
             spills (-Xptxas -v), the instructions of one interior run of
             B4's lag loop in its SASS (cuobjdump) and the card's name and
             power limit;
  2. B1      the prefix-scan kernel at chr1 length (248,956,422 positions,
             tracks made by numpy from --seed) against its plain torch
             version on the card: int32 equality, both times, and the
             times of torch.cumsum over the unpacked, masked [3, Lp] int32
             tracks (the one library call for the same function; the port
             never calls it) and of three 1-D cumsums, one a track;
  3. B2/B3   the chunked-Viterbi kernels at the production decode shape
             (24 contigs padded to 32 lanes x 524,288 bins x 5 states,
             chunk 256, NB emissions, ragged prefix masks) against their
             plain versions on the card: exact equality, both times, B3's
             device-memory allocations, and the whole decode's time.  B2
             runs the decode's uniform model (the chain it took is
             printed) and, checked and timed beside it, a non-uniform
             model from --seed (the general chain);
  4. e2e     SmallPedigree-WGS through the CLI entry point on a synthetic
             trio (4 contigs, 20 Mbp, 12.5x) with --device cuda and again
             with --device cpu: identical VCFs, the planted shared gain and
             de novo loss called, every kernel launched by the CUDA run and
             B2 on its uniform chain;
  5. B4      the CBS arc-scan kernel at three synthetic frontier shapes
             (8 x 32,768: eight segments of 19,661-32,768 bins, as the top
             level of 20,000-target contigs would bucket them; 64 x 4,096:
             a deep level; 1 x 32,768 with 19,930 bins: the enrichment
             panel's top level; cumsums of noise with planted steps from
             --seed)
             against its plain torch version on the card: best bit for
             bit, bl0 and the derived t2/ti/tj equal, both times, and the
             blocks and pair terms of the plain version's walk;
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
             run under torch.profiler: device busy time and kernel launches;
  8. e2e-germline
             Germline-WGS through the CLI entry point on the trio's proband
             BAM with --device cuda and again with --device cpu: identical
             VCFs, the proband's CN 3 gain on chr1 and CN 1 loss on chr2
             called, B1 launched once a contig by the CUDA run, the stage
             times of both runs;
  9. e2e-somatic-wgs
             Somatic-WGS through the CLI entry point on the panel's tumor
             and normal BAMs and het-site VCF, without --manifest (whole-
             genome bins over the 30 Mbp), with --device cuda and again with
             --device cpu: identical VCFs, every planted event called with
             its copy number (check_enrichment_calls' rule), the evenness
             score and ##LocalSDmetric, the CUDA run's model grid on the
             card (somatic_grid.CALLS), B1 once a contig and sample, the
             stage times of both runs;
 10. gc-bin  GCContentWeighted binning (binning.bin_sample) at chr1 length
             (tracks, counts and GC weights made by numpy from --seed) on
             the card and on the CPU: equal starts, ends, GC and counts,
             both times;
 11. wgs-partition
             the Wavelets partition on the host, as both packages run it, at
             whole-genome size: 24 hg38 contigs at 500 bp bins (6,176,550
             bins) of NB coverage from --seed with planted gains, losses,
             homozygous deletions and N-gaps.  The seconds of
             coverage_variability, factor_of_three_cmads, evenness_score
             and segment_coverage (germline and somatic, and germline one
             contig after another without its thread pool), and for chr1
             alone of decompose, hard_threshold, reconstruct,
             heal_bad_splits and refine_segments one by one; every planted
             event has a breakpoint within WGS_MISS_BINS of each end, and
             the share of ends with one within 2 bins is printed (the
             unbalanced Haar split lands a few bins off on about 5 % of
             ends, in both packages alike).

Each phase's line carries its seconds (`phase_s`).  It then prints the
phases' seconds and the total, the card's name and power limit, one JSON
line with the kernels' results, and as its last line
{"ok": true, "device": {...}}.
Each kernel's `bound_ms` is the least time the card could take for the
work this run's inputs need: the larger of its bytes (each input read
once, each output written once; emissions of live steps only) over
HBM_BPS and its operations over F32_OPS / FLOPS_PER_OP.
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

# NVIDIA H100 SXM peaks (data sheet, 700 W): device memory, and f32 outside
# the tensor cores.  The f32 peak counts an FMA as two operations; the
# kernels' adds, subtractions, multiplications and maxima are none, and
# each takes an FMA's issue slot, so it counts as two of F32_OPS.
HBM_BPS = 3.35e12
F32_OPS = 67e12
FLOPS_PER_OP = 2

# B4 at three frontier shapes: (segments, padded length, length of every
# segment or None for lengths drawn in (0.6 npad, npad])
B4_SHAPES = ((8, 32_768, None), (64, 4_096, None), (1, 32_768, 19_930))

# the Tumor-normal-enrichment panel, after benchmarks/e2e_enrichment.py
ENR_CONTIGS = {f"chr{i}": 10_000_000 for i in range(1, 4)}
ENR_RATE = 0.3               # read starts per position, diploid
TARGET_LEN, TARGET_SPACING = 400, 500
EVENT_KINDS = [(1, 0), (3, 1), (0, 0), (4, 1)]   # (total CN, B alleles)
MARGIN_BP, GAP_BP = 500_000, 1_200_000
SIZE_RANGE = (800_000, 1_600_000)

# the whole-genome wavelet partition: NB coverage at 500 bp bins, mean 100
WGS_MEAN, WGS_NB_SIZE = 100.0, 100.0
# (kind, mean over WGS_MEAN, bins low, bins high), cycled along each contig
WGS_EVENTS = [("loss", 0.5, 100, 2_000), ("gain", 1.5, 100, 2_000),
              ("hom_del", 0.0, 20, 200), ("gain", 1.5, 100, 2_000),
              ("n_gap", 0.0, 1_000, 5_000), ("loss", 0.5, 100, 2_000)]
WGS_EVENT_SPACING = (2_000, 20_000)
# an end with no breakpoint this close counts as missed
WGS_MISS_BINS = 25
GC_BIN_SIZE = 400


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events, after one
    warm-up call.  Back-to-back calls time the device only where it is
    slower than the host that enqueues them; with queued=True a sleep
    kernel holds the stream while the host enqueues all reps calls, so the
    events time the device work alone (a kernel's time, not its
    wrapper's)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # 2e9 cycles a second is above the card's clock: the sleep lasts
        # at least as long as the enqueueing, twice over
        torch.cuda._sleep(int(min(2 * reps * host_s, 2.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least milliseconds on the card, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops * FLOPS_PER_OP / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report() -> dict[str, list[str]]:
    """Per source, the lines of this process's -Xptxas -v report that name
    a kernel and give its registers, shared memory and spills."""
    from canvas_tpu_torch.ops import cuda_lib

    keep = ("entry function", "spill", "Used")
    return {name: [ln.strip() for ln in log.splitlines()
                   if any(k in ln for k in keep)]
            for name, log in cuda_lib.PTXAS_LOG.items()}


def interior_run_mix(sass: str, kernel: str, terms: int) -> dict:
    """From cuobjdump -sass text: one interior run of `kernel`'s lag loop.
    The run's body is the longest straight line of FADD and FMNMX; a
    conditional branch jumps over the edge path into it, and the nearest
    backward branch after it closes the loop.  Its instructions are the
    loop's less the edge path's."""
    import re

    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs if kernel in f.split("\n")[0]), None)
    if body is None:
        return {"error": f"{kernel} not in the dump"}
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                         r"([^;]*);", body):
        ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    best, start, i = (0, 0), None, 0
    while i < len(ins):
        j = i
        while j < len(ins) and ins[j][1].split(".")[0] in ("FADD", "FMNMX"):
            j += 1
        if j - i > best[0] - best[1]:
            best = (j, i)
        i = j + 1
    end, first = best
    if end - first < 2:
        return {"error": "no run of FADD and FMNMX"}
    start = ins[first][0]
    step = ins[1][0] - ins[0][0]
    into = [a for a, op, rest in ins
            if op == "BRA" and a < start and rest.strip() == f"0x{start:x}"]
    back = [(a, int(t, 16)) for a, op, rest in ins
            if op == "BRA" and a > start
            for t in re.findall(r"0x([0-9a-f]+)", rest)
            if into and int(t, 16) < into[-1]]
    if not into or not back:
        return {"error": "no branch into the run or no loop around it"}
    loop_end, loop_head = back[0]
    edge = (start - into[-1]) // step - 1
    n_run = (loop_end - loop_head) // step + 1 - edge
    run = ins[first:end]
    return {"instructions": n_run, "terms": terms,
            "per_term": n_run / terms,
            "FADD": sum(op.startswith("FADD") for _, op, _ in run),
            "FMNMX_abs": sum(op.startswith("FMNMX") and "|" in rest
                             for _, op, rest in run)}


def b4_sass() -> dict:
    """cuobjdump -sass of the built B4 library, read by interior_run_mix
    for phase 1's kernel; kPos * kRun terms a run."""
    import re
    import shutil

    from canvas_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC_DIR / "arc_scan.cu").read_text()
    k = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
         for name in ("kPos", "kRun")}
    tool = shutil.which("cuobjdump") or str(
        Path(cuda_lib.nvcc_path()).parent / "cuobjdump")
    res = subprocess.run([tool, "-sass",
                          str(cuda_lib.BUILD_DIR / "libarc_scan.so")],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        return {"error": res.stderr[-400:]}
    return interior_run_mix(res.stdout, "arc_scan_blocks",
                            k["kPos"] * k["kRun"])


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
    native_s = time.perf_counter() - t0
    try:
        sass = b4_sass()
    except (OSError, subprocess.SubprocessError, AttributeError) as e:
        sass = {"error": repr(e)}       # a report only: it fails nothing
    return {"phase": "build", "seconds": secs, "native_seconds": native_s,
            "ptxas": ptxas_report(), "b4_interior_run": sass,
            "gpu": gpu_line()}


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
                 reps=20, queued=True)
    plain_ms = cuda_ms(
        lambda: pc.fused_prefix_sums_plain(p_t, o_t, g_t, offset, L, cap),
        reps=3)
    # the library call: torch.cumsum over the unpacked, masked tracks
    p = pc._unpack_bits(p_t)
    p = p * ((torch.arange(Lp, device=dev) >= offset)
             & (torch.arange(Lp, device=dev) < L))
    tracks = torch.stack([p, torch.clamp(o_t.to(torch.int64), max=cap) * p,
                          pc._unpack_bits(g_t)]).to(torch.int32)
    del p
    torch.cuda.empty_cache()
    library_ms = cuda_ms(
        lambda: torch.cumsum(tracks, dim=1, dtype=torch.int32), reps=10,
        queued=True)
    # beside it, three cumsums of one track each (not one call)
    rows_ms = cuda_ms(lambda: [torch.cumsum(t, 0, dtype=torch.int32)
                               for t in tracks], reps=10, queued=True)
    del tracks
    torch.cuda.empty_cache()
    # reads 2 bits and a byte, writes three int32 per position; three adds
    n_bytes = Lp // 8 * 2 + Lp + 12 * Lp
    bound_ms, bound_by = bound(n_bytes, 3 * Lp)
    return {"phase": "B1", "positions": L, "padded": Lp, "equal": True,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_rows_ms": rows_ms,
            "bytes": n_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "GBps": n_bytes / (ms * 1e-3) / 1e9}


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

    # B2 against its plain version, on the decode's model and on a
    # non-uniform one
    lt_general = np.log(np.random.default_rng(seed + 4).dirichlet(
        np.ones(S), size=S)).astype(np.float32)
    b2_err, chains = 0.0, {}
    for name, model in (("uniform", lt), ("general", lt_general)):
        before = dict(vc.CHAINS)
        m_k = vc.chunk_matrices(em, base, lane_len, model, li)
        torch.cuda.synchronize()
        chains[name] = [k for k in vc.CHAINS if vc.CHAINS[k] > before[k]]
        m_p = vc.chunk_matrices_plain(em, base, lane_len, model, li)
        err = float((m_k - m_p).abs().max())
        if not torch.equal(m_k.view(torch.int32), m_p.view(torch.int32)):
            fail(f"B2 ({name} model) differs from its plain version (max "
                 f"|diff| {err})")
        b2_err = max(b2_err, err)
        del m_k, m_p
    if chains != {"uniform": ["uniform"], "general": ["general"]}:
        fail(f"B2 took the wrong chains: {chains}")
    # B3 against its plain version, from the same chunk-start scores; it
    # allocates its outputs and nothing else in device memory
    ss = torch.randn((S, L), generator=torch.Generator(dev).manual_seed(seed),
                     device=dev) * 1000.0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p_k, e_k = vc.forward_backtrack(em, base, lane_len, ss, lt, li)
    torch.cuda.synchronize()
    b3_alloc = torch.cuda.max_memory_allocated() - mem0
    if b3_alloc > p_k.nbytes + e_k.nbytes + (1 << 20):
        fail(f"B3 allocated {b3_alloc} bytes for {p_k.nbytes + e_k.nbytes} "
             f"bytes of outputs")
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

    b2_ms = cuda_ms(lambda: vc.chunk_matrices(em, base, lane_len, lt, li), 20,
                    queued=True)
    b2_general_ms = cuda_ms(
        lambda: vc.chunk_matrices(em, base, lane_len, lt_general, li), 20,
        queued=True)
    b2_plain = cuda_ms(
        lambda: vc.chunk_matrices_plain(em, base, lane_len, lt, li), 2)
    b3_ms = cuda_ms(
        lambda: vc.forward_backtrack(em, base, lane_len, ss, lt, li), 20,
        queued=True)
    b3_plain = cuda_ms(
        lambda: vc.forward_backtrack_plain(em, base, lane_len, ss, lt, li), 2)
    dec_ms = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK),
        3)
    dec_plain = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                           plain=True), 1)
    # both kernels read em only at live steps (base + k < length): 20
    # bytes each; base and length are read once per lane
    live = int(torch.clamp(lane_len.to(torch.int64) - base, 0, CHUNK).sum())
    lanes_in = 8 * L
    # B2 writes the f32 [S, S, L] matrices.  Per live step, on the
    # decode's uniform model: per row 4 maxima for the row maximum, 1 add,
    # then 5 adds, 5 maxima and 5 adds, 100 operations; a general model's
    # 25 (max,+) entries of 5 adds, 4 maxima and one add would be 250
    uniform = vc.uniform_transitions(lt) is not None
    b2_bytes = 20 * live + lanes_in + 4 * S * S * L
    b2_bound, b2_by = bound(b2_bytes, (100 if uniform else 250) * live)
    b2_general_bound, b2_general_by = bound(b2_bytes, 250 * live)
    # B3: per live step 25 adds, 20 comparisons and 5 adds; reads the f32
    # start scores, writes int8 paths [chunk, S, L] and prev_end [S, L]
    b3_bytes = 20 * live + lanes_in + 4 * S * L + CHUNK * S * L + S * L
    b3_bound, b3_by = bound(b3_bytes, 50 * live)
    shape = [B, T, S]
    b2 = {"phase": "B2", "shape": shape, "chunk": CHUNK, "lanes": L,
          "live_steps": live, "equal": True, "max_abs_err": b2_err,
          "chain": "uniform" if uniform else "general",
          "ms": b2_ms, "plain_ms": b2_plain,
          "library_ms": None,
          "bytes": b2_bytes, "bound_ms": b2_bound, "bound_by": b2_by,
          "bound_share": b2_bound / b2_ms,
          "general_model": {"ms": b2_general_ms,
                            "bound_ms": b2_general_bound,
                            "bound_by": b2_general_by,
                            "bound_share": b2_general_bound / b2_general_ms}}
    b3 = {"phase": "B3", "shape": shape, "chunk": CHUNK, "lanes": L,
          "live_steps": live, "equal": True, "max_abs_err": b3_err,
          "ms": b3_ms, "plain_ms": b3_plain,
          "library_ms": None,
          "bytes": b3_bytes, "bound_ms": b3_bound, "bound_by": b3_by,
          "bound_share": b3_bound / b3_ms, "alloc_bytes": b3_alloc,
          "decode_ms": dec_ms, "decode_plain_ms": dec_plain,
          "non_diploid_bins": called}
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


def profile_stages(path: Path) -> dict:
    prof = json.loads(path.read_text())
    return {st["name"]: st["seconds"] for st in prof["stages"]
            if "seconds" in st}


def run_both(args: list[str], out_prefix: Path, profile: str) -> dict:
    """The CLI on --device cuda, then on --device cpu; the CUDA run's
    kernel launches and model-grid calls, both runs' wall and stage
    seconds."""
    from canvas_tpu_torch.models import somatic_grid
    from canvas_tpu_torch.pipeline import cli

    runs = {}
    for dev in ("cuda", "cpu"):
        out = Path(f"{out_prefix}_{dev}")
        if dev == "cuda":
            reset_launches()
            grid0 = dict(somatic_grid.CALLS)
        t0 = time.perf_counter()
        rc = cli.main([*args, "-o", str(out), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
            grid = {k: v - grid0[k] for k, v in somatic_grid.CALLS.items()}
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"{args[0]} on {dev} exited {rc}")
        runs[dev] = {"wall_s": wall, "out": out,
                     "stages": profile_stages(out / profile)}
    return {"launches": launches, "grid_calls": grid, **runs}


def same_vcf(a: Path, b: Path) -> None:
    body_a, body_b = vcf_body(a), vcf_body(b)
    if body_a != body_b:
        diff = sorted(set(body_a) ^ set(body_b))
        fail(f"{a.name} differs between --device cuda and --device cpu: "
             f"{diff[:12]}")


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
    from canvas_tpu_torch.ops import viterbi_cuda
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
            chains0 = dict(viterbi_cuda.CHAINS)
        t0 = time.perf_counter()
        rc = cli.main([*args, "-o", str(out), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
            chains = {k: v - chains0[k]
                      for k, v in viterbi_cuda.CHAINS.items()}
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
    if chains["general"] or chains["uniform"] < n_samples:
        fail(f"B2 did not run the uniform chain for every sample: {chains}")
    for vcf in ["CNV.vcf.gz", *[f"{n}_CNV.vcf.gz" for n in PLANS]]:
        if vcf_body(workdir / "out_cuda" / vcf) != \
                vcf_body(workdir / "out_cpu" / vcf):
            fail(f"{vcf} differs between --device cuda and --device cpu")
    calls = check_calls(workdir / "out_cuda" / "CNV.vcf.gz")
    return {"phase": "e2e", "genome_bp": sum(TRIO_CONTIGS.values()),
            "contigs": n_contigs, "samples": n_samples,
            "depth_x": TRIO_RATE * 50, "generate_s": gen_s,
            "vcf_cuda_equals_cpu": True, "launches": launches,
            "b2_chains": chains,
            "calls": calls, "cuda": runs["cuda"], "cpu": runs["cpu"]}


def b4_inputs(seed: int, B: int, npad: int, length: int | None,
              dev: torch.device):
    """Cumsums f32 [B, npad] of centred unit noise with two planted steps
    (0.3-1.0 sd, 2-10 % of the segment each) per row, lengths `length` or,
    where it is None, in (0.6 npad, npad], and their sums of squares, made
    by numpy."""
    rng = np.random.default_rng(seed + 3)
    cs = np.zeros((B, npad), np.float32)
    n = np.zeros(B, np.int32)
    tss = np.zeros(B, np.float32)
    for i in range(B):
        L = length or int(rng.integers(int(0.6 * npad) + 1, npad + 1))
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
    for B, npad, length in B4_SHAPES:
        cs, n, tss = b4_inputs(seed + npad, B, npad, length, dev)
        seed_v, lag_hi, psd2, _ti0, _tj0 = cd.arc_scan_inputs(cs, n, npad,
                                                               al0)
        args = (cs, n, lag_hi, seed_v, psd2, al0)
        best_k, bl0_k = ac.arc_scan(*args)
        torch.cuda.synchronize()
        walk: dict = {"blocks": 0, "terms": 0}
        best_p, bl0_p = ac.arc_scan_plain(*args, count=walk)
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
        # the walk's pair terms, each a subtraction and a maximum of |d|
        # (w is factored out of the maximum over positions, once a lag);
        # cs, psd2 and the four [B] vectors read once
        b4_bound, b4_by = bound(4 * (cs.numel() + psd2.numel() + 4 * B),
                                2 * walk["terms"])
        ms = cuda_ms(lambda: ac.arc_scan(*args), reps=20, queued=True)
        plain_ms = cuda_ms(lambda: ac.arc_scan_plain(*args), reps=2)
        tmax_ms = cuda_ms(lambda: cd.tmax_batch(cs, n, tss, npad, al0),
                          reps=10)
        shapes.append({
            "segments": B, "npad": npad, "blocks": psd2.numel(),
            "blocks_visited": walk["blocks"], "hits": int((bl0_k >= 0).sum()),
            "equal": True, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "tmax_batch_ms": tmax_ms,
            "pairs_dense": int(B * npad * (npad - 1) // 2),
            "pair_terms": walk["terms"], "bound_ms": b4_bound,
            "bound_by": b4_by, "bound_share": b4_bound / ms})
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


def phase_e2e_enrichment(seed: int, workdir: Path) -> tuple[dict, dict]:
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
            "cbs_boundary_s": boundary_s, "vcf_cuda_equals_cpu": True,
            "launches": launches,
            "frontier_levels": n_levels, "events": calls,
            "cuda": runs["cuda"], "cpu": runs["cpu"]}, panel


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
    card, summed: its busy time on one stream), B4's part of it, and its
    kernel launches."""
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
    device_us = b4_us = 0.0
    top = []
    for ev in stats:
        if ev.device_type != DeviceType.CUDA:   # host ops repeat their kernels
            continue
        us = ev.self_device_time_total
        device_us += us
        if "arc_scan" in ev.key:                # B4's two kernels
            b4_us += us
        top.append((us, ev.key, ev.count))
    launches = sum(ev.count for ev in stats
                   if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                 "cudaLaunchKernelExC"))
    top.sort(reverse=True)
    return {"lengths": {c: v.tolist() for c, v in lens.items()},
            "profile": {
                "wall_s": wall, "device_busy_s": device_us / 1e6,
                "busy_share": device_us / 1e6 / wall,
                "b4_device_s": b4_us / 1e6,
                "b4_share_of_busy": b4_us / device_us if device_us else None,
                "kernel_launches": launches,
                "top_device": [{"name": k[:80], "ms": us / 1e3, "count": n}
                               for us, k, n in top[:8]]}}


def phase_e2e_germline(workdir: Path) -> dict:
    """Germline-WGS on the trio's proband (phase e2e's BAM and reference)."""
    n_contigs = len(TRIO_CONTIGS)
    runs = run_both(["Germline-WGS", "-b", str(workdir / "proband.bam"),
                     "-n", "proband", "-r", str(workdir / "ref")],
                    workdir / "germline", "proband_profile.json")
    if runs["launches"]["prefix_scan"] != n_contigs:
        fail(f"B1 launched {runs['launches']['prefix_scan']} times for "
             f"{n_contigs} contigs")
    vcf = runs["cuda"]["out"] / "proband_CNV.vcf.gz"
    same_vcf(vcf, runs["cpu"]["out"] / "proband_CNV.vcf.gz")
    calls = check_enrichment_calls(vcf, {GAIN[0]: [(GAIN[1], GAIN[2], 3, 1)],
                                         LOSS[0]: [(LOSS[1], LOSS[2], 1, 0)]})
    return {"phase": "e2e-germline", "genome_bp": sum(TRIO_CONTIGS.values()),
            "contigs": n_contigs, "vcf_cuda_equals_cpu": True,
            "launches": runs["launches"], "events": calls,
            **{dev: {"wall_s": runs[dev]["wall_s"],
                     "stages": runs[dev]["stages"]}
               for dev in ("cuda", "cpu")}}


def phase_e2e_somatic_wgs(panel: dict, workdir: Path) -> dict:
    """Somatic-WGS (no manifest) on the enrichment phase's tumor, normal and
    het-site VCF, whose reads cover the whole 30 Mbp."""
    import re

    n_contigs = len(ENR_CONTIGS)
    runs = run_both(["Somatic-WGS", "-b", str(panel["tumor"]), "-n", "tumor",
                     "--normal-bam", str(panel["normal"]),
                     "--sample-b-allele-vcf", str(panel["het"]),
                     "-r", str(panel["ref"])],
                    workdir / "somatic_wgs", "tumor_profile.json")
    if runs["launches"]["prefix_scan"] != 2 * n_contigs:
        fail(f"B1 launched {runs['launches']['prefix_scan']} times for "
             f"{n_contigs} contigs of tumor and normal")
    if runs["grid_calls"] != {"device": 1, "numpy": 0}:
        fail(f"the CUDA run did not take the device grid: "
             f"{runs['grid_calls']}")
    vcf = runs["cuda"]["out"] / "tumor_CNV.vcf.gz"
    same_vcf(vcf, runs["cpu"]["out"] / "tumor_CNV.vcf.gz")
    calls = check_enrichment_calls(vcf, panel["plan"])
    header = gzip.open(vcf, "rt").read()
    local_sd = re.search(r"^##LocalSDmetric=(.*)$", header, re.M)
    even = runs["cuda"]["out"] / "Checkpoints" / "EvennessMetric_tumor.txt"
    bins = sum(1 for _ in gzip.open(runs["cuda"]["out"] / "Checkpoints"
                                    / "CanvasClean_tumor.cleaned.gz", "rt"))
    return {"phase": "e2e-somatic-wgs", "genome_bp": sum(ENR_CONTIGS.values()),
            "contigs": n_contigs, "cleaned_bins": bins,
            "vcf_cuda_equals_cpu": True, "launches": runs["launches"],
            "grid_calls": runs["grid_calls"],
            "evenness": (float(even.read_text()) if even.exists() else None),
            "local_sd_metric": local_sd.group(1) if local_sd else None,
            "events": calls,
            **{dev: {"wall_s": runs[dev]["wall_s"],
                     "stages": runs[dev]["stages"]}
               for dev in ("cuda", "cpu")}}


def gc_tracks(seed: int, length: int) -> dict:
    """One contig's tracks for GCContentWeighted binning, made by numpy:
    80 % possible positions, 41 % G/C, read starts at 0.3 a position and
    per-position weights from a 101-entry observed/expected table."""
    rng = np.random.default_rng(seed + 50)
    ratio = rng.uniform(0.5, 2.0, 101).astype(np.float32)
    return {"possible": rng.integers(0, 5, length, dtype=np.uint8) != 0,
            "observed": rng.poisson(0.3, length).astype(np.uint8),
            "is_gc": rng.integers(0, 100, length, dtype=np.uint8) < 41,
            "offset": 10_000,
            "gc_weights": ratio[rng.integers(0, 101, length, dtype=np.uint8)]}


def phase_gc_bin(seed: int, dev: torch.device) -> dict:
    """GCContentWeighted binning at chr1 length on the card and on the
    CPU (float64 row sums, rounded): equal bins, both times."""
    from canvas_tpu_torch.ops import binning

    tracks = {"chr1": gc_tracks(seed, CHR1_LEN)}
    res, secs = {}, {}
    for name, d in (("cuda", dev), ("cuda_again", dev),
                    ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        res[name] = binning.bin_sample(tracks, GC_BIN_SIZE,
                                       mode="GCContentWeighted",
                                       device=d)["chr1"]
        secs[name] = time.perf_counter() - t0
    for field, a, b in zip(("start", "end", "gc", "count"), res["cuda"],
                           res["cpu"]):
        if not np.array_equal(a, b):
            n = int((a != b).sum()) if a.shape == b.shape else -1
            fail(f"GC-weighted {field} differs between cuda and cpu at {n} "
                 f"bins")
    counts = res["cuda"][3]
    return {"phase": "gc-bin", "positions": CHR1_LEN, "bin_size": GC_BIN_SIZE,
            "bins": len(counts), "count_sum": float(counts.sum(dtype=np.float64)),
            "equal": True, "cuda_s": secs["cuda"],
            "cuda_again_s": secs["cuda_again"], "cpu_s": secs["cpu"]}


def wgs_coverage(seed: int, lengths: list[int]) -> tuple[dict, dict]:
    """NB(WGS_MEAN) coverage of each contig at 500 bp bins with the
    WGS_EVENTS cycled along it; returns (coverage, events as (kind, start
    bin, end bin))."""
    rng = np.random.default_rng(seed + 40)
    p = WGS_NB_SIZE / (WGS_NB_SIZE + WGS_MEAN)
    cov, events = {}, {}
    k = 0
    for i, length in enumerate(lengths):
        name = f"chr{i + 1}"
        n = -(-length // DECODE_BIN)
        c = rng.negative_binomial(WGS_NB_SIZE, p, n).astype(np.float64)
        evs = []
        pos = int(rng.integers(*WGS_EVENT_SPACING))
        while True:
            kind, scale, lo, hi = WGS_EVENTS[k % len(WGS_EVENTS)]
            size = int(rng.integers(lo, hi))
            if pos + size + WGS_EVENT_SPACING[0] > n:
                break
            k += 1
            if scale:
                q = WGS_NB_SIZE / (WGS_NB_SIZE + WGS_MEAN * scale)
                c[pos:pos + size] = rng.negative_binomial(WGS_NB_SIZE, q, size)
            else:
                c[pos:pos + size] = 0.0
            evs.append((kind, pos, pos + size))
            pos += size + int(rng.integers(*WGS_EVENT_SPACING))
        cov[name], events[name] = c, evs
    return cov, events


def phase_wgs_partition(seed: int, lengths: list[int] = HG38) -> dict:
    """The Wavelets partition on the host at whole-genome size, timed stage
    by stage, with chr1's segmentation timed step by step."""
    from canvas_tpu_torch.config import CanvasConfig
    from canvas_tpu_torch.ops import metrics, stats, wavelets

    cfg = CanvasConfig()
    t0 = time.perf_counter()
    cov, events = wgs_coverage(seed, lengths)
    secs = {"generate": time.perf_counter() - t0}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        secs[name] = time.perf_counter() - t0
        return out

    cv = timed("coverage_variability", metrics.coverage_variability, cov,
               cfg.evenness_score_window)
    cmads = timed("factor_of_three_cmads", metrics.factor_of_three_cmads, cov)
    evenness = timed("evenness_score", metrics.evenness_score, cov,
                     cfg.evenness_score_window)
    bps = {}
    for flavour, germline in (("germline", True), ("somatic", False)):
        bps[flavour] = timed(
            f"segment_coverage_{flavour}", wavelets.segment_coverage, cov,
            germline, cv, cmads, mad_factor=cfg.mad_factor,
            threshold_lower=cfg.threshold_lower_maf)
    # the germline flavour again, one contig after another in this thread
    # (segment_coverage runs a thread per contig)
    serial = timed("segment_coverage_germline_serial", lambda: {
        name: wavelets.haar_wavelets(c, cfg.threshold_lower_maf, 80.0, True,
                                     cfg.mad_factor, cv, cmads)
        for name, c in cov.items()})
    if serial != bps["germline"]:
        fail("the serial germline segmentation differs from segment_coverage")
    # chr1 alone, haar_wavelets' steps one by one (germline)
    x = cov["chr1"]
    steps = {}

    def step(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        steps[name] = time.perf_counter() - t0
        return out

    tree, smooth = step("decompose", wavelets.decompose, x)
    variability = (stats.median(x) * cv if cv is not None else stats.mad(x))
    threshold = min(max(cfg.mad_factor * variability,
                        cfg.threshold_lower_maf), 80.0)
    step("hard_threshold", wavelets.hard_threshold, tree, threshold, True)
    rec = step("reconstruct", wavelets.reconstruct, tree, smooth)
    prelim = wavelets.breakpoints_from_reconstruction(rec)
    healed = step("heal_bad_splits", wavelets.heal_bad_splits, prelim, x,
                  cmads)
    refined = step("refine_segments", wavelets.refine_segments, healed, x)
    if refined != bps["germline"]["chr1"]:
        fail("chr1's step-by-step segmentation differs from segment_coverage")
    # distance from each planted end to the nearest breakpoint
    ends = {}
    for flavour, by_contig in bps.items():
        dist, missed = [], []
        for name, evs in events.items():
            b = np.asarray(by_contig[name])
            for kind, s0, e in evs:
                for at in (s0, e):
                    d = int(np.abs(b - at).min(initial=len(x)))
                    dist.append(d)
                    if d > WGS_MISS_BINS:
                        missed.append((name, kind, s0, e, d))
        if missed:
            fail(f"{flavour}: planted events without a breakpoint within "
                 f"{WGS_MISS_BINS} bins of an end: {missed[:8]}")
        dist = np.asarray(dist)
        ends[flavour] = {"ends": len(dist),
                         "within_2": int((dist <= 2).sum()),
                         "within_2_share": float((dist <= 2).mean()),
                         "max_bins": int(dist.max()),
                         "by_distance": np.bincount(dist).tolist()}
    return {"phase": "wgs-partition", "contigs": len(cov),
            "bins": sum(len(c) for c in cov.values()),
            "chr1_bins": len(x),
            "events": sum(len(v) for v in events.values()),
            "coverage_variability": cv, "evenness": evenness,
            "event_ends": ends,
            "breakpoints": {f: sum(len(v) for v in b.values())
                            for f, b in bps.items()},
            "host_s": secs, "chr1_host_s": steps,
            "chr1_tree_levels": len(tree),
            "chr1_tree_nodes": sum(len(lv) for lv in tree)}


def _timing(res: dict) -> dict:
    return {k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}


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

    t_start = time.perf_counter()
    phase_s = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        for res in (out if isinstance(out, tuple) else (out,)):
            if isinstance(res, dict) and "phase" in res:
                res["phase_s"] = phase_s[name]
                emit(res)
        return out

    run("build", phase_build)
    b1 = run("B1", phase_b1, args.seed, dev)
    b2, b3 = run("B2/B3", phase_b2_b3, args.seed, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        e2e = run("e2e", phase_e2e, args.seed, Path(workdir))
        germ = run("e2e-germline", phase_e2e_germline, Path(workdir))
    b4 = run("B4", phase_b4, args.seed, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_enr_") as workdir:
        enr, panel = run("e2e-enrichment", phase_e2e_enrichment, args.seed,
                         Path(workdir))
        run("CBS", phase_cbs, Path(workdir), dev)
        swgs = run("e2e-somatic-wgs", phase_e2e_somatic_wgs, panel,
                   Path(workdir))
    run("gc-bin", phase_gc_bin, args.seed, dev)
    torch.cuda.empty_cache()
    run("wgs-partition", phase_wgs_partition, args.seed)
    emit({"phase_seconds": phase_s,
          "total_s": time.perf_counter() - t_start})

    launches = e2e["launches"]
    top = b4["shapes"][0]
    kernels = [
        {"name": "prefix_scan", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/prefix_scan.cu",
         "replaces": "canvas_tpu/ops/prefix_pallas.py:80",
         "launches": (launches["prefix_scan"]
                      + germ["launches"]["prefix_scan"]
                      + swgs["launches"]["prefix_scan"]), **_timing(b1)},
        {"name": "chunk_matrix", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/viterbi.cu",
         "replaces": "canvas_tpu/ops/viterbi_pallas.py:100",
         "launches": launches["chunk_matrix"], **_timing(b2)},
        {"name": "forward_backtrack", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/viterbi.cu",
         "replaces": "canvas_tpu/ops/viterbi_pallas.py:139",
         "launches": launches["forward_backtrack"], **_timing(b3)},
        {"name": "arc_scan", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/arc_scan.cu",
         "replaces": "canvas_tpu/ops/cbs_device.py:200",
         "launches": enr["launches"]["arc_scan"],
         **_timing(top), "max_abs_err": max(sh["max_abs_err"]
                                            for sh in b4["shapes"])},
    ]
    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
