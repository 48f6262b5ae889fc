#!/usr/bin/env python3
"""Smoke run of canvas_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:

  1. build   nvcc-builds the kernels from csrc/ and prints the build time,
             ptxas's lines on each kernel's registers, shared memory and
             spills (-Xptxas -v), the instructions of one interior run of
             B4's lag loop in its SASS (cuobjdump), the FP64 instructions
             of one erfc and of one series term of K11 (and of the
             term's earlier form, built beside it from BEFORE_TERM_CU),
             K12's groups, buffers and cipher calls a position at each
             bucket width beside its earlier design's (the card's rule
             must equal cbs_mega_cuda.perm_layout, and K7's and K8's
             layouts theirs), and the card's name and power limit;
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
             model from --seed (the general chain).  Then K5 (phase 2,
             on B2's chunk matrices) and K6 (phase 4b, on B3's prev_end
             from K5's start scores), each against its plain version, bit
             for bit, with both times (lines "K5" and "K6", each also
             timed at 32 sequences of 256 to 8,192 chunks), and the whole
             decode's synchronising calls under CUDA's sync debug mode:
             the run fails unless there are none;
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
             0.8-1.6 Mb on a diploid normal) with --device cuda
             (whole-recursion CBS engine, kernels K9, B4, K10, K11
             carrying K14, K7, K8, K13, K15 and K15's keep flags with
             K16) under torch.profiler and again with --device cpu (host
             CBS engine): identical VCFs, K7, K8, K11, K13, K15 and K16
             launched at least once a level and K9 and K10 once,
             each CBS kernel's runs on the card in the trace equal to the
             launches counted (wrappers and graph replays; the kernels
             line takes the traced runs), every planted event called with
             its copy number, the stage times of both runs;
  7. CBS     the frontier engine on the tumor's ratio coverage of that
             panel, on CUDA tensors (K9, B4, K10, K11 and K12, each
             launched, counted from 0 for the run) and on CPU tensors
             (their plain versions): equal segments and the per-level
             profile; then one more CUDA run under torch.profiler (device
             busy time and kernel launches, each kernel's runs on the card
             equal to its counted launches) and one under CUDA's sync
             debug mode (its synchronising calls); then bench.py's CBS
             workload through the frontier engine on cuda (seconds,
             launches, profile) and with the five kernels' plain versions
             on the same CUDA tensors (equal segments); and K12's census
             of the panel's and bench.py's frontier runs: its calls by
             width, rows under the mask and P, the launches with a row
             under the mask, and its device time summed (torch.profiler);
  7b. cbs-mega
             the whole-recursion engine on the same coverage, its level
             captured once in a CUDA graph outside the timed run (the
             capture's seconds, the level's graph nodes: kernels, memsets,
             cooperative kernels): run_cbs on cuda takes it (engine
             "mega"); one run's wall, levels, graph replays, reads from
             the card (cbs_mega.SYNCS, at most 2) and synchronising calls
             (those reads and the four set-up copies, none else), the
             captured level's kernel nodes equal to its counted launches
             (K9, B4 and K10 under each tier's row mask, K11 carrying
             K14, K7, K8, K13, K15, K15's keep flags with K16) and B4's
             second kernel a tier, beside PR 18's count (NODES_BEFORE),
             and a dead level's replay time; the same engine on
             CPU tensors with equal segments and counts (levels, walk and
             edge chunks, walks accepted and rejected); one more CUDA run
             under torch.profiler (each kernel's runs on the card equal to
             its counted launches, at least one) and one for its host
             calls (the CUDA runtime calls by name); the frontier's
             figures from phase CBS and the level-loop engine's (LEVEL_LOOP_ENGINE)
             beside them; K13-K16 against their plain versions on every
             level of eager runs on the panel and on bench.py's CBS
             workload (bit for bit; K11 carrying K14 against
             decide_prep_plain, tail_p_plain and decide_plain chained,
             keep_table against edge_keep_plain and table_update_plain;
             dead levels left untouched), each timed on its first level
             beside its plain versions, with its bound (K14's added time:
             the fused launch less K11 alone); K7 and K8 against their
             plain versions on the card on the inputs of the engine's
             first level with a walk and first with an edge test, on the
             panel and on bench.py's CBS workload (flags, chunk counts
             and edge counts equal, chunk 0's statistics and subset sums
             bit for bit, both times, the bound; K7's beside its times
             after its redesign, BEFORE_K7_MS); bench.py's CBS workload
             (24 contigs x 16,384 bins) through run_cbs on cuda: the same
             figures, the best of 3 seconds with their reads, replays and
             launches, segments equal to its first run, to the engine on
             CPU tensors (counts too) and to an eager run with K7 and
             K8's plain versions; then B4 against its
             plain version at every tier width the engine uses (1,024 to
             65,536, 32 rows of which three lie under the tier's mask, the
             others zeroed and returning at once); last, the engine at its
             largest shape (192 contigs of 65,536 bins, a table of 1,024
             slots, 512 rows a level): the card's memory it holds between
             runs (cudaMemGetInfo and the caching allocator), its capture
             and a replayed run's wall, one more replayed run under
             torch.profiler (each kernel's device time, the busy share,
             each kernel's runs equal to its counted launches), and
             K13-K16 against their plain versions on every level of an
             eager run there too, timed on its first; K13's and K15's
             times beside their earlier design's (BEFORE_K13_K15); and
             a report that fails nothing: the rows on which K13 and K15
             differ from their plain versions where the values'
             exponents span 40 bits (wide_exponent_rows);
  7c. cbs-stats
             K9, K10 and K11 against their plain versions on the card on
             the inputs of the whole-recursion engine's first level (an
             eager run) with a row in each tier of the panel, K9 and K10
             under the tier's row mask (K11: its first level), and K12
             on the frontier engine's first level with a permutation chunk
             and its first continuation chunk (the panel's, else bench.py's
             workload's): bit for bit, both times, the bound and its
             share (K11's operations: its erfc calls, each the FP64
             instructions of one call in the SASS of the built library);
             then K10 and K11 on a fully live level of 32 rows (every row
             with a B4 sub-block and live grid points: 32 rows of
             19,000-32,768 bins at 32,768, b their statistic), and the
             earlier designs' times of K10 and K11 (BEFORE_STATS) beside
             this run's, and K9's and K12's before their redesign
             (BEFORE_K9_K12), with K12's layout on each captured call
             beside its earlier one;
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
             ends, in both packages alike);
 12. joint-decode
             the joint multi-sample HMM at whole-genome size: phase
             wgs-partition's coverage as the proband, two parents of fresh
             NB coverage that each carry a seeded half of its events (every
             N-gap), [T, 3] a contig, through
             hmm.segment_coverage_joint_batched on the card (32 lanes x
             524,288 bins x 5 states of emissions, kernels B2, K5, B3 and
             K6): the
             paths equal to the plain decode on the card, the emissions
             equal to the same torch emission computed on the CPU, the
             seconds of the tables (host), the emissions (tables included)
             and the decode, and the share of the proband's event ends
             with a breakpoint within WGS_MISS_BINS;
 13. e2e-joint
             (run after e2e-germline) SmallPedigree-WGS through the CLI
             entry point on phase e2e's trio, twice, each with --device
             cuda and again with --device cpu: (a) the joint multi-sample
             HMM (--custom-parameters "CanvasPartition,-m HMM"), whose one
             decode of the trio is one launch of each of B2, K5, B3 and
             K6, and (b)
             PerSampleHMM with --common-cnvs-bed, one interval over the
             shared chr1 gain from 500 bp into it (called as a forced
             common-CNV set, flagged COMMONCNV): identical VCFs, the
             shared gain and the de novo loss called, the stage times and
             launches of both runs.
 14. e2e-multiprocess
             (run after e2e-germline) Germline-WGS through the CLI entry
             point in 2 processes of one gloo group (--coordinator
             127.0.0.1:<free port> --num-processes 2 --process-id i
             --device cuda), both on cuda:0, each with its own -o: each
             scans its contig_shards half of the proband's BAM, the read
             starts are all-gathered, and both VCFs equal phase
             e2e-germline's cuda VCF; each process's contigs, stage seconds
             and launches; the processes are joined within MP_JOIN_S;
 15. mesh-decode
             phase wgs-partition's whole-genome coverage through
             hmm.segment_coverage_batched, and phase joint-decode's through
             hmm.segment_coverage_joint_batched, each three times: unsplit
             on cuda:0, lane-split over the virtual mesh [cuda:0] * 4 (8
             lanes a group, 4 launches of each decode kernel) and over the
             visible cards: equal breakpoints, the seconds and launches of
             each run;
 16. bin-mesh
             binning.bin_sample on chr1-chr4 (0.88 Gbp, tracks from
             --seed) round-robin over [cuda:0] * 4, unsplit on cuda:0
             and round-robin over the visible cards: equal bins, the
             seconds and B1's launches of each run;
 17. dryrun  graft_entry.dryrun_multichip(4, devices=[cuda:0] * 4): the
             synthetic full_pipeline_step on the mesh, then the dryrun
             trio's SmallPedigree-WGS on the mesh and with
             CANVAS_TPU_FORCE_SINGLE_DEVICE=1, equal VCFs; then
             graft_entry.entry()'s step once on the card, equal to the
             same step on the CPU;
 18. gather  parallel.distributed.all_gather_host_data in 2 gloo processes
             at whole-genome size (the 24 hg38 contig lengths of seeded
             uint8, 3.1 GB a process, each process owning its
             contig_shards half): the result equal to the full data in
             both, the seconds and bytes; the host's RAM first (under 32
             GB, only the longest contigs that fit, listed in the line).
Phases 14-18 carry the device count and the mesh they used; with one
card, the visible-cards runs are unsplit and every other mesh repeats
cuda:0.

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
import re
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
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
# chunk counts a sequence at which phase B2/B3 times K5 and K6
SCAN_CHUNKS = (256, 512, 1024, 2048, 4096, 8192)

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

KERNEL_SOURCES = ("prefix_scan", "viterbi", "arc_scan", "cbs_mega",
                  "cbs_stats", "cbs_level")
# the decode's kernels, by their launch counts' names: B2, K5, B3, K6
DECODE_KERNELS = ("chunk_matrix", "chunk_scan", "forward_backtrack",
                  "chunk_chase")
# the CBS engines' kernels, by their launch counts' names: the whole-
# recursion engine's K9, B4, K10, K11 carrying K14, K7, K8, K13, K15's
# set-up and K15's keep flags with K16; the frontier engine's K9, B4, K10,
# K11 and K12
MEGA_KERNELS = ("arc_inputs", "arc_scan", "refine", "tail_decide", "walk",
                "edge", "prologue", "edge_setup", "keep_table")
FRONTIER_KERNELS = ("arc_inputs", "arc_scan", "refine", "tail_p", "perm")
# the CBS kernels' launch counts' names, each with the kernel functions
# the card runs for one counted launch (B4's second kernel, arc_scan_replay,
# is left out: the captured level's graph nodes account for it)
KERNEL_FUNCTIONS = {"arc_inputs": ("arc_inputs_kernel",),
                    "arc_scan": ("arc_scan_blocks",),
                    "refine": ("refine_kernel",), "tail_p": ("tail_kernel",),
                    "tail_decide": ("tail_decide_kernel",),
                    "walk": ("walk_kernel",), "edge": ("edge_kernel",),
                    "perm": ("perm_kernel",),
                    "prologue": ("prologue_rows_kernel",
                                 "prologue_tile_kernel"),
                    "edge_setup": ("edge_setup_kernel",),
                    "keep_table": ("keep_table_kernel",)}

# NVIDIA H100 SXM peaks (data sheet, 700 W): device memory, and f32 outside
# the tensor cores.  The f32 peak counts an FMA as two operations; the
# kernels' adds, subtractions, multiplications and maxima are none, and
# each takes an FMA's issue slot, so it counts as two of F32_OPS.
HBM_BPS = 3.35e12
F32_OPS = 67e12
FLOPS_PER_OP = 2
# K7 and K8's integer operations also count an FMA's issue slot each (the
# card has half as many int32 lanes, so the bound is a low one): a
# Threefry-2x32 draw is 73 of them (20 rounds of an add, a rotation and an
# exclusive or, 12 key additions, the final exclusive or)
TF_OPS = 73
P_CHUNK = 512
# float64 outside the tensor cores (data sheet, H100 SXM): an FMA counts as
# two, and every FP64 instruction takes an FMA's issue slot
F64_OPS = 34e12

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
# the phases with more than one device: the virtual mesh's size, the
# processes' join limit (seconds) and bin-mesh's contigs
MESH_N = 4
MP_JOIN_S = 300
BIN_MESH_CONTIGS = 4


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


FP64_OPCODES = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX", "DSET",
                 "MUFU.RCP64H", "MUFU.RSQ64H")


def sass_fp64(lib: Path, kernel: str) -> dict:
    """The FP64 instructions of `kernel` in cuobjdump -sass of the library
    lib, every branch counted once."""
    import collections
    import re
    import shutil

    from canvas_tpu_torch.ops import cuda_lib

    tool = shutil.which("cuobjdump") or str(
        Path(cuda_lib.nvcc_path()).parent / "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        fail(f"cuobjdump of {lib.name}: {res.stderr[-400:]}")
    funcs = re.split(r"\n\s*Function : ", res.stdout)
    body = next((f for f in funcs if kernel in f.split("\n")[0]), None)
    if body is None:
        fail(f"{kernel} not in the SASS of {lib.name}")
    ops = collections.Counter(
        m.group(2) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)", body))
    fp64 = {op: c for op, c in ops.items()
            if op.startswith(FP64_OPCODES)}
    if not fp64:
        fail(f"no FP64 instruction in the SASS of {kernel}")
    return {"fp64_instructions": sum(fp64.values()), "by_opcode": fp64}


def erfc_sass() -> dict:
    """The FP64 instructions of one call of the math library's erfc, as
    kernel K11 calls it: those of cbs_stats's erfc_kernel (one erfc and a
    load and a store)."""
    from canvas_tpu_torch.ops import cuda_lib

    return sass_fp64(cuda_lib.BUILD_DIR / "libcbs_stats.so", "erfc_kernel")


# K11's series term as its earlier design computed it (sqrt(k) and 2 / k
# each term, the division by 2 a division), built only to count its FP64
# instructions in the SASS beside the committed kernel's series_term_kernel
BEFORE_TERM_CU = r"""
#include <cuda_runtime.h>
namespace {
__global__ void series_term_kernel(const double* x, double* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) {
    const double kd = double(i % 8192 + 1);
    const double z = __ddiv_rn(__ddiv_rn(__dmul_rn(x[i], sqrt(kd)), 2.0),
                               1.4142135623730951);
    out[i] = __dmul_rn(__dmul_rn(erfc(z), 0.5), __ddiv_rn(2.0, kd));
  }
}
}  // namespace
extern "C" int series_term_before(const void* x, void* out, int count,
                                void* stream) {
  series_term_kernel<<<(count + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), count);
  return static_cast<int>(cudaGetLastError());
}
"""
BEFORE_TERM = "series_term_before"


def before_term_source() -> Path:
    from canvas_tpu_torch.ops import cuda_lib

    src = cuda_lib.BUILD_DIR / "variants" / f"{BEFORE_TERM}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(BEFORE_TERM_CU)
    return src


def term_sass(erfc: dict) -> dict:
    """The FP64 instructions of one series term of K11 (cbs_stats's
    series_term_kernel, sqrt(k) and 2 / k from the table) and of its
    earlier form (BEFORE_TERM_CU), each with its count less erfc's."""
    from canvas_tpu_torch.ops import cuda_lib

    now = sass_fp64(cuda_lib.BUILD_DIR / "libcbs_stats.so",
                    "series_term_kernel")
    then = sass_fp64(cuda_lib.BUILD_DIR / f"lib{BEFORE_TERM}.so",
                     "series_term_kernel")
    e = erfc["fp64_instructions"]
    return {"now": dict(now, besides_erfc=now["fp64_instructions"] - e),
            "before": dict(then, besides_erfc=then["fp64_instructions"] - e)}


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
    # one nvcc per source, all started together (and the earlier series
    # term, for its SASS)
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as ex:
        jobs = [ex.submit(cuda_lib.build, name) for name in KERNEL_SOURCES]
        jobs.append(ex.submit(cuda_lib.build, BEFORE_TERM,
                              before_term_source()))
        for job in jobs:
            job.result()
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
    from canvas_tpu_torch.ops import cbs_mega_cuda

    # K7 and K8 take all their shared memory dynamically (ptxas reports
    # none): how a launch works a row of each tier width (K8: a subset
    # above 32), in groups of a block and where its buffers live
    layouts = {name: {1 << k: cbs_mega_cuda.layout(1 << k, edge)
                      for k in range(10, 17)}
               for name, edge in (("walk", False), ("edge", True))}
    for k in range(3, 17):
        for edge in (False, True):
            if cbs_mega_cuda.device_layout(1 << k, edge) \
                    != cbs_mega_cuda.layout(1 << k, edge):
                fail(f"K7/K8's layout at {1 << k} differs from its mirror")
    erfc = erfc_sass()
    return {"phase": "build", "seconds": secs, "native_seconds": native_s,
            "ptxas": ptxas_report(), "b4_interior_run": sass,
            "k11_erfc": erfc, "k11_series_term": term_sass(erfc),
            "k7_k8_layouts": layouts, "k12_layouts": k12_layouts(),
            "gpu": gpu_line()}


def k12_before_layout(npad: int) -> dict:
    """K12's layout before its redesign: K7's groups of the width
    whatever the launch's items, two buffers only where K7's slice of
    them had room (else the scatter drew each key again)."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    lay = mc.layout(npad, False)
    slice_ = (mc._BUDGET // lay["groups"]) & ~15
    two = npad < mc.SLAB_TIER and mc._double_bytes(npad) <= slice_
    return {"groups": lay["groups"],
            "buffers": "shared, two buffers" if two else lay["buffers"],
            "draws_a_position": 1 if two else 2}


def k12_layouts() -> dict:
    """K12's groups a block, buffers and cipher calls a position at each
    bucket width for one row under the mask (P 768 and 512) and for 1,024
    rows at P 768, on this card's grid, beside the earlier one; the card's own
    rule (cbs_perm_layout) must equal the mirror (perm_layout)."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    grid = mc.perm_grid(torch.device("cuda", torch.cuda.current_device()))
    out = {"grid": grid}
    for k in range(3, 17):
        npad = 1 << k
        row = {}
        for items in (768, 512, 1024 * 768):
            mirror = mc.perm_layout(npad, items, grid)
            card = mc.device_perm_layout(npad, items, grid)
            if any(card[key] != mirror[key] for key in card):
                fail(f"K12's layout at {npad}, {items} items: {card} on the "
                     f"card, {mirror} in the mirror")
            row[str(items)] = [mirror["groups"], mirror["buffers"],
                               mirror["draws_a_position"]]
        before = k12_before_layout(npad)
        row["before"] = [before["groups"], before["buffers"],
                         before["draws_a_position"]]
        out[str(npad)] = row
    return out


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
    return log_em, mask, hmm._lane_lengths(live, lengths, log_em.shape[0]), \
        lt, li


def phase_b2_b3(seed: int, dev: torch.device) -> tuple[dict, ...]:
    from canvas_tpu_torch.ops import hmm
    from canvas_tpu_torch.ops import viterbi_cuda as vc

    log_em, mask, rows, lt, li = decode_inputs(seed, dev)
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
    # K5 and K6 against their plain versions, on B2's chunk matrices and
    # on B3's prev_end from K5's start scores
    mats = vc.chunk_matrices(em, base, lane_len, lt, li)
    ss5, last5 = vc.chunk_scan(mats, B)
    torch.cuda.synchronize()
    ss5_p, last5_p = vc.chunk_scan_plain(mats, B)
    k5_err = float((ss5 - ss5_p).abs().max())
    if not (torch.equal(ss5.view(torch.int32), ss5_p.view(torch.int32))
            and torch.equal(last5, last5_p)):
        fail(f"K5 differs from its plain version (max |diff| {k5_err}, "
             f"last end states equal: {torch.equal(last5, last5_p)})")
    del ss5_p
    _, pe6 = vc.forward_backtrack(em, base, lane_len, ss5, lt, li)
    sel6 = vc.chunk_chase(pe6, last5)
    torch.cuda.synchronize()
    sel6_p = vc.chunk_chase_plain(pe6, last5)
    k6_err = int((sel6 - sel6_p).abs().max())
    if k6_err:
        fail(f"K6 differs from its plain version (max |diff| {k6_err})")
    # the whole decode, kernels against plain versions, and its
    # synchronising calls (none: a fixed sequence of launches)
    path_k, dec_syncs = count_syncs(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                           lengths=rows))
    if dec_syncs:
        fail(f"the decode made {dec_syncs} synchronising calls, not 0")
    path_p = hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                        plain=True, lengths=rows)
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
    k5_ms = cuda_ms(lambda: vc.chunk_scan(mats, B), 20, queued=True)
    k5_plain = cuda_ms(lambda: vc.chunk_scan_plain(mats, B), 2)
    k6_ms = cuda_ms(lambda: vc.chunk_chase(pe6, last5), 20, queued=True)
    k6_plain = cuda_ms(lambda: vc.chunk_chase_plain(pe6, last5), 5)
    # K5 and K6 at B sequences of 256 to 8,192 chunks (random inputs):
    # the part of the time that grows with the chunks is the levels' work,
    # the rest (about log2 n levels, each a barrier) their latency
    scaling = {}
    gen = torch.Generator(dev).manual_seed(seed + 5)
    for n in SCAN_CHUNKS:
        m = torch.randn((S, S, B * n), generator=gen, device=dev) * 30.0
        p6 = torch.randint(0, S, (S, B * n), generator=gen, device=dev,
                           dtype=torch.int8)
        l6 = torch.randint(0, S, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
        scaling[n] = (cuda_ms(lambda: vc.chunk_scan(m, B), 20, queued=True),
                      cuda_ms(lambda: vc.chunk_chase(p6, l6), 20,
                              queued=True))
    del m, p6, l6
    dec_ms = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                           lengths=rows), 5)
    dec_queued_ms = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                           lengths=rows), 5, queued=True)
    dec_plain = cuda_ms(
        lambda: hmm.viterbi_decode_chunked(log_em, mask, lt, li, chunk=CHUNK,
                                           plain=True, lengths=rows), 1)
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
    # K5 reads the f32 [S, S, L] matrices, writes the f32 [S, L] start
    # scores and B int32 end states; the tree's (max,+) products
    # (scan_combines, about two a chunk) of 25 entries of 5 adds and 4
    # maxima, 225 operations, and each chunk's 5 end scores of 4 maxima
    k5_bytes = 4 * S * S * L + 4 * S * L + 4 * B
    k5_ops = B * (225 * vc.scan_combines(nC) + 20 * nC)
    k5_bound, k5_by = bound(k5_bytes, k5_ops)
    # K6 reads the int8 [S, L] prev_end and B int32 end states and writes
    # L int64 selectors; one dependent select a chunk
    k6_bytes = S * L + 4 * B + 8 * L
    k6_bound, k6_by = bound(k6_bytes, L)
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
          "decode_ms": dec_ms, "decode_queued_ms": dec_queued_ms,
          "decode_plain_ms": dec_plain, "decode_syncs": dec_syncs,
          "non_diploid_bins": called}
    k5 = {"phase": "K5", "shape": shape, "sequences": B, "chunks": nC,
          "lanes": L, "equal": True, "max_abs_err": k5_err,
          "combines": vc.scan_combines(nC), "operations": k5_ops,
          "ms": k5_ms, "plain_ms": k5_plain, "library_ms": None,
          "bytes": k5_bytes, "bound_ms": k5_bound, "bound_by": k5_by,
          "bound_share": k5_bound / k5_ms,
          "ms_by_chunks": {n: ms[0] for n, ms in scaling.items()}}
    k6 = {"phase": "K6", "shape": shape, "sequences": B, "chunks": nC,
          "lanes": L, "equal": True, "max_abs_err": k6_err,
          "ms": k6_ms, "plain_ms": k6_plain, "library_ms": None,
          "bytes": k6_bytes, "bound_ms": k6_bound, "bound_by": k6_by,
          "bound_share": k6_bound / k6_ms,
          "ms_by_chunks": {n: ms[1] for n, ms in scaling.items()}}
    return b2, b3, k5, k6


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
    from canvas_tpu_torch.ops import viterbi_cuda
    from canvas_tpu_torch.pipeline import cli

    runs = {}
    for dev in ("cuda", "cpu"):
        out = Path(f"{out_prefix}_{dev}")
        if dev == "cuda":
            reset_launches()
            grid0 = dict(somatic_grid.CALLS)
            chains0 = dict(viterbi_cuda.CHAINS)
        t0 = time.perf_counter()
        rc = cli.main([*args, "-o", str(out), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
            grid = {k: v - grid0[k] for k, v in somatic_grid.CALLS.items()}
            chains = {k: v - chains0[k]
                      for k, v in viterbi_cuda.CHAINS.items()}
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"{args[0]} on {dev} exited {rc}")
        runs[dev] = {"wall_s": wall, "out": out,
                     "stages": profile_stages(out / profile)}
    return {"launches": launches, "grid_calls": grid, "b2_chains": chains,
            **runs}


def same_vcf(a: Path, b: Path) -> None:
    body_a, body_b = vcf_body(a), vcf_body(b)
    if body_a != body_b:
        diff = sorted(set(body_a) ^ set(body_b))
        fail(f"{a.name} differs between --device cuda and --device cpu: "
             f"{diff[:12]}")


def all_launch_counts() -> list[dict]:
    from canvas_tpu_torch.ops import (arc_scan_cuda, cbs_level_cuda,
                                      cbs_mega_cuda, cbs_stats_cuda,
                                      prefix_cuda, viterbi_cuda)

    return [prefix_cuda.LAUNCHES, viterbi_cuda.LAUNCHES,
            arc_scan_cuda.LAUNCHES, cbs_mega_cuda.LAUNCHES,
            cbs_stats_cuda.LAUNCHES, cbs_level_cuda.LAUNCHES]


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
            **{k: n_samples for k in DECODE_KERNELS}}
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


def b4_case(cs, n, npad: int, al0: int = 2, mask=None) -> dict:
    """B4 on the card against its plain version on the card for the rows
    cs f32 [B, npad] of lengths n (with mask, the rows under it; the
    kernel's other rows return at once): best bit for bit and bl0 equal
    (else the smoke fails), the blocks and pair terms of the plain walk,
    both times and the bound.  Returns the numbers and the kernel's
    inputs."""
    from canvas_tpu_torch.ops import arc_scan_cuda as ac
    from canvas_tpu_torch.ops import cbs_device as cd

    B = cs.shape[0]
    seed_v, lag_hi, psd2, _ti0, _tj0 = cd.arc_scan_inputs(cs, n, npad, al0)
    args = (cs, n.to(torch.int32), lag_hi, seed_v, psd2, al0)
    rows = slice(None) if mask is None else torch.nonzero(mask)[:, 0]
    plain_args = (*(a[rows] for a in args[:5]), al0)
    best_k, bl0_k = ac.arc_scan(*args, mask=mask)
    best_k, bl0_k = best_k[rows], bl0_k[rows]
    torch.cuda.synchronize()
    walk: dict = {"blocks": 0, "terms": 0}
    best_p, bl0_p = ac.arc_scan_plain(*plain_args, count=walk)
    torch.cuda.synchronize()
    bits_equal = torch.equal(best_k.view(torch.int32),
                             best_p.view(torch.int32))
    err = float((best_k - best_p).abs().max())
    if not bits_equal or not torch.equal(bl0_k, bl0_p):
        fail(f"B4 differs from its plain version at {B} x {npad}: "
             f"max |best diff| {err}, bl0 {bl0_k.tolist()} vs "
             f"{bl0_p.tolist()}")
    # the walk's pair terms, each a subtraction and a maximum of |d|
    # (w is factored out of the maximum over positions, once a lag);
    # cs, psd2 and the four [B] vectors read once
    Bm = best_p.shape[0]
    b4_bound, b4_by = bound(4 * (Bm * npad + Bm * psd2.shape[1] + 4 * Bm),
                            2 * walk["terms"])
    ms = cuda_ms(lambda: ac.arc_scan(*args, mask=mask), reps=20, queued=True)
    plain_ms = cuda_ms(lambda: ac.arc_scan_plain(*plain_args), reps=2)
    return {"segments": B, "masked": Bm, "npad": npad,
            "blocks": Bm * psd2.shape[1],
            "blocks_visited": walk["blocks"],
            "hits": int((bl0_k >= 0).sum()), "equal": True,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            "pairs_dense": int(B * npad * (npad - 1) // 2),
            "pair_terms": walk["terms"], "bound_ms": b4_bound,
            "bound_by": b4_by, "bound_share": b4_bound / ms}


def b4_tier_rows(rng, npad: int, dev: torch.device, W: int = 32,
                 rows=(0, 7, 31)):
    """B4's input as the whole-recursion engine gives it at tier npad:
    W rows, those in `rows` of the tier (lengths in (npad/2, npad], noise
    with a step) under the mask, the others zeroed (n = 2).  (cs f32
    [W, npad], n int64, mask) on dev."""
    cs = np.zeros((W, npad), np.float32)
    n = np.full(W, 2, np.int64)
    mask = np.zeros(W, bool)
    for r in rows:
        L = int(rng.integers(npad // 2 + 1, npad + 1))
        x = rng.normal(0, 1, L)
        x[L // 3:L // 2] += 0.5
        x -= x.mean()
        cs[r, :L] = np.cumsum(x)
        n[r] = L
        mask[r] = True
    return (torch.as_tensor(cs, device=dev), torch.as_tensor(n, device=dev),
            torch.as_tensor(mask, device=dev))


def phase_b4(seed: int, dev: torch.device) -> dict:
    """B4 at the frontier shapes, against its plain version on the card."""
    from canvas_tpu_torch.ops import cbs_device as cd

    al0 = 2
    shapes = []
    for B, npad, length in B4_SHAPES:
        cs, n, tss = b4_inputs(seed + npad, B, npad, length, dev)
        res = b4_case(cs, n, npad, al0)
        # t2/ti/tj through tmax_batch: kernel on the card, plain on the CPU
        t_k = cd.tmax_batch(cs, n, tss, npad, al0)
        t_p = cd.tmax_batch(cs.cpu(), n.cpu(), tss.cpu(), npad, al0)
        for name, a, b in zip(("t2", "ti", "tj"), t_k, t_p):
            if not torch.equal(a.cpu(), b):
                fail(f"tmax_batch {name} differs between B4 and its plain "
                     f"version at {B} x {npad}")
        res["tmax_batch_ms"] = cuda_ms(
            lambda: cd.tmax_batch(cs, n, tss, npad, al0), reps=10)
        shapes.append(res)
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
    """Tumor-normal-enrichment through the CLI on cuda and on cpu: equal
    VCF bodies, the planted events called, the whole-recursion CBS engine
    on cuda.  The CUDA run is traced (torch.profiler, the card's activity
    only): its CBS kernels' launches are the runs the trace shows on the
    card, which must equal the launches the wrappers and the engine's
    graph replays counted."""
    from torch.profiler import ProfilerActivity, profile

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
        tracer = profile(activities=[ProfilerActivity.CUDA]) \
            if dev == "cuda" else nullcontext()
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_launches()
        with tracer:
            t0 = time.perf_counter()
            rc = cli.main([*args, "-o", str(out), "--device", dev])
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_launches()
            wall = time.perf_counter() - t0
        if dev == "cuda":
            traced = kernel_runs(tracer.key_averages())
        if rc != 0:
            fail(f"Tumor-normal-enrichment on {dev} exited {rc}")
        prof = json.loads((out / "tumor_profile.json").read_text())
        note = [st for st in prof["stages"]
                if st["name"] == "CanvasPartitionCbsEngine"]
        runs[dev] = {"wall_s": wall,
                     "stages": {st["name"]: st["seconds"]
                                for st in prof["stages"] if "seconds" in st},
                     "cbs": note[0] if note else None}
    if (runs["cuda"]["cbs"] or {}).get("cbs_engine") != "mega":
        fail(f"the CUDA run did not take the whole-recursion CBS engine: "
             f"{runs['cuda']['cbs']}")
    if (runs["cpu"]["cbs"] or {}).get("cbs_engine") != "host":
        fail(f"the CPU run did not take the host CBS engine: "
             f"{runs['cpu']['cbs']}")
    n_levels = runs["cuda"]["cbs"]["frontier_levels"]
    traced_equals_counted(traced, launches, MEGA_KERNELS,
                          "Tumor-normal-enrichment on cuda")
    if launches["arc_scan"] < 1:
        fail(f"B4 launched {launches['arc_scan']} times over {n_levels} "
             f"levels of the whole-recursion engine")
    if min(launches["walk"], launches["edge"],
           launches["tail_decide"]) < max(n_levels, 1):
        fail(f"K7, K8 and K11 (carrying K14) launched {launches['walk']}, "
             f"{launches['edge']} and {launches['tail_decide']} times over "
             f"{n_levels} levels")
    if min(launches["arc_inputs"], launches["refine"]) < 1:
        fail(f"K9 and K10 launched {launches['arc_inputs']} and "
             f"{launches['refine']} times in the whole-recursion engine")
    level = {k: launches[k] for k in ("prologue", "edge_setup",
                                      "keep_table")}
    if min(level.values()) < max(n_levels, 1):
        fail(f"K13, K15 and K16 (with K15's keep flags) launched {level} "
             f"times over {n_levels} levels")
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
            "launches": launches, "traced_launches": traced,
            "mega_levels": n_levels, "events": calls,
            "cuda": runs["cuda"], "cpu": runs["cpu"]}, panel


def panel_coverage(workdir: Path) -> dict:
    """The panel's tumor ratio coverage: the CUDA run's CanvasClean
    output, by contig."""
    from canvas_tpu_torch.genome.contigs import ContigTable
    from canvas_tpu_torch.io.bins import BinSet
    from canvas_tpu_torch.pipeline.runner import coverage_by_contig

    contigs = ContigTable(tuple(ENR_CONTIGS), tuple(ENR_CONTIGS.values()))
    bins = BinSet.read_text(
        workdir / "enr_cuda" / "Checkpoints" / "CanvasClean_tumor.cleaned.gz",
        contigs)
    return coverage_by_contig(bins)


def eager_mega(cov: dict, dev: torch.device, **kw):
    """run_cbs_mega over cov on the card with its levels run eagerly, each
    wrapper called from Python (the engine's _mega_recurse bound with
    graph=False for the call): the recorders below see every level's
    inputs, and plain versions that read from the card can stand in."""
    import functools

    from canvas_tpu_torch.ops import cbs_mega

    orig = cbs_mega._mega_recurse
    cbs_mega._mega_recurse = functools.partial(orig, graph=False)
    try:
        return cbs_mega.run_cbs_mega(cov, device=dev, **kw)
    finally:
        cbs_mega._mega_recurse = orig


def count_syncs(fn):
    """(fn(), the synchronising CUDA calls it made, as CUDA's sync debug
    mode reports them)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def frontier_plain(run):
    """run() with the frontier engine's five kernels replaced by their plain
    versions (on whatever tensors it is given)."""
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_mega_cuda
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    # the frontier passes no row mask, output or live flag (None each)
    swaps = [(st, "arc_inputs", lambda cs, n, npad, al0, **_none: (
                 *st.arc_scan_inputs_plain(cs, n, npad, al0),
                 n.to(torch.int32))),
             (arc_scan_cuda, "arc_scan",
              lambda *a, **_none: arc_scan_cuda.arc_scan_plain(*a)),
             (st, "refine", lambda *a, **_none: st.refine_plain(*a)),
             (st, "tail_p", lambda *a, **_none: st.tail_p_plain(*a)),
             (cbs_mega_cuda, "perm_stats", cbs_mega_cuda.perm_stats_plain)]
    orig = [getattr(mod, name) for mod, name, _fn in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        return run()
    finally:
        for (mod, name, _fn), fn in zip(swaps, orig):
            setattr(mod, name, fn)


def frontier_bench(cov: dict, dev: torch.device) -> dict:
    """bench.py's CBS workload through the frontier engine on cuda: its
    seconds and launches (best of 3 after a warm run), one run under
    torch.profiler, and a run with the five kernels' plain versions on the
    same CUDA tensors, whose segments must be equal."""
    from canvas_tpu_torch.ops import cbs_device

    warm = cbs_device.run_cbs_device(cov, device=dev)
    runs = []
    for _ in range(3):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lens = cbs_device.run_cbs_device(cov, device=dev)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "launches": {k: read_launches()[k]
                                  for k in FRONTIER_KERNELS}})
        for c in cov:
            if not np.array_equal(lens[c], warm[c]):
                fail(f"the frontier engine gave other segments on {c} than "
                     f"its warm run")
    traced = trace_cbs(lambda: cbs_device.run_cbs_device(cov, device=dev))
    t0 = time.perf_counter()
    plain = frontier_plain(lambda: cbs_device.run_cbs_device(cov, device=dev))
    plain_s = time.perf_counter() - t0
    for c in cov:
        if not np.array_equal(plain[c], warm[c]):
            fail(f"frontier segments on {c} differ between the kernels and "
                 f"their plain versions: {warm[c].tolist()} vs "
                 f"{plain[c].tolist()}")
    best = min(runs, key=lambda r: r["seconds"])
    return {"contigs": len(cov), "bins": sum(len(v) for v in cov.values()),
            "segments": sum(len(v) for v in warm.values()),
            "best_of_3_s": best["seconds"],
            "seconds": [r["seconds"] for r in runs],
            "launches": best["launches"], "plain_kernels_s": plain_s,
            "equal_to_plain_kernels": True,
            "profiled_cuda": traced["profile"]}


def k12_census(run) -> dict:
    """K12 over one frontier run, run(): its calls by (width, rows under
    the mask, P), the launches, how many had a row under the mask (each
    mask read on the host before its call), and the kernel's device time
    summed from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    orig = mc.perm_stats
    calls: list = []

    def counted(*args, **kw):
        calls.append((int(args[0].shape[1]), int(args[4].sum()),
                      int(args[6])))
        return orig(*args, **kw)

    launches0 = mc.LAUNCHES["perm"]
    mc.perm_stats = counted
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        mc.perm_stats = orig
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and "perm_kernel" in ev.key]
    shapes: dict = {}
    for npad, rows, P in calls:
        key = f"{npad}x{rows}x{P}"
        shapes[key] = shapes.get(key, 0) + 1
    return {"calls": len(calls), "launches": mc.LAUNCHES["perm"] - launches0,
            "with_a_masked_row": sum(rows > 0 for _n, rows, _p in calls),
            "device_ms": sum(ev.self_device_time_total for ev in events)
            / 1e3,
            "kernels_profiled": sum(ev.count for ev in events),
            "by_width_rows_P": shapes}


def phase_cbs(workdir: Path, dev: torch.device) -> dict:
    """The frontier engine on the panel's tumor ratio coverage, on CUDA
    tensors and on CPU tensors; then on bench.py's CBS workload."""
    from canvas_tpu_torch.ops import arc_scan_cuda, cbs_device

    cov = panel_coverage(workdir)
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        levels: list[dict] = []
        reset_launches()
        t0 = time.perf_counter()
        lens = cbs_device.run_cbs_device(cov, device=d, levels=levels)
        if d.type == "cuda":
            torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "arc_scan_launches": arc_scan_cuda.LAUNCHES["arc_scan"],
                     "launches": {k: read_launches()[k]
                                  for k in FRONTIER_KERNELS},
                     "levels": levels, "lengths": lens}
    for c in cov:
        if not np.array_equal(out["cuda"]["lengths"][c],
                              out["cpu"]["lengths"][c]):
            fail(f"frontier segments on {c} differ between CUDA and CPU "
                 f"tensors: {out['cuda']['lengths'][c].tolist()} vs "
                 f"{out['cpu']['lengths'][c].tolist()}")
    if out["cuda"]["arc_scan_launches"] < len(out["cuda"]["levels"]):
        fail("B4 launched fewer times than the engine ran levels")
    if min(out["cuda"]["launches"].values()) < 1:
        fail(f"a kernel of the frontier engine did not launch: "
             f"{out['cuda']['launches']}")
    traced = trace_cbs(lambda: cbs_device.run_cbs_device(cov, device=dev))
    if traced["lengths"] != {c: v.tolist()
                             for c, v in out["cuda"]["lengths"].items()}:
        fail("the profiled frontier run gave other segments")
    traced_equals_counted(traced["traced_launches"],
                          traced["counted_launches"], FRONTIER_KERNELS,
                          "the frontier engine on the panel")
    _lens, syncs = count_syncs(
        lambda: cbs_device.run_cbs_device(cov, device=dev))
    bench_cov = bench_cbs_coverage()
    bench = frontier_bench(bench_cov, dev)
    census = {"panel": k12_census(
                  lambda: cbs_device.run_cbs_device(cov, device=dev)),
              "bench_cbs": k12_census(
                  lambda: cbs_device.run_cbs_device(bench_cov, device=dev))}
    return {"phase": "CBS", "bins": {c: len(v) for c, v in cov.items()},
            "k12": census,
            "segments": {c: len(v) for c, v in out["cuda"]["lengths"].items()},
            "lengths_equal": True,
            "n_levels": len(out["cuda"]["levels"]),
            "cuda_s": out["cuda"]["seconds"], "cpu_s": out["cpu"]["seconds"],
            "arc_scan_launches": out["cuda"]["arc_scan_launches"],
            "launches": out["cuda"]["launches"],
            "cuda_syncs": syncs,
            "levels_cuda": out["cuda"]["levels"],
            "levels_cpu": out["cpu"]["levels"],
            "profiled_cuda": traced["profile"], "bench_cbs": bench}


def kernel_runs(stats) -> dict:
    """The CBS kernels the card ran in a trace (torch.profiler's
    key_averages), counted by their launch counts' names
    (KERNEL_FUNCTIONS): one for each run of a kernel function, whether a
    wrapper or a CUDA graph's replay launched it."""
    import re

    from torch.autograd import DeviceType

    pats = {k: re.compile(r"(^|[\s:])(" + "|".join(fns) + r")\(")
            for k, fns in KERNEL_FUNCTIONS.items()}
    out = dict.fromkeys(KERNEL_FUNCTIONS, 0)
    for ev in stats:
        if ev.device_type != DeviceType.CUDA:
            continue
        for k, pat in pats.items():
            if pat.search(ev.key):
                out[k] += ev.count
    return out


def traced_equals_counted(traced: dict, counted: dict, names, what: str):
    """Fail unless, for each launch count in names, the kernels the trace
    shows on the card equal the launches the wrappers and replays counted,
    and at least one ran."""
    bad = {k: (traced[k], counted[k]) for k in names
           if traced[k] != counted[k] or traced[k] < 1}
    if bad:
        fail(f"{what}: kernels on the card (traced) against launches "
             f"counted, by kernel: {bad}")


def trace_cbs(run) -> dict:
    """One more CBS run, run(), on CUDA tensors under torch.profiler (the
    card's activity only; host operators are not recorded, which keeps the
    trace's processing short): its wall seconds, the device time of its
    kernels and copies (the events on the card, summed: its busy time on
    one stream), B4's part of it, its kernel launches (the CUDA runtime's
    launch calls), the kernels the card ran, and the CBS kernels' runs on
    the card (kernel_runs) beside the launches counted in that run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lens = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = read_launches()
    stats = prof.key_averages()
    trace_s = time.perf_counter() - t0
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
                                 "cudaLaunchKernelExC",
                                 "cudaLaunchCooperativeKernel"))
    graph_launches = sum(ev.count for ev in stats
                         if ev.key in ("cudaGraphLaunch", "cuGraphLaunch"))
    kernels = sum(n for _us, k, n in top
                  if not k.startswith(("Memcpy", "Memset")))
    top.sort(reverse=True)
    by_kernel: dict = {}
    for us, k, n in top:
        name = re.search(r"(\w+)\(", k)
        name = name.group(1) if name else k[:40]
        ms, count = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + us / 1e3, count + n)
    return {"lengths": {c: v.tolist() for c, v in lens.items()},
            "traced_launches": kernel_runs(stats),
            "counted_launches": {k: counted[k] for k in KERNEL_FUNCTIONS},
            "profile": {
                "wall_s": wall, "with_processing_s": trace_s,
                "device_busy_s": device_us / 1e6,
                "busy_share": device_us / 1e6 / wall,
                "b4_device_s": b4_us / 1e6,
                "b4_share_of_busy": b4_us / device_us if device_us else None,
                "kernel_launches": launches,
                "graph_launches": graph_launches, "device_kernels": kernels,
                "top_device": [{"name": k[:80], "ms": us / 1e3, "count": n}
                               for us, k, n in top[:8]],
                "device_ms_by_kernel": {k: {"ms": ms, "count": n} for k, (
                    ms, n) in by_kernel.items()}}}


def mega_host_calls(run) -> dict:
    """The CUDA runtime and driver calls the host made during run(), a
    whole-recursion engine run on the card, by name (torch.profiler's
    CPU-side events of the cuda* and cu* API): graph launches, kernel
    launches, copies, memsets, synchronisations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    calls: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and ev.key.startswith("cu") \
                and not ev.key.startswith("cudaGetDevice"):
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    return {"total": sum(calls.values()), "by_call": calls}


def engine_figures(cov: dict, dev: torch.device) -> dict:
    """The whole-recursion engine over cov on the card, its level already
    captured (a warm run first): the capture's seconds and the captured
    level's nodes and kernel launches, then one run's wall, levels,
    replays, reads and kernel launches, and its synchronising calls
    (CUDA's sync debug mode); last, the milliseconds of a replay of the
    captured level after the run's end (live 0: every kernel returns at
    once), over 200 replays."""
    from canvas_tpu_torch.ops import cbs, cbs_level_cuda, cbs_mega

    cbs.run_cbs(cov, device=dev)
    if cbs.last_engine() != "mega":
        fail(f"run_cbs on cuda took the {cbs.last_engine()} engine")
    eng = next(reversed(cbs_mega._ENGINES.values()))
    reset_launches()
    s0 = cbs_mega.SYNCS["cbs_mega"]
    r0 = cbs_mega.GRAPHS["replays"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (lens, wall), hidden = count_syncs(
        lambda: (cbs.run_cbs(cov, device=dev), time.perf_counter() - t0))
    launches = {k: v for k, v in read_launches().items() if k in MEGA_KERNELS}
    if int(eng.tab[3 * eng.S + cbs_level_cuda.LIVE]):
        fail("the engine's live flag is set after its run")
    dead_ms = cuda_ms(eng.graph.replay, reps=200, queued=True)
    return {"lens": lens, "wall_s": wall,
            "levels": cbs._LAST_ENGINE["levels"],
            "replays": cbs_mega.GRAPHS["replays"] - r0,
            "reads": cbs_mega.SYNCS["cbs_mega"] - s0,
            "synchronising_calls": hidden, "launches": launches,
            "capture_s": eng.capture_s, "graph_nodes": eng.nodes,
            "dead_level_replay_ms": dead_ms,
            "launches_a_level": eng.launches_a_level(),
            "tiers": len(eng.tiers)}


def check_engine_figures(fig: dict, traced: dict, what: str) -> None:
    """At most 2 reads a run, nothing else synchronising besides the four
    set-up copies, a replay for every level; the captured level's kernel
    nodes are its counted launches and B4's second kernel a tier, three
    fewer than before K14 rode in K11's launch and K15's keep flags in
    K16's (NODES_BEFORE); in the traced run (trace_cbs) every kernel of
    the level ran on the card, as many times as its launches were
    counted."""
    if fig["reads"] > 2:
        fail(f"{what}: {fig['reads']} reads from the card in a run")
    if fig["synchronising_calls"] != fig["reads"] + 4:
        fail(f"{what}: {fig['synchronising_calls']} synchronising calls for "
             f"{fig['reads']} reads and 4 set-up copies")
    if not fig["replays"] >= fig["levels"] >= 1:
        fail(f"{what}: {fig['replays']} replays for {fig['levels']} levels")
    nodes = sum(fig["launches_a_level"].values()) + fig["tiers"]
    if fig["graph_nodes"]["kernels"] != nodes:
        fail(f"{what}: the captured level has "
             f"{fig['graph_nodes']['kernels']} kernel nodes, not its "
             f"{nodes} counted launches and B4's second kernels")
    if nodes != NODES_BEFORE[what] - 3:
        fail(f"{what}: {nodes} kernel nodes a level, not "
             f"{NODES_BEFORE[what]} - 3")
    traced_equals_counted(traced["traced_launches"],
                          traced["counted_launches"], MEGA_KERNELS, what)


def capture_kernel_inputs(run) -> dict:
    """The arguments (cloned) of the first K7 call with a walking row and
    of the first K8 call with an active lane during run() (an eager
    engine run), caught by wrapping the two entry points for that run
    only; the engine's live flag is not kept."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    got: dict = {}
    orig = {"walk": mc.walk, "edge_counts": mc.edge_counts}
    live = {"walk": 6, "edge_counts": 5}     # walking / active argument

    def recorder(name):
        def call(*args, **kw):
            if name not in got and bool(args[live[name]].any()):
                got[name] = [a.clone() if torch.is_tensor(a) else a
                             for a in args]
            return orig[name](*args, **kw)
        return call

    mc.walk, mc.edge_counts = recorder("walk"), recorder("edge_counts")
    try:
        run()
    finally:
        mc.walk, mc.edge_counts = orig["walk"], orig["edge_counts"]
    return got


def k7_ops(n, hybrid, chunks, npad, al0=2, kmax=25, n_min=200,
           P=P_CHUNK) -> int:
    """The operations one row's walk needs: per permutation of each chunk,
    n draws of the cipher (TF_OPS each), one operation an element to
    order them and one to add it to the cumsum, and two (a subtraction
    and a |.|-maximum) a term of the statistic: n a lag for the hybrid
    lags al0..min(kmax, npad - 1, n - 1), n - L a lag L for the full
    ones."""
    if hybrid:
        terms = n * max(0, min(kmax, npad - 1, n - 1) - al0 + 1)
    else:
        top = min(n_min, npad)
        hi = min(top - al0, top - 1, n - al0, n - 1)
        terms = sum(n - L for L in range(al0, hi + 1))
    return chunks * P * (n * (TF_OPS + 2) + 2 * terms)


def k7_case(args) -> dict:
    """K7 against its plain version on the card on one level's captured
    inputs: flags and chunk counts equal, chunk 0's statistics bit for
    bit (else the smoke fails), both times, the bound."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    x, n = args[:2]
    walking, hybrid = args[6:8]
    W, Tmax = x.shape
    out = []
    for fn in (mc.walk, mc.walk_plain):
        stats = torch.full((W, mc.P_CHUNK), -1.0, device=x.device)
        acc, chunks = fn(*args, stats=stats)
        torch.cuda.synchronize()
        out.append((acc, chunks, stats))
    (acc_k, ch_k, st_k), (acc_p, ch_p, st_p) = out
    bits = torch.equal(st_k.view(torch.int32), st_p.view(torch.int32))
    err = float((st_k - st_p).abs().max())
    if not (bits and torch.equal(acc_k, acc_p) and torch.equal(ch_k, ch_p)):
        fail(f"K7 differs from its plain version: stats equal {bits} (max "
             f"|diff| {err}), accepted {acc_k.tolist()} vs {acc_p.tolist()},"
             f" chunks {ch_k.tolist()} vs {ch_p.tolist()}")
    rows = torch.nonzero(walking)[:, 0].tolist()
    n_h, hyb_h, ch_h = n.tolist(), hybrid.tolist(), ch_p.tolist()
    ops = sum(k7_ops(n_h[r], hyb_h[r], ch_h[r], mc.tier_width(n_h[r]))
              for r in rows)
    # the walking rows' values read once; the flags and counts written
    k_bound, k_by = bound(4 * Tmax * len(rows) + 64 * W, ops)
    ms = cuda_ms(lambda: mc.walk(*args), reps=5, queued=True)
    plain_ms = cuda_ms(lambda: mc.walk_plain(*args), reps=1)
    return {"rows": W, "Tmax": Tmax, "walking": len(rows),
            "n": [n_h[r] for r in rows], "hybrid": [hyb_h[r] for r in rows],
            "chunks": [ch_h[r] for r in rows],
            "accepted": [bool(acc_p[r]) for r in rows], "equal": True,
            "stats_bits_equal": True, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "operations": ops,
            "bound_ms": k_bound, "bound_by": k_by,
            "bound_share": k_bound / ms}


def k8_case(args) -> dict:
    """K8 against its plain version on the card on one level's captured
    inputs: counts and chunk counts equal, chunk 0's subset sums bit for
    bit, both times, the bound."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    xw, wn, m1, _xbar, _ostat, active = args[:6]
    L, Tmax = xw.shape
    out = []
    for fn in (mc.edge_counts, mc.edge_counts_plain):
        sums = torch.full((L, mc.P_CHUNK), -1.0, device=xw.device)
        count, cnt = fn(*args, sums=sums)
        torch.cuda.synchronize()
        out.append((count, cnt, sums))
    (c_k, n_k, s_k), (c_p, n_p, s_p) = out
    bits = torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
    err = float((s_k - s_p).abs().max())
    if not (bits and torch.equal(c_k, c_p) and torch.equal(n_k, n_p)):
        fail(f"K8 differs from its plain version: sums equal {bits} (max "
             f"|diff| {err}), count {c_k.tolist()} vs {c_p.tolist()}, cnt "
             f"{n_k.tolist()} vs {n_p.tolist()}")
    lanes = torch.nonzero(active)[:, 0].tolist()
    wn_h, m1_h, cnt_h = wn.tolist(), m1.tolist(), n_p.tolist()
    # per permutation of each chunk: wn draws, one operation an element
    # to select the m1-th key and one to test and add it
    ops = sum(cnt_h[r] * mc.P_CHUNK * wn_h[r] * (TF_OPS + 2)
              for r in lanes)
    k_bound, k_by = bound(4 * Tmax * len(lanes) + 64 * L, ops)
    ms = cuda_ms(lambda: mc.edge_counts(*args), reps=5, queued=True)
    plain_ms = cuda_ms(lambda: mc.edge_counts_plain(*args), reps=1)
    return {"lanes": L, "Tmax": Tmax, "active": len(lanes),
            "wn": [wn_h[r] for r in lanes], "m1": [m1_h[r] for r in lanes],
            "cnt": [cnt_h[r] for r in lanes],
            "count": [int(c_p[r]) for r in lanes], "equal": True,
            "sums_bits_equal": True, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "operations": ops,
            "bound_ms": k_bound, "bound_by": k_by,
            "bound_share": k_bound / ms}


LEVEL_WRAPPERS = ("prologue", "tail_decide", "edge_setup", "keep_table")


def _clone(a):
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, dict):
        return {k: v.clone() for k, v in a.items()}
    return a


def record_levels(run) -> dict:
    """The arguments (cloned) of every call of K13-K16's wrappers during
    run(), an eager whole-recursion engine run on the card, by wrapper."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    recs: dict = {k: [] for k in LEVEL_WRAPPERS}
    orig = {k: getattr(cl, k) for k in LEVEL_WRAPPERS}

    def recorder(name):
        def call(*args):
            recs[name].append([_clone(a) for a in args])
            return orig[name](*args)
        return call

    for k in LEVEL_WRAPPERS:
        setattr(cl, k, recorder(k))
    try:
        run()
    finally:
        for k in LEVEL_WRAPPERS:
            setattr(cl, k, orig[k])
    return recs


def _bits_or_fail(name: str, got: dict, want: dict, level: int) -> None:
    for k, v in want.items():
        if not bits_equal(got[k], v):
            err = float((got[k].double() - v.double()).abs().max()) \
                if got[k].numel() else 0.0
            fail(f"{name} differs from its plain version on level {level}: "
                 f"{k}, max |diff| {err}")


def timed_pair(kernel, plain, n_bytes: float, ops: float, reps: int,
               f64: bool = False) -> dict:
    """kernel() and plain() timed on the card (CUDA events; the kernel's
    launches queued behind a sleep), the bound from n_bytes and ops (f32
    operations, or with f64 FP64 ones) and its share."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = ops * FLOPS_PER_OP / (F64_OPS if f64 else F32_OPS) * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    ms = cuda_ms(kernel, reps=reps, queued=True)
    plain_ms = cuda_ms(plain, reps=2)
    return {"equal": True, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bytes": n_bytes,
            "operations": ops, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms}


def level_kernel_cases(cov: dict, dev: torch.device) -> dict:
    """K13-K16 against their plain versions on the card on every level of
    an eager engine run over cov (each wrapper's recorded inputs; bit for
    bit, else the smoke fails), each timed on the first level's inputs
    beside its plain version, with its bound: K13 the gathered values and
    the x and cumsum rows it writes (bytes) against its float64 operations
    (five a position); K11 carrying K14 beside K11 alone on the same rows
    (K14's added time); K15's set-up; K15's keep flags with K16 on a fresh
    copy of the table each launch."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    recs = record_levels(lambda: eager_mega(cov, dev))
    n_calls = len(recs["prologue"])
    if n_calls < 1 or any(len(v) != n_calls for v in recs.values()):
        fail(f"K13-K16's wrappers called {[len(v) for v in recs.values()]} "
             f"times")
    # a replay batch runs on after the level that ends the run: those
    # levels are dead (live 0), and every kernel must leave them as they
    # are
    dead = [int(tab[3 * pending0.shape[0] + cl.LIVE]) == 0
            for _c, tab, pending0, _lv, _a in recs["prologue"]]
    levels = dead.index(True) if True in dead else n_calls
    if levels < 1 or not all(dead[levels:]):
        fail(f"K13-K16's recorded levels, dead or live: {dead}")

    def check(name, i, lv, want, run):
        if dead[i]:
            before = {k: v.clone() for k, v in lv.items()}
            run()
            torch.cuda.synchronize()
            if any(not torch.equal(before[k], v) for k, v in lv.items()):
                fail(f"{name} wrote on level {i}, after the run's end")
        else:
            run()
            _bits_or_fail(name, lv, want(), i)

    for i, (contigs, tab, pending0, lv, al0) in enumerate(recs["prologue"]):
        check("K13", i, lv, lambda: cl.prologue_plain(
            contigs, tab, pending0, lv["x"].shape[0], al0),
            lambda: cl.prologue(contigs, tab, pending0, lv, al0))
    for i, (tab, S, lv, alpha, kmax, n_grid, n_perm, n_min) in \
            enumerate(recs["tail_decide"]):
        check("K11 with K14", i, lv,
              lambda: cl.tail_decide_plain(lv, alpha, kmax, n_grid,
                                           n_perm, n_min),
              lambda: cl.tail_decide(tab, S, lv, alpha, kmax, n_grid,
                                     n_perm, n_min))
    active = 0
    for i, (tab, S, lv, walked, alpha, n_perm) in \
            enumerate(recs["edge_setup"]):
        check("K15", i, lv, lambda: cl.edge_setup_plain(
            lv["x"], lv["n"], lv["ti"], lv["tj"], lv["trivial"], walked,
            alpha, n_perm, lv["x"].shape[1]),
            lambda: cl.edge_setup(tab, S, lv, walked, alpha, n_perm))
        active += int(lv["active"].sum()) if not dead[i] else 0
    for i, args in enumerate(recs["keep_table"]):
        tab, pending0, lv = args[:3]
        want = ({k: lv[k].clone() for k in ("keep1", "keep2", "echunks")},
                tab.clone(), pending0.clone()) if dead[i] else \
            cl.keep_table_plain(*args)
        cl.keep_table(*args)
        torch.cuda.synchronize()
        _bits_or_fail("K15's keep with K16", lv, want[0], i)
        if not (torch.equal(tab, want[1]) and torch.equal(pending0, want[2])):
            fail(f"K16 (with K15's keep flags) differs from its plain "
                 f"versions on level {i}")
    torch.cuda.synchronize()

    # the first level's inputs, as recorded (the checks above wrote into
    # the recorded outputs the same values)
    contigs, tab, pending0, lv, al0 = recs["prologue"][0]
    W, Tmax = lv["x"].shape
    S = pending0.shape[0]
    gathered = int(torch.clamp(lv["n"], min=0).sum())
    k13 = timed_pair(
        lambda: cl.prologue(contigs, tab, pending0, lv, al0),
        lambda: cl.prologue_plain(contigs, tab, pending0, W, al0),
        4 * gathered + 8 * W * Tmax + 8 * 3 * S + S + 60 * W,
        5 * W * Tmax, reps=20, f64=True)
    tab14, _S, lv14, alpha, kmax, n_grid, n_perm, n_min = \
        recs["tail_decide"][0]
    k14r = timed_pair(
        lambda: cl.tail_decide(tab14, S, lv14, alpha, kmax, n_grid, n_perm,
                               n_min),
        lambda: cl.tail_decide_plain(lv14, alpha, kmax, n_grid, n_perm,
                                     n_min),
        60 * W, 20 * W, reps=20)
    # K11 alone on the same rows, the launch that carries K14: K14's added
    # time is the difference
    b, live = lv14["b"].clone(), tab14[3 * S + cl.LIVE]
    host_ms = cuda_ms(lambda: st.tail_p(b, lv14["n_eff"], kmax, n_grid,
                                        live=live), reps=20, queued=True)
    k14r.update(launch="tail_decide_kernel, K11's cooperative launch",
                host_ms=host_ms, added_ms=k14r["ms"] - host_ms)
    tab15, _S, lv15, walked, alpha, n_perm = recs["edge_setup"][0]
    # each row's x read once up to max(tj, n); the lanes' windows written
    span = int(torch.clamp(torch.maximum(lv15["tj"].long(), lv15["n"]),
                           min=0, max=Tmax).sum())
    k15r = timed_pair(
        lambda: cl.edge_setup(tab15, S, lv15, walked, alpha, n_perm),
        lambda: cl.edge_setup_plain(lv15["x"], lv15["n"], lv15["ti"],
                                    lv15["tj"], lv15["trivial"], walked,
                                    alpha, n_perm, Tmax),
        4 * span + 8 * W * Tmax + 100 * W, 4 * 2 * W * Tmax, reps=20,
        f64=True)
    k15r["keep_flags"] = "in keep_table_kernel, K16's launch"
    args16 = recs["keep_table"][0]
    fresh = [(args16[0].clone(), args16[1].clone()) for _ in range(64)]
    turn = iter(range(10 ** 9))

    def k16():
        t, p = fresh[next(turn) % len(fresh)]
        cl.keep_table(t, p, *args16[2:])

    # K16's table read and written, and the keep flags' lanes: K8's count
    # and cnt, degen and quick0 read, keep1 and keep2 written
    k16r = timed_pair(
        k16, lambda: cl.keep_table_plain(*args16),
        2 * (8 * (3 * S + cl.CTL) + S) + 60 * W + 2 * W * 18 + 2 * W,
        10 * S + 4 * W, reps=20)
    k16r["launch"] = "keep_table_kernel, with K15's keep flags"
    return {"levels": levels, "dead_levels": n_calls - levels, "rows": W,
            "Tmax": Tmax, "slots": S, "tiles": {
                "K13": cl.prologue_layout(W, Tmax),
                "K15": cl.edge_layout(W, Tmax)},
            "active_lanes": active, "K13": {"gathered": gathered, **k13},
            "K14": k14r, "K15": {"x_read": span, **k15r}, "K16": k16r}


def bench_cbs_coverage() -> dict:
    """bench.py's CBS workload (bench_cbs): 24 contigs of 16,384 bins of
    N(0, 1) from default_rng(1), +1.5 on [T/4, T/3) and -1.2 on
    [T/2, T/2 + 600)."""
    rng = np.random.default_rng(1)
    B, T = 24, 16 * 1024
    cov = {}
    for b in range(B):
        c = rng.normal(0.0, 1.0, size=T)
        c[T // 4: T // 3] += 1.5
        c[T // 2: T // 2 + 600] -= 1.2
        cov[f"chr{b}"] = c
    return cov


def swapped_plain_k7_k8(run):
    """run() with K7 and K8 replaced by their plain versions (which take
    no live flag and read their loop tests from the card)."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    orig = mc.walk, mc.edge_counts
    mc.walk = lambda *a, live=None, **kw: mc.walk_plain(*a, **kw)
    mc.edge_counts = lambda *a, live=None, **kw: mc.edge_counts_plain(*a,
                                                                      **kw)
    try:
        return run()
    finally:
        mc.walk, mc.edge_counts = orig


def cuda_equals_cpu(cov: dict, dev: torch.device, lens: dict,
                    what: str) -> dict:
    """The whole-recursion engine over cov on CPU tensors: its segments
    equal to lens (the CUDA run's), and its counts (levels, walk and edge
    chunks, walks accepted and rejected, arc pairs) equal to a CUDA run's;
    B4's arc terms, its kernel's tally, are counted on the card alone (a
    CUDA run's, between 1 and the arc pairs).  Returns the CPU run's
    seconds and counts, with the card's arc terms."""
    from canvas_tpu_torch.ops import cbs_mega

    counts: dict = {}
    t0 = time.perf_counter()
    lens_cpu = cbs_mega.run_cbs_mega(cov, device="cpu", counts=counts)
    cpu_s = time.perf_counter() - t0
    for c in cov:
        if not np.array_equal(lens[c], lens_cpu[c]):
            fail(f"{what}: whole-recursion segments on {c} differ between "
                 f"CUDA and CPU tensors: {lens[c].tolist()} vs "
                 f"{lens_cpu[c].tolist()}")
    counts_cuda: dict = {}
    cbs_mega.run_cbs_mega(cov, device=dev, counts=counts_cuda)
    terms = counts_cuda.pop("arc_terms")
    if counts_cuda != {k: v for k, v in counts.items() if k != "arc_terms"} \
            or counts["arc_terms"] or not 0 < terms <= counts["arc_pairs"]:
        fail(f"{what}: counts on the card {counts_cuda} (arc terms {terms}), "
             f"on the CPU {counts}")
    return {"cpu_s": cpu_s, "counts": counts, "arc_terms_cuda": terms}


def mega_runs(cov: dict, dev: torch.device) -> dict:
    """run_cbs on cuda over cov: the engine's figures (engine_figures,
    checked), then the best of 3 runs with each run's reads, replays and
    kernel launches and segments (equal to the first run's), the engine
    on CPU tensors (equal segments and counts), one run under
    torch.profiler, its host calls, and one eager run with K7 and K8's
    plain versions on the same CUDA tensors (equal segments)."""
    from canvas_tpu_torch.ops import cbs, cbs_mega

    fig = engine_figures(cov, dev)
    warm = fig.pop("lens")
    runs = []
    for _ in range(3):
        reset_launches()
        s0 = cbs_mega.SYNCS["cbs_mega"]
        r0 = cbs_mega.GRAPHS["replays"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lens = cbs.run_cbs(cov, device=dev)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "syncs": cbs_mega.SYNCS["cbs_mega"] - s0,
                     "replays": cbs_mega.GRAPHS["replays"] - r0,
                     "launches": {k: v for k, v in read_launches().items()
                                  if k in MEGA_KERNELS},
                     "levels": cbs._LAST_ENGINE["levels"]})
        for c in cov:
            if not np.array_equal(lens[c], warm[c]):
                fail(f"run_cbs gave other segments on {c} than its warm run")
    cpu = cuda_equals_cpu(cov, dev, warm, "bench.py's CBS workload")
    traced = trace_cbs(lambda: cbs_mega.run_cbs_mega(cov, device=dev))
    check_engine_figures(fig, traced, "bench.py's CBS workload")
    host = mega_host_calls(lambda: cbs_mega.run_cbs_mega(cov, device=dev))
    t0 = time.perf_counter()
    plain = swapped_plain_k7_k8(lambda: eager_mega(cov, dev))
    plain_s = time.perf_counter() - t0
    for c in cov:
        if not np.array_equal(plain[c], warm[c]):
            fail(f"segments on {c} differ between K7/K8 and their plain "
                 f"versions: {warm[c].tolist()} vs {plain[c].tolist()}")
    best = min(runs, key=lambda r: r["seconds"])
    return {"contigs": len(cov), "bins": sum(len(v) for v in cov.values()),
            "segments": sum(len(v) for v in warm.values()),
            "best_of_3_s": best["seconds"],
            "seconds": [r["seconds"] for r in runs],
            "syncs": best["syncs"], "levels": best["levels"],
            "replays": best["replays"], "launches": best["launches"],
            "engine": fig, "cpu_s": cpu["cpu_s"], "counts": cpu["counts"],
            "lengths_equal_cpu": True, "plain_kernels_s": plain_s,
            "equal_to_plain_kernels": True,
            "profiled_cuda": traced["profile"],
            "traced_launches": traced["traced_launches"], "host_calls": host}


# The earlier whole-recursion engine, each level driven from Python with
# a read from the card a level (PERF.md section 5, measured on one NVIDIA
# H100 80GB HBM3, 700.00 W), printed beside this run's figures
LEVEL_LOOP_ENGINE = {"panel": {"wall_s": 0.0443, "kernel_launches": 1517,
                               "reads": 5, "synchronising_calls": 9,
                               "busy_share": 0.115},
                     "bench_cbs": {"wall_s": 0.0304, "kernel_launches": 1507,
                                   "reads": 5, "busy_share": 0.195}}


# K7 after its redesign (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section
# 6), printed beside this run's: K12 shares its permutation, cumsum and
# statistic code
BEFORE_K7_MS = {"panel": 0.1577, "bench_cbs": 0.0376}


# The captured level's kernel nodes with K14 in two launches of its own and
# K15's keep flags in one (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section
# 5), printed beside this run's: the fused launches take three fewer
NODES_BEFORE = {"panel": 34, "bench.py's CBS workload": 30}


# K13 and K15 in their earlier design, a block a row (lane), on the first
# level of each input (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6),
# printed beside this run's; the largest shape's were not timed
BEFORE_K13_K15 = {"K13": {"panel": 0.0308, "bench_cbs": 0.0187},
                  "K15": {"panel": 0.0122, "bench_cbs": 0.0104}}


def wide_exponent_rows(dev: torch.device, W: int = 64,
                       Tmax: int = 16384) -> dict:
    """A report, not a check: K13 and K15 beside their plain versions on
    seeded rows whose values' exponents span 40 bits, more than the
    29 - log2(n) bits that keep a float64 sum of n f32 values exact, so
    that the sums' order can show.  W rows of 4,000 to Tmax values
    sign x 2^U(-20, 20) in a table of 2 W slots, all pending; K15 on the
    rows' splits at n / 3 and 2 n / 3, every row accepted.  The rows
    whose tss or cumsum differ (K13), and the lanes whose xbar, ostat,
    degen, quick0 or active differ (K15)."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl

    rng = np.random.default_rng(11)
    S = 2 * W
    n = rng.integers(4000, Tmax + 1, W)
    vals = (rng.choice([-1.0, 1.0], (W, Tmax))
            * np.exp2(rng.uniform(-20, 20, (W, Tmax)))).astype(np.float32)
    tab = torch.zeros(3 * S + cl.CTL, dtype=torch.int64)
    tab[:W] = torch.arange(W)
    tab[W:S] = -1
    tab[2 * S:2 * S + W] = torch.as_tensor(n)
    tab[3 * S + cl.LIVE] = 1
    pending0 = torch.arange(S) < W
    contigs = torch.as_tensor(vals, device=dev)
    tab, pending0 = tab.to(dev), pending0.to(dev)
    lv = cl.level_buffers(W, Tmax, len(cl.tier_widths(Tmax)), dev)
    cl.prologue(contigs, tab, pending0, lv, 2)
    want = cl.prologue_plain(contigs, tab, pending0, W, 2)
    rows_tss = int((lv["tss"].view(torch.int32)
                    != want["tss"].view(torch.int32)).sum())
    rows_cs = int((lv["cs"].view(torch.int32)
                   != want["cs"].view(torch.int32)).any(dim=1).sum())
    rows_x = int((lv["x"].view(torch.int32)
                  != want["x"].view(torch.int32)).any(dim=1).sum())
    nt = torch.as_tensor(n, device=dev)
    lv["ti"].copy_((nt // 3).to(torch.int32))
    lv["tj"].copy_((2 * nt // 3).to(torch.int32))
    lv["trivial"].fill_(True)
    walked = torch.zeros(W, dtype=torch.bool, device=dev)
    alpha = torch.tensor(0.01, dtype=torch.float32, device=dev)
    cl.edge_setup(tab, S, lv, walked, alpha, 1000)
    want15 = cl.edge_setup_plain(lv["x"], lv["n"], lv["ti"], lv["tj"],
                                 lv["trivial"], walked, alpha, 1000, Tmax)
    lanes = torch.zeros(2 * W, dtype=torch.bool, device=dev)
    for k in ("xbar", "ostat_e", "degen", "quick0", "active"):
        a, b = lv[k], want15[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        lanes |= a != b
    torch.cuda.synchronize()
    return {"rows": W, "Tmax": Tmax, "exponent_span_bits": 40,
            "exact_span_bits": [29 - float(np.log2(Tmax)),
                                29 - float(np.log2(4000))],
            "K13_rows_x_differ": rows_x, "K13_rows_tss_differ": rows_tss,
            "K13_rows_cs_differ": rows_cs,
            "K15_lanes": 2 * W, "K15_lanes_differ": int(lanes.sum()),
            "K15_xw_equal": bits_equal(lv["xw"], want15["xw"])}


def largest_coverage() -> dict:
    """The whole-recursion engine's largest shape: 192 contigs of 65,536
    bins of N(0, 1) from default_rng(3) (a table of 1,024 slots, 512 rows
    a level, tiers 1,024 to 65,536)."""
    C, T = 192, 1 << 16
    rng = np.random.default_rng(3)
    return {f"chr{c}": rng.normal(0.0, 1.0, size=T) for c in range(C)}


def largest_engine(dev: torch.device, cov: dict) -> dict:
    """The whole-recursion engine at its largest shape (largest_coverage).
    The card's memory the engine holds between runs, its buffers and its
    graph (the free memory cudaMemGetInfo reports before the first run and
    after it, and the caching allocator's reserved and allocated bytes),
    then what stays once the engine is dropped (the wrappers' per-device
    scratch); the capture's seconds, a replayed run's wall and levels, and
    one more replayed run under torch.profiler (trace_cbs: each kernel's
    device time, the card's busy share; every kernel of the level traced
    as often as its launches were counted)."""
    from canvas_tpu_torch.ops import cbs_mega

    C, T = len(cov), len(next(iter(cov.values())))

    def memory():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        return {"free": torch.cuda.mem_get_info(dev)[0],
                "reserved": torch.cuda.memory_reserved(dev),
                "allocated": torch.cuda.memory_allocated(dev)}

    cbs_mega._ENGINES.clear()
    before = memory()
    first = cbs_mega.run_cbs_mega(cov, device=dev)
    held = memory()
    eng = cbs_mega._ENGINES[dev]
    shape = {"slots": eng.S, "rows": eng.W, "Tmax": eng.Tmax,
             "tiers": len(eng.tiers)}
    counts: dict = {}
    t0 = time.perf_counter()
    lens = cbs_mega.run_cbs_mega(cov, device=dev, counts=counts)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if first is None or lens is None:
        fail("the whole-recursion engine overflowed its table at its "
             "largest shape")
    for c in cov:
        if not np.array_equal(lens[c], first[c]):
            fail(f"the largest shape's second run gave other segments on {c}")
    traced = trace_cbs(lambda: cbs_mega.run_cbs_mega(cov, device=dev))
    traced_equals_counted(traced["traced_launches"],
                          traced["counted_launches"], MEGA_KERNELS,
                          "the largest shape")
    capture_s = eng.capture_s
    del eng
    cbs_mega._ENGINES.clear()
    after = memory()
    return {"contigs": C, "bins": T, **shape,
            "engine_bytes": before["free"] - held["free"],
            "reserved_bytes": held["reserved"] - before["reserved"],
            "allocated_bytes": held["allocated"] - before["allocated"],
            "kept_after_drop_bytes": before["free"] - after["free"],
            "capture_s": capture_s, "wall_s": wall,
            "levels": counts["levels"],
            "segments": sum(len(v) for v in lens.values()),
            "profiled_cuda": traced["profile"],
            "traced_launches": traced["traced_launches"]}


def phase_cbs_mega(workdir: Path, dev: torch.device, frontier: dict) -> dict:
    """The whole-recursion engine on the panel's tumor ratio coverage:
    through run_cbs on cuda (engine_figures: the capture's seconds and
    the level's graph nodes, a run's wall, levels, replays, reads, kernel
    launches and synchronising calls, checked), on CPU tensors (equal
    lengths and levels), once under torch.profiler and once for its host
    calls; beside phase CBS's frontier figures and the level-loop engine's; then K13-K16
    against their plain versions on every level of the panel's and
    bench.py's CBS workload's runs (level_kernel_cases), K7 and K8 on the
    inputs of the first level with a walk and the first with an edge test
    (panel, else bench.py's workload), bench.py's workload through the
    engine (mega_runs), B4 at every tier width the engine uses, 32
    rows of which three lie under the tier's mask, the engine at its
    largest shape (largest_engine, traced) with K13-K16 on its levels, and
    the wide-exponent report (wide_exponent_rows)."""
    from canvas_tpu_torch.ops import cbs_mega

    cov = panel_coverage(workdir)
    fig = engine_figures(cov, dev)
    lens, levels = fig.pop("lens"), fig["levels"]
    cpu = cuda_equals_cpu(cov, dev, lens, "panel")
    counts, cpu_s = cpu["counts"], cpu["cpu_s"]
    if counts["levels"] != levels:
        fail(f"{levels} levels on the card, {counts['levels']} on the CPU")
    traced = trace_cbs(lambda: cbs_mega.run_cbs_mega(cov, device=dev))
    if traced["lengths"] != {c: v.tolist() for c, v in lens.items()}:
        fail("the profiled whole-recursion run gave other segments")
    check_engine_figures(fig, traced, "panel")
    host = mega_host_calls(lambda: cbs_mega.run_cbs_mega(cov, device=dev))
    bench_cov = bench_cbs_coverage()
    level_cases = {"panel": level_kernel_cases(cov, dev),
                   "bench_cbs": level_kernel_cases(bench_cov, dev)}
    captured = capture_kernel_inputs(lambda: eager_mega(cov, dev))
    source = {k: "panel" for k in captured}
    bench_in = capture_kernel_inputs(lambda: eager_mega(bench_cov, dev))
    for k, v in bench_in.items():
        if k not in captured:
            captured[k], source[k] = v, "bench_cbs"
    if len(captured) < 2:
        fail(f"no level with a walk or with an edge test to check K7 and K8 "
             f"on: {sorted(captured)}")
    k7 = dict(k7_case(captured["walk"]), inputs=source["walk"])
    k8 = dict(k8_case(captured["edge_counts"]), inputs=source["edge_counts"])
    # the bench workload's first walking and edge-testing levels, where
    # the panel gave the cases above
    bench_cases = {}
    for key, case, name, what in (
            ("K7_bench", k7_case, "walk", "a walking row"),
            ("K8_bench", k8_case, "edge_counts", "an active edge lane")):
        if name not in bench_in:
            bench_cases[key] = {"inputs": "bench_cbs", "timed": False,
                                "why": f"no level of the run has {what}"}
        elif source[name] != "panel":
            bench_cases[key] = {"inputs": "bench_cbs", "timed": False,
                                "why": "its level is the case above"}
        else:
            bench_cases[key] = dict(case(bench_in[name]), inputs="bench_cbs")
    bench = mega_runs(bench_cov, dev)
    tiers = []
    rng = np.random.default_rng(7)
    for k in range(10, 17):
        npad = 1 << k
        cs, n, mask = b4_tier_rows(rng, npad, dev)
        tiers.append(b4_case(cs, n, npad, mask=mask))
    torch.cuda.empty_cache()
    big = largest_coverage()
    largest = largest_engine(dev, big)
    level_cases["largest"] = level_kernel_cases(big, dev)
    del big
    torch.cuda.empty_cache()
    spread = wide_exponent_rows(dev)
    panel = level_cases["panel"]
    return {"phase": "cbs-mega", "engine": "mega",
            "bins": {c: len(v) for c, v in cov.items()},
            "segments": {c: len(v) for c, v in lens.items()},
            "lengths_equal": True, "levels": levels, "counts": counts,
            "cuda_s": fig["wall_s"], "cpu_s": cpu_s, "engine_figures": fig,
            "launches": fig["launches"],
            "arc_scan_launches": fig["launches"]["arc_scan"],
            "syncs": fig["reads"], "cuda_syncs": fig["synchronising_calls"],
            "profiled_cuda": traced["profile"],
            "traced_launches": traced["traced_launches"],
            "host_calls": host, "level_loop_engine": LEVEL_LOOP_ENGINE,
            "frontier": {k: frontier[k] for k in (
                "n_levels", "cuda_s", "cpu_s", "arc_scan_launches",
                "cuda_syncs", "profiled_cuda")},
            "level_kernels": level_cases,
            "K13": panel["K13"], "K14": panel["K14"], "K15": panel["K15"],
            "K16": panel["K16"],
            "K7": k7, "K8": k8, **bench_cases, "bench_cbs": bench,
            "K13_K15_now_vs_before_ms": {
                f"{k}_{w}": [level_cases[w][k]["ms"],
                             BEFORE_K13_K15[k].get(w)]
                for k in ("K13", "K15") for w in level_cases},
            "K13_K15_wide_exponents": spread,
            "kernel_nodes_now_vs_before": {
                "panel": [fig["graph_nodes"]["kernels"],
                          NODES_BEFORE["panel"]],
                "bench_cbs": [bench["engine"]["graph_nodes"]["kernels"],
                              NODES_BEFORE["bench.py's CBS workload"]]},
            "dead_level_replay_ms": {
                "panel": fig["dead_level_replay_ms"],
                "bench_cbs": bench["engine"]["dead_level_replay_ms"]},
            "K7_now_vs_PR13_ms": {
                "panel": [k7["ms"], BEFORE_K7_MS["panel"]],
                "bench_cbs": [bench_cases["K7_bench"].get("ms"),
                              BEFORE_K7_MS["bench_cbs"]]},
            "b4_tiers": tiers, "largest_shape": largest}


def capture_stats_inputs(mega_run, frontier_run) -> dict:
    """The arguments (cloned) of K9's and K10's first call at each tier
    width with a row under the tier's mask during mega_run() (an eager
    engine run; each as (args, keywords), the live flag left out) and
    K11's of its first level there (b, n_eff, kmax, n_grid: the engine's
    K11 carries K14 and takes b from the level's t2, so its b here is
    decide_prep_plain's), and of K12's first call from a frontier level
    with a row under its mask ("level") and its first continuation chunk
    ("chunk") during frontier_run(), caught by wrapping the entry points
    for those runs only."""
    from canvas_tpu_torch.ops import cbs_level_cuda as cl
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    got: dict = {"arc_inputs": {}, "refine": {}}
    orig = {"arc_inputs": st.arc_inputs, "refine": st.refine,
            "tail_decide": cl.tail_decide, "perm_stats": mc.perm_stats}

    def clone(args):
        return [a.clone() if torch.is_tensor(a) else a for a in args]

    def masked(kw) -> bool:
        return kw.get("mask") is None or bool(kw["mask"].any())

    def keywords(kw) -> dict:
        return {k: (tuple(clone(v)) if isinstance(v, tuple) else clone([v])[0])
                for k, v in kw.items() if k != "live"}

    def arc_inputs(*args, **kw):
        if masked(kw):                                          # npad
            got["arc_inputs"].setdefault(args[2], (clone(args), keywords(kw)))
        return orig["arc_inputs"](*args, **kw)

    def refine(*args, **kw):
        if masked(kw):
            got["refine"].setdefault(args[8], (clone(args), keywords(kw)))
        return orig["refine"](*args, **kw)

    def tail_decide(tab, S, lv, alpha, kmax, n_grid, *rest):
        got.setdefault("tail_p", [cl.decide_prep_plain(lv["t2"]),
                                  lv["n_eff"].clone(), kmax, n_grid])
        return orig["tail_decide"](tab, S, lv, alpha, kmax, n_grid, *rest)

    def perm_stats(*args):
        key = "level" if sys._getframe(1).f_code.co_name == "_level" \
            else "chunk"
        if key not in got and bool(args[4].any()):              # mask
            got[key] = clone(args)
        return orig["perm_stats"](*args)

    st.arc_inputs, st.refine = arc_inputs, refine
    cl.tail_decide, mc.perm_stats = tail_decide, perm_stats
    try:
        mega_run()
        frontier_run()
    finally:
        st.arc_inputs, st.refine = orig["arc_inputs"], orig["refine"]
        cl.tail_decide = orig["tail_decide"]
        mc.perm_stats = orig["perm_stats"]
    return got


def bits_equal(a, b) -> bool:
    if a.dtype in (torch.float32, torch.float64):
        width = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(width), b.view(width))
    return torch.equal(a, b)


def kernel_case(name, kernel, plain, args, n_bytes, ops, reps,
                f64=False) -> dict:
    """kernel(*args) against plain(*args) on the card, every output bit
    for bit (else the smoke fails), both times, the bound from n_bytes and
    ops (f32 operations, or with f64 FP64 ones) and its share."""
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in zip(got, want))
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        fail(f"{name} differs from its plain version: max |diff| {err}")
    if f64:
        t_bytes = n_bytes / HBM_BPS * 1e3
        t_ops = ops * FLOPS_PER_OP / F64_OPS * 1e3
        b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                      else (t_ops, "operations"))
    else:
        b_ms, b_by = bound(n_bytes, ops)
    ms = cuda_ms(lambda: kernel(*args), reps=reps, queued=True)
    plain_ms = cuda_ms(lambda: plain(*args), reps=2)
    return {"equal": True, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bytes": n_bytes,
            "operations": ops, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms}


def _rows_of(mask, B: int, dev):
    return (torch.arange(B, device=dev) if mask is None
            else torch.nonzero(mask)[:, 0])


def k9_case(rec) -> dict:
    """K9 on one captured call (under its tier's row mask: the rows under
    it compared, bit for bit, with the plain version on those rows): the
    rows' cumsums read once and their outputs written once; per position
    two comparisons and a chunk maximum and minimum, and per chunk pair a
    subtraction and a maximum."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    args, kw = rec
    cs, n, npad, al0 = args
    mask = kw.get("mask")
    B = cs.shape[0]
    rows = _rows_of(mask, B, cs.device)
    R = len(rows)
    nblk = max(npad // 512, 1)
    nchunk = npad // min(256, npad)
    got = [o[rows] for o in st.arc_inputs(cs, n, npad, al0, mask=mask)]
    want = (*st.arc_scan_inputs_plain(cs[rows], n[rows], npad, al0),
            n[rows].to(torch.int32))
    torch.cuda.synchronize()
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        fail(f"K9 differs from its plain version at {B} x {npad}")
    res = timed_pair(
        lambda: st.arc_inputs(cs, n, npad, al0, mask=mask),
        lambda: st.arc_scan_inputs_plain(cs[rows], n[rows], npad, al0),
        4 * R * npad + n.element_size() * R + 20 * R + 4 * R * nblk,
        R * (4 * npad + 2 * nchunk * nchunk), reps=20)
    return {"rows": B, "masked": R, "npad": npad, **res}


def k10_case(rec) -> dict:
    """K10 on one captured call, under its tier's row mask and into the
    level's t2, ti, tj: per pair of a masked row with a sub-block
    (positions i, lags bl0 + k inside [al0, lag_hi] with i + lag <= n - 1)
    a subtraction, two multiplications, a comparison and a selection; the
    cumsums of those rows and the [B] vectors read once.  The masked rows
    bit for bit equal to the plain version on them, the others
    untouched."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    args, kw = rec
    cs, n, _tss, lag_hi, _best, bl0, _ti0, _tj0, npad, al0 = args
    mask, out = kw.get("mask"), kw.get("out")
    B = cs.shape[0]
    rows = _rows_of(mask, B, cs.device)
    sub = min(32, npad)
    n_h, lh_h, b0_h = n.tolist(), lag_hi.tolist(), bl0.tolist()
    hits = [r for r in rows.tolist() if b0_h[r] >= 0]
    pairs = sum(max(0, n_h[r] - lag) for r in hits
                for lag in range(max(b0_h[r], al0),
                                 min(b0_h[r] + sub - 1, lh_h[r]) + 1))
    before = [o.clone() for o in out] if out is not None else None
    dest = [o.clone() for o in out] if out is not None else None
    got = st.refine(*args, mask=mask, out=dest)
    want = st.refine_plain(*[a[rows] for a in args[:8]], npad, al0)
    torch.cuda.synchronize()
    ok = all(bits_equal(a[rows], b) for a, b in zip(got, want))
    if before is not None and mask is not None:
        ok = ok and all(bits_equal(a[~mask], b[~mask])
                        for a, b in zip(got, before))
    if not ok:
        fail(f"K10 differs from its plain version at {B} x {npad}")
    res = timed_pair(
        lambda: st.refine(*args, mask=mask, out=dest),
        lambda: st.refine_plain(*[a[rows] for a in args[:8]], npad, al0),
        4 * npad * len(hits) + 40 * len(rows), 5 * pairs, reps=20)
    return {"rows": B, "masked": len(rows), "npad": npad,
            "rows_with_a_sub_block": len(hits), "pairs": pairs, **res}


def k11_case(args, erfc: dict, term: dict) -> dict:
    """K11 on one call: its erfc calls (8,192 series terms and 129
    Simpson points at each grid point with x > 0.01), each the FP64
    instructions of one call in the SASS, at the FP64 rate; beside them a
    series term's FP64 instructions, now and before (term_sass)."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    b, n, kmax, n_grid = args
    nf = n.double()
    delta = torch.clamp((kmax + 1.0) / nf, 0.0, 0.45)
    dincr = (0.5 - delta) / n_grid
    ts = 0.5 + (torch.arange(n_grid, device=b.device).double()[None, :]
                + 0.5) * dincr[:, None]
    x = (b / torch.sqrt(nf))[:, None] / torch.sqrt(ts * (1 - ts))
    live = int((x > 0.01).sum())
    calls = live * (st.NU_SERIES_TERMS + st.NU_TAIL_PANELS + 1)
    res = kernel_case("K11", st.tail_p, st.tail_p_plain, args,
                      8 * b.numel() + n.element_size() * n.numel()
                      + 8 * b.numel(),
                      calls * erfc["fp64_instructions"], reps=10, f64=True)
    return {"rows": b.numel(), "grid": n_grid, "grid_points_live": live,
            "rows_live": int((x > 0.01).any(dim=1).sum()),
            "erfc_calls": calls,
            "erfc_fp64_instructions": erfc["fp64_instructions"],
            "term_fp64_instructions": {
                k: v["fp64_instructions"] for k, v in term.items()}, **res}


def k12_case(args) -> dict:
    """K12 on one captured call: K7's count for one chunk of P
    permutations of every row under the mask; their values read once."""
    from canvas_tpu_torch.ops import cbs_mega_cuda as mc

    x, n, _tss, _keys, mask, hybrid, P, al0, kmax, max_len = args
    S, npad = x.shape
    rows = torch.nonzero(mask)[:, 0].tolist()
    n_h, hyb_h = n.tolist(), hybrid.tolist()
    ops = sum(k7_ops(n_h[r], hyb_h[r], 1, npad, al0, kmax, max_len, P)
              for r in rows)
    res = kernel_case("K12", mc.perm_stats, mc.perm_stats_plain, args,
                      4 * npad * len(rows) + 4 * S * P, ops, reps=5)
    lay = mc.perm_layout(npad, len(rows) * P, mc.perm_grid(x.device))
    return {"rows": S, "npad": npad, "P": P, "masked": len(rows),
            "n": [n_h[r] for r in rows], "hybrid": [hyb_h[r] for r in rows],
            "layout": {k: lay[k] for k in ("groups", "buffers",
                                           "draws_a_position", "staged")},
            "layout_before": k12_before_layout(npad), **res}


# K10 and K11 before their redesign for the whole card (a block a row, a
# cluster of 8 blocks a row; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md
# section 6), printed beside this run's times: K10 by the tier width of
# the panel's first call there, K11 on the panel's first level
BEFORE_STATS = {"K10_ms": {"1024": 0.0077, "2048": 0.0110, "4096": 0.0151,
                         "8192": 0.0211, "16384": 0.0547, "32768": 0.0825},
              "K11_ms": 0.1694}
# K9 and K12 before their redesign (a block a row; K7's groups of the
# width; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6), printed
# beside this run's times: K9 by tier width of the panel's first call
# there, K12 on the frontier's first level with a chunk and on bench.py's
# first continuation chunk
BEFORE_K9_K12 = {"K9_ms": {"1024": 0.0048, "2048": 0.0053, "4096": 0.0061,
                           "8192": 0.0073, "16384": 0.0101,
                           "32768": 0.0155},
                 "K12_ms": {"level": 0.0498, "chunk": 0.1106}}


def live_level(dev: torch.device, seed: int = 15, npad: int = 32_768):
    """K10's and K11's arguments on a fully live level of 32 rows at
    width npad: centred noise of 19,000 to npad bins with a planted step,
    through K9 and B4; a row whose seed B4 never beat takes the sub-block
    of its seed's lag, so every row has one.  K11 takes the rows' b =
    sqrt(t^2) from K10 at n bins (kmax 25, 100 grid points)."""
    from canvas_tpu_torch.ops import arc_scan_cuda
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    rng = np.random.default_rng(seed)
    B, al0 = 32, 2
    cs = np.zeros((B, npad), np.float32)
    n = rng.integers(19_000, npad + 1, B)
    for r in range(B):
        x = rng.normal(0, 1, n[r])
        lo = int(rng.integers(0, n[r] - 2_000))
        x[lo:lo + int(rng.integers(200, 2_000))] += rng.uniform(0.1, 0.8)
        cs[r, :n[r]] = np.cumsum(x - x.mean())
    tss = (np.diff(cs, axis=1, prepend=0) ** 2).sum(1).astype(np.float32)
    csd = torch.as_tensor(cs, device=dev)
    nd = torch.as_tensor(n, device=dev)
    tssd = torch.as_tensor(tss, device=dev)
    seedv, lag_hi, psd2, ti0, tj0, n32 = st.arc_inputs(csd, nd, npad, al0)
    best, bl0 = arc_scan_cuda.arc_scan(csd, n32, lag_hi, seedv, psd2, al0)
    bl0 = torch.where(bl0 >= 0, bl0, (tj0 - ti0) // 32 * 32)
    refine_args = [csd, nd, tssd, lag_hi, best, bl0, ti0, tj0, npad, al0]
    t2 = st.refine_plain(*refine_args)[0]
    b = torch.sqrt(torch.clamp(t2.double(), min=0.0))
    return refine_args, [b, nd, 25, 100]


def phase_cbs_stats(workdir: Path, dev: torch.device, erfc: dict,
                    term: dict) -> dict:
    """K9, K10 and K11 on the whole-recursion engine's first level at
    each tier width of the panel (K11: its first level), K12 on the
    frontier engine's first level with a permutation chunk and its first
    continuation chunk (the panel's, else bench.py's workload's), each
    against its plain version on the card; then K10 and K11 on a fully
    live level (live_level), and the earlier designs' times beside this
    run's."""
    from canvas_tpu_torch.ops import cbs_device

    cov = panel_coverage(workdir)
    got = capture_stats_inputs(
        lambda: eager_mega(cov, dev),
        lambda: cbs_device.run_cbs_device(cov, device=dev))
    source = {k: "panel" for k in ("level", "chunk") if k in got}
    if len(source) < 2:
        more = capture_stats_inputs(
            lambda: None, lambda: cbs_device.run_cbs_device(
                bench_cbs_coverage(), device=dev))
        for k in ("level", "chunk"):
            if k not in got and k in more:
                got[k], source[k] = more[k], "bench_cbs"
    if not got["arc_inputs"] or "tail_p" not in got or "level" not in got:
        fail(f"no captured call for K9, K11 or K12's level: {sorted(got)}")
    k9 = {str(w): k9_case(a) for w, a in sorted(got["arc_inputs"].items())}
    k10 = {str(w): k10_case(a) for w, a in sorted(got["refine"].items())}
    top = str(max(got["arc_inputs"]))
    k12 = {k: dict(k12_case(got[k]), inputs=source[k])
           for k in ("level", "chunk") if k in got}
    k11 = k11_case(got["tail_p"], erfc, term)
    refine_args, tail_args = live_level(dev)
    live10 = k10_case((refine_args, {}))
    live11 = k11_case(tail_args, erfc, term)
    if live10["rows_with_a_sub_block"] != 32 or live11["rows_live"] != 32:
        fail(f"the live level has {live10['rows_with_a_sub_block']} rows "
             f"with a sub-block and {live11['rows_live']} live rows of 32")
    torch.cuda.empty_cache()
    return {"phase": "cbs-stats", "K9": k9, "K10": k10, "K11": k11,
            "K12": k12, "K9_top": k9[top], "K10_top": k10[top],
            "live_level": {"K10": live10, "K11": live11},
            "now_vs_before_ms": {
                "K9": {w: [k9[w]["ms"], BEFORE_K9_K12["K9_ms"].get(w)]
                       for w in k9},
                "K12": {k: [v["ms"], BEFORE_K9_K12["K12_ms"][k]]
                        for k, v in k12.items()},
                "K10": {w: [k10[w]["ms"], BEFORE_STATS["K10_ms"].get(w)]
                        for w in k10},
                "K11": [k11["ms"], BEFORE_STATS["K11_ms"]]}}


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


def phase_e2e_joint(workdir: Path) -> dict:
    """SmallPedigree-WGS on phase e2e's trio with the joint HMM (-m HMM)
    and, separately, with PerSampleHMM and a common-CNV bed over the
    shared gain."""
    n_contigs, n_samples = len(TRIO_CONTIGS), len(PLANS)
    # the common CNV starts 500 bp into the gain: the bin across the gain's
    # start is a segment of its own, and MergeCommonCnvSegments pairs a
    # common interval starting there with that bin and drops it
    bed = workdir / "common_cnvs.bed"
    bed.write_text(f"{GAIN[0]}\t{GAIN[1] + 500}\t{GAIN[2]}\n")
    args = ["SmallPedigree-WGS",
            "--bams", *[str(workdir / f"{n}.bam") for n in PLANS],
            "--names", *PLANS, "--types", *[TYPES[n] for n in PLANS],
            "-r", str(workdir / "ref")]
    # decodes a run needs: one for the trio (joint) or one a sample
    variants = {"hmm": (["--custom-parameters", "CanvasPartition,-m HMM"],
                        1),
                "common_cnvs": (["--common-cnvs-bed", str(bed)], n_samples)}
    out = {"phase": "e2e-joint", "genome_bp": sum(TRIO_CONTIGS.values()),
           "contigs": n_contigs, "samples": n_samples}
    for name, (extra, decodes) in variants.items():
        runs = run_both([*args, *extra], workdir / f"joint_{name}",
                        "pedigree_profile.json")
        want = {"prefix_scan": n_contigs * n_samples,
                **{k: decodes for k in DECODE_KERNELS}}
        got = {k: runs["launches"][k] for k in want}
        if got != want:
            fail(f"{name}: kernel launches {got}, the path needs {want}")
        if runs["b2_chains"] != {"uniform": decodes, "general": 0}:
            fail(f"{name}: B2 did not take the uniform chain: "
                 f"{runs['b2_chains']}")
        for vcf in ["CNV.vcf.gz", *[f"{n}_CNV.vcf.gz" for n in PLANS]]:
            same_vcf(runs["cuda"]["out"] / vcf, runs["cpu"]["out"] / vcf)
        vcf = runs["cuda"]["out"] / "CNV.vcf.gz"
        calls = check_calls(vcf)
        common = [r[:2] + [r[7]] for r in vcf_records(vcf)[1]
                  if "COMMONCNV" in r[7].split(";")]
        if name == "common_cnvs" and not any(
                r[0] == GAIN[0] and int(r[1]) < GAIN[2] for r in common):
            fail(f"no COMMONCNV record over the common-CNV interval: "
                 f"{common}")
        out[name] = {"vcf_cuda_equals_cpu": True,
                     "launches": runs["launches"],
                     "b2_chains": runs["b2_chains"], "calls": calls,
                     "common_cnv_records": common,
                     **{dev: {"wall_s": runs[dev]["wall_s"],
                              "stages": runs[dev]["stages"]}
                        for dev in ("cuda", "cpu")}}
    out["launches"] = {k: out["hmm"]["launches"][k]
                       + out["common_cnvs"]["launches"][k]
                       for k in out["hmm"]["launches"]}
    return out


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
    CPU (float32 row sums in position order, rounded): equal bins, both
    times."""
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


def joint_coverage(seed: int, lengths: list[int]) -> tuple[dict, dict]:
    """[T, 3] coverage a contig (father, mother, proband): the proband is
    wgs_coverage's, each parent fresh NB(WGS_MEAN) coverage carrying a
    seeded half of the proband's events (every N-gap).  Returns (coverage,
    the proband's events)."""
    proband, events = wgs_coverage(seed, lengths)
    scale = {kind: sc for kind, sc, _lo, _hi in WGS_EVENTS}
    rng = np.random.default_rng(seed + 60)
    p = WGS_NB_SIZE / (WGS_NB_SIZE + WGS_MEAN)
    cov = {}
    for name, c in proband.items():
        parents = []
        for _ in range(2):
            x = rng.negative_binomial(WGS_NB_SIZE, p, len(c)).astype(
                np.float64)
            for kind, s0, e in events[name]:
                if kind != "n_gap" and rng.random() < 0.5:
                    continue
                if scale[kind]:
                    q = WGS_NB_SIZE / (WGS_NB_SIZE + WGS_MEAN * scale[kind])
                    x[s0:e] = rng.negative_binomial(WGS_NB_SIZE, q, e - s0)
                else:
                    x[s0:e] = 0.0
            parents.append(x)
        cov[name] = np.stack([*parents, c], axis=1)
    return cov, events


def phase_joint_decode(seed: int, dev: torch.device,
                       lengths: list[int] = HG38) -> dict:
    """The joint multi-sample HMM of a trio at whole-genome size on the
    card, held against the plain decode (card) and the CPU emissions."""
    from canvas_tpu_torch.ops import hmm
    from canvas_tpu_torch.ops import viterbi_cuda as vc

    t0 = time.perf_counter()
    cov, events = joint_coverage(seed, lengths)
    secs = {"generate": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for c in cov.values():
        hmm.build_emission_tables(c)
    secs["tables"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live, live_len, em, mask, lt, li = hmm.joint_emissions(cov, device=dev)
    torch.cuda.synchronize()
    secs["emissions"] = time.perf_counter() - t0
    B, T, S = em.shape
    if (B, T, S) != (32, 524_288, 5):
        fail(f"joint emission shape {(B, T, S)} is not the production shape")
    rows = hmm._lane_lengths(live, live_len, B)
    reset_launches()
    t0 = time.perf_counter()
    path_k = hmm.viterbi_decode_chunked(em, mask, lt, li, chunk=CHUNK,
                                        lengths=rows)
    torch.cuda.synchronize()
    secs["decode"] = time.perf_counter() - t0
    launches = read_launches()
    if any(launches[k] != 1 for k in DECODE_KERNELS):
        fail(f"the joint decode launched {launches}, not one B2, K5, B3 "
             f"and K6")
    path_p = hmm.viterbi_decode_chunked(em, mask, lt, li, chunk=CHUNK,
                                        plain=True, lengths=rows)
    if not torch.equal(path_k, path_p):
        n = int((path_k != path_p).sum())
        fail(f"joint paths differ from the plain decode at {n} bins")
    del path_p
    t0 = time.perf_counter()
    em_cpu = hmm.joint_emissions(cov, device="cpu")[2]
    secs["emissions_cpu"] = time.perf_counter() - t0
    if not torch.equal(em.cpu().view(torch.int32), em_cpu.view(torch.int32)):
        n = int((em.cpu() != em_cpu).any(dim=-1).sum())
        fail(f"joint emissions on the card differ from the CPU at {n} bins")
    tied = bool(torch.equal(em[..., 0], em[..., 1])
                and torch.equal(em[..., 3], em[..., 4]))
    del em_cpu, em
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bps = hmm.segment_coverage_joint_batched(cov, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    secs["segment_coverage_joint_batched"] = time.perf_counter() - t0
    paths = path_k.cpu().numpy()
    for b, name in enumerate(live):
        if bps[name] != hmm.breakpoints_from_path(paths[b, :live_len[name]]):
            fail(f"{name}: segment_coverage_joint_batched's breakpoints "
                 f"differ from its decode's")
    dist = []
    for name, evs in events.items():
        b = np.asarray(bps[name])
        for _kind, s0, e in evs:
            dist.extend(int(np.abs(b - at).min()) for at in (s0, e))
    dist = np.asarray(dist)
    n_bins = sum(len(c) for c in cov.values())
    return {"phase": "joint-decode", "contigs": len(cov), "samples": 3,
            "bins": n_bins, "shape": [B, T, S], "chunk": CHUNK,
            "coverage_bytes": 8 * 3 * n_bins,
            "emission_bytes": 4 * B * T * S,
            "paths_equal_plain": True, "emissions_equal_cpu": True,
            "states_0_1_and_3_4_tied": tied, "launches": launches,
            "b2_chain": "uniform" if vc.uniform_transitions(lt) is not None
            else "general",
            "non_diploid_bins": int(((path_k != 2) & mask).sum()),
            "breakpoints": sum(len(v) for v in bps.values()),
            "event_ends": len(dist),
            "within_miss_bins_share": float((dist <= WGS_MISS_BINS).mean()),
            "within_2_share": float((dist <= 2).mean()),
            "host_s": secs}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_processes(code: str, n: int, args: list[str], workdir: Path,
                  tag: str) -> list[dict]:
    """n processes `python -c code *args 127.0.0.1:<port> n rank` from the
    repo root, joined within MP_JOIN_S seconds (else every one is killed
    and the phase fails); each must exit 0 and print one JSON line last,
    which is returned with its seconds."""
    addr = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(n):
        out = open(workdir / f"{tag}{rank}.out", "w+")
        err = open(workdir / f"{tag}{rank}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args, addr, str(n), str(rank)],
            cwd=REPO, stdout=out, stderr=err, text=True))
    try:
        for proc in procs:
            proc.wait(timeout=max(MP_JOIN_S - (time.perf_counter() - t0),
                                  1))
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.wait()
        fail(f"{tag}: a process did not finish within {MP_JOIN_S} s")
    res = []
    for rank, (proc, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        text, errs = out.read(), err.read()
        out.close()
        err.close()
        if proc.returncode != 0:
            fail(f"{tag}: process {rank} exited {proc.returncode}: "
                 f"{errs[-3000:]}")
        res.append({**json.loads(text.strip().splitlines()[-1]),
                    "stderr_tail": errs.strip().splitlines()[-2:]})
    return res


GERMLINE_PROCESS = """
import json, sys
from canvas_tpu_torch.ops import prefix_cuda, viterbi_cuda, arc_scan_cuda
from canvas_tpu_torch.pipeline import cli

bam, ref, out, addr, n, rank = sys.argv[1:7]
rc = cli.main(["Germline-WGS", "-b", bam, "-n", "proband", "-r", ref,
               "-o", out + rank, "--device", "cuda", "--coordinator", addr,
               "--num-processes", n, "--process-id", rank])
launches = {**prefix_cuda.LAUNCHES, **viterbi_cuda.LAUNCHES,
            **arc_scan_cuda.LAUNCHES}
print(json.dumps({"rc": rc, "launches": launches}))
raise SystemExit(rc)
"""


def phase_e2e_multiprocess(workdir: Path) -> dict:
    """Germline-WGS on the trio's proband in 2 gloo processes on cuda:0,
    each VCF equal to phase e2e-germline's cuda VCF."""
    n = 2
    out = workdir / "mp_germline_"
    t0 = time.perf_counter()
    res = run_processes(GERMLINE_PROCESS, n,
                        [str(workdir / "proband.bam"), str(workdir / "ref"),
                         str(out)], workdir, "mp")
    wall = time.perf_counter() - t0
    want = vcf_body(workdir / "germline_cuda" / "proband_CNV.vcf.gz")
    procs, owned = [], []
    for rank, r in enumerate(res):
        d = Path(f"{out}{rank}")
        if vcf_body(d / "proband_CNV.vcf.gz") != want:
            fail(f"process {rank}'s VCF differs from the one-process run")
        prof = json.loads((d / "proband_profile.json").read_text())
        scan = [st for st in prof["stages"] if st["name"] == "CanvasBinScan"]
        if len(scan) != 1 or scan[0]["processes"] != n:
            fail(f"process {rank} did not split its scan: {scan}")
        owned.extend(scan[0]["contigs"])
        procs.append({"process": rank, "contigs": scan[0]["contigs"],
                      "launches": r["launches"],
                      "stages": {st["name"]: st["seconds"]
                                 for st in prof["stages"]
                                 if st["name"] != "CanvasBinScan"},
                      "stderr_tail": r["stderr_tail"]})
    if sorted(owned) != sorted(TRIO_CONTIGS):
        fail(f"the processes' contigs {owned} are not the genome's")
    launches = {k: sum(p["launches"][k] for p in procs)
                for k in procs[0]["launches"]}
    if launches["prefix_scan"] != n * len(TRIO_CONTIGS):
        fail(f"B1 launched {launches['prefix_scan']} times, not once a "
             f"contig in each process")
    return {"phase": "e2e-multiprocess", "processes": n,
            "device_count": torch.cuda.device_count(),
            "mesh": ["cuda:0"] * n, "backend": "gloo",
            "vcf_equals_one_process": True, "wall_s": wall,
            "launches": launches, "by_process": procs}


def _mesh_runs(fn, data, runs: dict) -> tuple[dict, dict]:
    """fn(data, chunk=CHUNK, **kw) for each named kw of `runs`, counts set
    to 0 before each: (breakpoints, seconds and the decode's launches)."""
    bps, info = {}, {}
    for name, kw in runs.items():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        bps[name] = fn(data, chunk=CHUNK, **kw)
        torch.cuda.synchronize()
        got = read_launches()
        info[name] = {"s": time.perf_counter() - t0,
                      "launches": {k: got[k] for k in DECODE_KERNELS}}
    return bps, info


def phase_mesh_decode(seed: int, dev: torch.device,
                      lengths: list[int] = HG38) -> dict:
    """The whole-genome PerSampleHMM and joint decodes unsplit, over the
    virtual mesh [cuda:0] * MESH_N and over the visible cards."""
    from canvas_tpu_torch.ops import hmm
    from canvas_tpu_torch.parallel import mesh

    n_dev = torch.cuda.device_count()
    virtual = [dev] * MESH_N
    runs = {"unsplit": {"device": dev}, "virtual": {"devices": virtual},
            "visible": {"device": "cuda"}}
    meshes = {"unsplit": [str(dev)], "virtual": [str(d) for d in virtual],
              "visible": [str(d) for d in mesh.lane_devices("cuda")]}
    t0 = time.perf_counter()
    cov, _ = wgs_coverage(seed, lengths)
    joint, _ = joint_coverage(seed, lengths)
    gen_s = time.perf_counter() - t0
    out = {"phase": "mesh-decode", "device_count": n_dev, "meshes": meshes,
           "contigs": len(cov), "bins": sum(len(c) for c in cov.values()),
           "generate_s": gen_s}
    launches = dict.fromkeys(DECODE_KERNELS, 0)
    for kind, fn, data in (("per_sample", hmm.segment_coverage_batched, cov),
                           ("joint", hmm.segment_coverage_joint_batched,
                            joint)):
        bps, info = _mesh_runs(fn, data, runs)
        for name in runs:
            if bps[name] != bps["unsplit"]:
                diff = [c for c in bps["unsplit"]
                        if bps[name][c] != bps["unsplit"][c]]
                fail(f"{kind}: the {name} decode's breakpoints differ on "
                     f"{diff[:6]}")
            want = {"unsplit": 1, "virtual": MESH_N,
                    "visible": len(meshes["visible"])}[name]
            if set(info[name]["launches"].values()) != {want}:
                fail(f"{kind}, {name}: launches {info[name]['launches']}, "
                     f"{want} of B2, K5, B3 and K6 expected")
            for k in launches:
                launches[k] += info[name]["launches"][k]
        lanes = hmm._next_pow2(max(len(data), MESH_N))
        out[kind] = {**info, "lanes": lanes, "lanes_a_group": lanes // MESH_N,
                     "breakpoints": sum(len(v) for v in
                                        bps["unsplit"].values()),
                     "equal": True}
    del cov, joint
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def mesh_tracks(seed: int) -> dict:
    """chr1-chr4 tracks from seed: 80 % possible, 41 % G/C, read starts 0,
    1 or 2 at about 30 %, offset 10,000."""
    rng = np.random.default_rng(seed + 70)
    tracks = {}
    for i, length in enumerate(HG38[:BIN_MESH_CONTIGS]):
        b = np.frombuffer(rng.bytes(length), np.uint8)
        obs = (b < 77).astype(np.uint8) + (b < 10)
        tracks[f"chr{i + 1}"] = {
            "possible": np.frombuffer(rng.bytes(length), np.uint8) < 205,
            "observed": obs,
            "is_gc": np.frombuffer(rng.bytes(length), np.uint8) < 105,
            "offset": 10_000}
    return tracks


def phase_bin_mesh(seed: int, dev: torch.device) -> dict:
    """bin_sample on chr1-chr4 round-robin over [cuda:0] * MESH_N, then
    unsplit on cuda:0, then over the visible cards: equal bins, seconds
    and B1 launches."""
    from canvas_tpu_torch.ops import binning

    t0 = time.perf_counter()
    tracks = mesh_tracks(seed)
    gen_s = time.perf_counter() - t0
    from canvas_tpu_torch.parallel import mesh

    virtual = [dev] * MESH_N
    res, info = {}, {}
    for name, kw in (("virtual", {"devices": virtual}),
                     ("unsplit", {"device": dev}),
                     ("visible", {"device": "cuda"})):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res[name] = binning.bin_sample(tracks, 100, **kw)
        torch.cuda.synchronize()
        info[name] = {"s": time.perf_counter() - t0,
                      "launches": read_launches()["prefix_scan"]}
        if info[name]["launches"] != BIN_MESH_CONTIGS:
            fail(f"bin-mesh {name}: B1 launched {info[name]['launches']} "
                 f"times for {BIN_MESH_CONTIGS} contigs")
    for c in tracks:
        for name in ("virtual", "visible"):
            for field, a, b in zip(("start", "end", "gc", "count"),
                                   res[name][c], res["unsplit"][c]):
                if not np.array_equal(a, b):
                    fail(f"bin-mesh: {c} {field} differs between the "
                         f"{name} mesh and one device")
    placement = binning.contig_placement(tracks, list(range(MESH_N)))
    bins = sum(len(v[0]) for v in res["unsplit"].values())
    binning._DEVICE_TRACKS.clear()
    torch.cuda.empty_cache()
    return {"phase": "bin-mesh", "device_count": torch.cuda.device_count(),
            "mesh": [str(d) for d in virtual],
            "visible": [str(d) for d in mesh.lane_devices("cuda")],
            "placement": placement,
            "positions": sum(len(t["possible"]) for t in tracks.values()),
            "bin_size": 100, "bins": bins, "equal": True,
            "generate_s": gen_s,
            "launches": sum(v["launches"] for v in info.values()),
            "runs": info,
            "note": "the first run packs and copies the reference tracks"}


def phase_dryrun(dev: torch.device) -> dict:
    """graft_entry.dryrun_multichip over [cuda:0] * MESH_N, then entry()'s
    step once on the card against the CPU."""
    import contextlib
    import io

    from canvas_tpu_torch import graft_entry

    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(MESH_N, devices=[dev] * MESH_N)
    torch.cuda.synchronize()
    dryrun_s = time.perf_counter() - t0
    launches = read_launches()
    # the mesh run: B1 a contig and sample, each decode kernel a lane group
    # and sample; the synthetic step each decode kernel once a lane
    n_c, n_s = len(graft_entry.TRIO_CONTIGS), len(graft_entry.TRIO_PLANS)
    need = {"prefix_scan": 2 * n_c * n_s,
            **{k: MESH_N + MESH_N * n_s + n_s for k in DECODE_KERNELS}}
    got = {k: launches[k] for k in need}
    if got != need:
        fail(f"dryrun launched {got}, the mesh path needs {need}")
    fn, args = graft_entry.entry()
    reset_launches()
    t0 = time.perf_counter()
    states = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    entry_launches = read_launches()
    want = fn(*(a.cpu() for a in args))
    if not torch.equal(states.cpu(), want):
        fail("entry()'s step on the card differs from the CPU")
    for k in DECODE_KERNELS:
        launches[k] += entry_launches[k]
    return {"phase": "dryrun", "device_count": torch.cuda.device_count(),
            "mesh": [str(dev)] * MESH_N, "messages": buf.getvalue().split("\n")[:-1],
            "dryrun_s": dryrun_s, "entry_s": entry_s,
            "entry_shape": list(states.shape),
            "entry_equals_cpu": True, "launches": launches}


GATHER_PROCESS = """
import json, sys, time
import numpy as np
from canvas_tpu_torch.parallel import distributed

seed, lengths, addr, n, rank = sys.argv[1:6]
lengths = json.loads(lengths)
distributed.initialize(addr, int(n), int(rank))

def contig(i, name):
    rng = np.random.default_rng([int(seed), i])
    return np.frombuffer(rng.bytes(lengths[name]), np.uint8)

mine = distributed.my_contigs(lengths)
t0 = time.perf_counter()
local = {c: contig(i, c) for i, c in enumerate(lengths) if c in mine}
gen_s = time.perf_counter() - t0
t0 = time.perf_counter()
out = distributed.all_gather_host_data(
    local, {c: (L, np.uint8) for c, L in lengths.items()})
gather_s = time.perf_counter() - t0
equal = sorted(out) == sorted(lengths) and all(
    np.array_equal(out[c], local[c] if c in local else contig(i, c))
    for i, c in enumerate(lengths))
distributed.shutdown()
print(json.dumps({"contigs": mine, "local_bytes": sum(
    len(v) for v in local.values()), "bytes": sum(len(v) for v in
    out.values()), "generate_s": gen_s, "gather_s": gather_s,
    "equal": equal}))
"""


def phase_gather(seed: int, workdir: Path) -> dict:
    """all_gather_host_data at whole-genome size in 2 gloo processes."""
    import os

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    lengths = {f"chr{i + 1}": L for i, L in enumerate(HG38)}
    cut = []
    if ram < 32e9:
        # each process holds its half and the whole: keep the longest
        # contigs within a sixth of the RAM
        keep, total = {}, 0
        for c in sorted(lengths, key=lambda c: -lengths[c]):
            if total + lengths[c] <= ram / 6:
                keep[c] = lengths[c]
                total += lengths[c]
            else:
                cut.append(c)
        lengths = keep
    n = 2
    t0 = time.perf_counter()
    res = run_processes(GATHER_PROCESS, n, [str(seed), json.dumps(lengths)],
                        workdir, "gather")
    wall = time.perf_counter() - t0
    if not all(r["equal"] for r in res):
        fail("the gathered data differ from the full data")
    return {"phase": "gather", "device_count": torch.cuda.device_count(),
            "mesh": [], "processes": n, "backend": "gloo",
            "host_ram_bytes": ram, "contigs": len(lengths),
            "contigs_cut": cut, "bytes_a_process": sum(lengths.values()),
            "equal": True, "wall_s": wall, "by_process": res}


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
    if not (REPO / "canvas_tpu_torch").is_dir():
        fail(f"no canvas_tpu_torch package beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
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

    build = run("build", phase_build)
    b1 = run("B1", phase_b1, args.seed, dev)
    b2, b3, k5, k6 = run("B2/B3", phase_b2_b3, args.seed, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        e2e = run("e2e", phase_e2e, args.seed, Path(workdir))
        germ = run("e2e-germline", phase_e2e_germline, Path(workdir))
        joint = run("e2e-joint", phase_e2e_joint, Path(workdir))
        mp = run("e2e-multiprocess", phase_e2e_multiprocess, Path(workdir))
    b4 = run("B4", phase_b4, args.seed, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_enr_") as workdir:
        enr, panel = run("e2e-enrichment", phase_e2e_enrichment, args.seed,
                         Path(workdir))
        frontier = run("CBS", phase_cbs, Path(workdir), dev)
        mega = run("cbs-mega", phase_cbs_mega, Path(workdir), dev,
                   frontier)
        stats = run("cbs-stats", phase_cbs_stats, Path(workdir), dev,
                    build["k11_erfc"], build["k11_series_term"])
        swgs = run("e2e-somatic-wgs", phase_e2e_somatic_wgs, panel,
                   Path(workdir))
    run("gc-bin", phase_gc_bin, args.seed, dev)
    torch.cuda.empty_cache()
    run("wgs-partition", phase_wgs_partition, args.seed)
    torch.cuda.empty_cache()
    run("joint-decode", phase_joint_decode, args.seed, dev)
    torch.cuda.empty_cache()
    mdec = run("mesh-decode", phase_mesh_decode, args.seed, dev)
    bmesh = run("bin-mesh", phase_bin_mesh, args.seed, dev)
    dry = run("dryrun", phase_dryrun, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as workdir:
        run("gather", phase_gather, args.seed, Path(workdir))
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
                      + joint["launches"]["prefix_scan"]
                      + swgs["launches"]["prefix_scan"]
                      + mp["launches"]["prefix_scan"]
                      + bmesh["launches"]
                      + dry["launches"]["prefix_scan"]), **_timing(b1)},
        *[{"name": name, "route": "cuda",
           "source": "canvas_tpu_torch/csrc/viterbi.cu",
           "replaces": f"canvas_tpu/ops/viterbi_pallas.py:{line}",
           "launches": (launches[name] + joint["launches"][name]
                        + mp["launches"][name] + mdec["launches"][name]
                        + dry["launches"][name]),
           **_timing(res)}
          for name, line, res in (("chunk_matrix", 100, b2),
                                  ("forward_backtrack", 139, b3),
                                  ("chunk_scan", 285, k5),
                                  ("chunk_chase", 323, k6))],
        {"name": "arc_scan", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/arc_scan.cu",
         "replaces": "canvas_tpu/ops/cbs_device.py:200",
         "launches": enr["traced_launches"]["arc_scan"],
         **_timing(top), "max_abs_err": max(sh["max_abs_err"]
                                            for sh in b4["shapes"])},
        *[{"name": name, "route": "cuda",
           "source": "canvas_tpu_torch/csrc/cbs_mega.cu",
           "replaces": f"canvas_tpu/ops/cbs_mega.py:{line}",
           "launches": enr["traced_launches"][name], **_timing(mega[key])}
          for name, line, key in (("walk", 419, "K7"), ("edge", 217, "K8"))],
        *[{"name": name, "route": "cuda",
           "source": "canvas_tpu_torch/csrc/cbs_stats.cu",
           "replaces": f"canvas_tpu/ops/cbs_device.py:{line}",
           "launches": enr["traced_launches"][name], **_timing(res)}
          for name, line, res in (("arc_inputs", 382, stats["K9_top"]),
                                  ("refine", 421, stats["K10_top"]))],
        # K11 on the main path is the launch that carries K14; the frontier
        # engine's (phase CBS) is K11 alone
        {"name": "tail_p", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/cbs_stats.cu",
         "replaces": "canvas_tpu/ops/cbs_device.py:497",
         "launch": "tail_decide_kernel (with K14); tail_kernel (frontier)",
         "launches": (enr["traced_launches"]["tail_decide"]
                      + frontier["launches"]["tail_p"]),
         **_timing(stats["K11"])},
        {"name": "decide", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/cbs_stats.cu",
         "replaces": "canvas_tpu/ops/cbs_mega.py:399",
         "launch": mega["K14"]["launch"],
         "launches": enr["traced_launches"]["tail_decide"],
         "added_ms": mega["K14"]["added_ms"], **_timing(mega["K14"])},
        *[{"name": name, "route": "cuda",
           "source": "canvas_tpu_torch/csrc/cbs_level.cu",
           "replaces": f"canvas_tpu/ops/cbs_mega.py:{line}",
           "launches": enr["traced_launches"][name], **_timing(mega[key])}
          for name, line, key in (("prologue", 335, "K13"),
                                  ("edge_setup", 174, "K15"))],
        {"name": "table", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/cbs_level.cu",
         "replaces": "canvas_tpu/ops/cbs_mega.py:468",
         "launch": mega["K16"]["launch"],
         "launches": enr["traced_launches"]["keep_table"],
         **_timing(mega["K16"])},
        {"name": "perm_stats", "route": "cuda",
         "source": "canvas_tpu_torch/csrc/cbs_mega.cu",
         "replaces": "canvas_tpu/ops/cbs_device.py:661",
         "launches": frontier["launches"]["perm"],
         **_timing(stats["K12"]["level"])},
    ]
    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
