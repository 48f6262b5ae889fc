"""Time kernels K7 (walks) and K8 (edge tests) of csrc/cbs_mega.cu on one
CUDA card, beside another build of the source: an earlier design, or the
same source with a part taken out to see what the rest costs; with --k12,
kernel K12 (the frontier's permutation chunks) the same way; with --k13
and --k15, kernels K13 (the CBS level's prologue) and K15 (the edge
tests' set-up) of csrc/cbs_level.cu; with --k14 --k16, K11 carrying K14
(csrc/cbs_stats.cu) and K15's keep flags with K16 (csrc/cbs_level.cu).

    python3 -m canvas_tpu_torch.tools.cbs_kernel_variants \\
        [--old PATH [--old-parts]] [--no-committed] [--reps N] [--k12]
        [--k13] [--k15] [--k14 --k16]

The inputs are made from a seed, shaped like the first walking and
edge-testing levels of chip_smoke.py's panel (Tumor-normal-enrichment,
three contigs of about 19,930 bins): K7 on 32 rows at Tmax 32,768, two of
them walking (hybrid, n 2,476 and 4,810); K8 on 64 lanes (32 rows, two
edges each), two of them active (wn 2,474, m1 2); K7 also on the same 32
rows all walking (n 2,000-8,000 from the seed: many rounds a block).  Each row and lane
runs a fixed number of chunks whatever its statistics (K7: ostat +inf and
a boundary no count reaches, so a walk ends at n_perm = 1,024, two
chunks; K8: ostat +inf, so a lane runs all 20 chunks of n_perm = 10,000),
so a variant that changes the statistics does the same amount of work.

--parts builds the committed source with each edit of PARTS, a part taken
out (or, where marked exact, written another way), and times it too.

--k12 times K12 instead, on launches shaped like chip_smoke.py's captured
calls: one row under the mask of 2,476 bins at width 4,096 with P 768 (the
panel's first frontier level with a chunk), one of 7,593 at 8,192 with
P 512 (bench.py's first continuation chunk), 33 rows of 3,000 at 4,096
with P 768 (many rounds a block), and one row of 12,000 at 16,384 with
P 768 and with P 512; with --parts, each edit of K12_PARTS too (the
exact ones must give the committed statistics); with --old PATH, the K12
of a cbs_mega.cu with the same cbs_perm entry point (an earlier commit's)
as it is.

--k13 and --k15 time K13 and K15 on the first level of three inputs,
recorded from an eager engine run on the card (the wrappers' arguments):
one shaped like chip_smoke.py's panel (three contigs of 19,921, 19,941
and 19,923 bins of N(0, 1) with steps, from the seed; Tmax 32,768, W
32), bench.py's CBS workload (24 x 16,384 bins, W 64) and the engine's
largest shape (192 x 65,536 bins, W 512).  Each build must give its
plain version's outputs bit for bit.  The builds: the committed source
and, with --old PATH, an earlier cbs_level.cu (a block a row or lane;
its K15 takes no scratch), as it is.

--k14 --k16 time, on the same three cases' first level, K11 carrying
K14 (one cooperative launch), K11 alone on the same rows (K14's added
time is the difference), and K15's keep flags with K16 (one launch, its
table and pending flags put back by two copies before each call, timed
alone too); with --old DIR, the design before them built from DIR's
cbs_stats.cu and cbs_level.cu (for example written by `git show
<commit>:canvas_tpu_torch/csrc/cbs_stats.cu` and the same for
cbs_level.cu): K14's two launches around K11, and K15's keep launch and
K16's, the keep alone too.  Each must give the chained plain versions'
outputs bit for bit (decide_prep_plain, tail_p_plain, decide_plain;
edge_keep_plain, table_update_plain).  Each is timed eagerly and as a
CUDA graph replayed, and both groups in one graph.

--old PATH takes, without --k13, --k15 or --k14, a cbs_mega.cu whose entry
points take one threefry key a row (the design that gives a whole block
to each permutation and draws K7's keys twice), for example one written
by `git show <commit>:canvas_tpu_torch/csrc/cbs_mega.cu`.  It is built as
it is and, with --old-parts, with each edit of OLD_VARIANTS, under its
own name in canvas_tpu_torch/_build/variants/, and handed the keys that
the committed kernels derive on the card (ops/cbs_mega_cuda.seg_keys and
edge_keys), so every exact build must give the committed kernels' flags,
counts and statistics.  The builds are compiled in parallel.  Every
build is timed twice, in the order committed, builds, builds reversed,
committed, with CUDA events (a sleep kernel holds the stream while the
calls are queued).  Prints one JSON line a build and kernel, and last
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from canvas_tpu_torch.ops import cbs_level_cuda as cl
from canvas_tpu_torch.ops import cbs_mega_cuda as mc
from canvas_tpu_torch.ops import cuda_lib

VARIANT_DIR = cuda_lib.BUILD_DIR / "variants"

_P = ctypes.c_void_p
_I = ctypes.c_int
# the entry points of a source that takes one key a row
OLD_SIGNATURES = {
    "cbs_walk": [_P] * 15 + [_I] * 8 + [_P],
    "cbs_edge": [_P] * 14 + [_I] * 4 + [_P],
}


def replace(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError(f"variant edit not found: {old!r}")
        return src.replace(old, new)
    return edit


def chain(*edits):
    def edit(src: str) -> str:
        for e in edits:
            src = e(src)
        return src
    return edit


_HASH = "(uint32_t(j) * 2654435761u + uint32_t(p) * 40503u)"
# edits of the one-key-a-row source; "exact" builds must equal the
# committed kernels, the others drop work and give other statistics
OLD_VARIANTS = {
    "as it is": (None, True),
    "K7 without draws (a hash of j and p instead)": (chain(
        replace("atomicAdd(&hist[(draw_bits(key, base + j) >> 9) >> shift], "
                "1u);", f"atomicAdd(&hist[({_HASH} >> 9) >> shift], 1u);"),
        replace("const uint32_t m = draw_bits(key, base + j) >> 9;",
                f"const uint32_t m = {_HASH} >> 9;")), False),
    "K7 without the buckets' insertion sort": (replace(
        "for (int i = lo + 1; i < hi; ++i) {",
        "for (int i = hi; i < hi; ++i) {"), False),
    "K7 without thread 0's lag terms": (replace(
        "    if (tid == 0)\n      for (int li = 0; li < nl; ++li)",
        "    if (tid == 0 && n < 0)\n      for (int li = 0; li < nl; ++li)"),
        False),
    "K7 without the statistic (no lags)": (replace(
        "  const float nf = float(n);\n  float best = 0.0f;\n  for (int L0",
        "  lend = al0 - 1;\n  const float nf = float(n);\n"
        "  float best = 0.0f;\n  for (int L0"), False),
    "K8 without draws (a hash of j and p instead)": (replace(
        "buf[j] = draw_bits(key, base + j);", f"buf[j] = {_HASH};"), False),
    "K8 without the radix select": (replace(
        "const uint32_t tau = radix_select(buf, wn, m1, s.hist, s.misc);",
        "const uint32_t tau = 0x00100000u;"), False),
    "K8 without the select and the subset sum": (chain(
        replace("const uint32_t tau = radix_select(buf, wn, m1, s.hist, "
                "s.misc);", "const uint32_t tau = 0x00100000u;"),
        replace("const float sum = subset_sum(a.xw + size_t(l) * a.Tmax, "
                "wn, m1, tau,\n                                   buf, "
                "s.red_d, s.red_u);", "const float sum = float(tau);")),
        False),
}


_NETWORK = "    if (hi - lo <= 8) {"
_NO_NETWORK = replace(_NETWORK, "    if (false) {")
# edits of the committed source, each taking a part out (or, where exact,
# writing it another way that must give the same results)
PARTS = {
    "K7 without draws (a hash of j and p instead)": (chain(
        replace("    const uint32_t m = draw_bits(key, base + j) >> 9;\n"
                "    if (mode == kDouble)",
                f"    const uint32_t m = {_HASH} >> 9;\n"
                "    if (mode == kDouble)"),
        replace("      m = draw_bits(key, base + j) >> 9;",
                f"      m = {_HASH} >> 9;")),
        False),
    "K7 without the buckets' sort": (replace(
        _NETWORK, "    if (lo < hi) continue;\n" + _NETWORK), False),
    "K7 with insertion sorts only (no network)": (_NO_NETWORK, True),
    "K7 without the gather of x (a hash of the word instead)": (replace(
        ": __ldg(xrow + (buf[kb + q] & 0xFFFFu));",
        ": __uint_as_float(0x3F800000u | ((buf[kb + q]"
        " * 2654435761u) >> 9)) - 1.5f;"), False),
    "K7 with two buffers where the budget holds them (fewer groups, "
    "each key drawn once)": (replace(
        "  } else {\n    l.mode = kSingle;\n"
        "    l.bytes = align16(kHead7 + 4 * (nb + npad));\n  }",
        "  } else if (kHead7 + 4 * (nb + 2 * npad) <= kGroupBudget) {\n"
        "    l.mode = kDouble;\n"
        "    l.bytes = align16(kHead7 + 4 * (nb + 2 * npad));\n"
        "  } else {\n    l.mode = kSingle;\n"
        "    l.bytes = align16(kHead7 + 4 * (nb + npad));\n  }"), True),
    "K7 with runs of 9 positions in the statistic": (replace(
        "constexpr int kRun = 5;", "constexpr int kRun = 9;"), True),
    "K7 and K8 with up to 15 groups a block": (replace(
        "constexpr int kMaxGroups = 8;", "constexpr int kMaxGroups = 15;"),
        True),
    "K7 and K8 with blocks of 768 threads (85 registers a thread)": (
        replace("constexpr int kThreads = 1024;",
                "constexpr int kThreads = 768;"), True),
    "K7 with one group a block": (replace(
        "  const int k = kGroupBudget / l.bytes;\n"
        "  l.k = l.mode == kSlab ? 1 : (k > kMaxGroups ? kMaxGroups : k);\n"
        "  return l;\n}\n\n// The buffers of a K7 item",
        "  l.k = 1;\n  return l;\n}\n\n// The buffers of a K7 item"), True),
    "K7 without the cumsum's second pass (cs[k] = k)": (replace(
        "    acc += double(__uint_as_float(buf[k]));\n"
        "    buf[k] = __float_as_uint(__double2float_rn(acc));",
        "    acc += double(__uint_as_float(buf[k]));\n"
        "    buf[k] = __float_as_uint(float(k));"), False),
    "K7 without the statistic (no lags)": (replace(
        "  float best = 0.0f;\n  for (int L0 = al0;",
        "  float best = 0.0f;\n  lend = al0 - 1;\n  for (int L0 = al0;"),
        False),
    "K8 one chunk a lane an iteration": (replace(
        "depth = max(1, min(min(depth, kMaxDepth), chunks_all - c0));",
        "depth = 1;"), True),
    "K8 without draws (a hash of j and p instead)": (replace(
        "const uint32_t b = draw_bits(key, base + j);",
        f"const uint32_t b = {_HASH};"), False),
}


_K12_MAXT = ("    const float st = max_t(g, s, reinterpret_cast<const float*>"
             "(s.B), n,\n                           a.npad, a.tss[r], "
             "a.hybrid[r], a.al0, a.kmax,\n                           "
             "a.max_len);")
_K12_CUMSUM = ("    if (staged)\n      permuted_cumsum<true>(g, s, "
               "reinterpret_cast<const float*>(s.A), n);\n    else\n"
               "      permuted_cumsum<false>(g, s, xrow, n);\n")
_K12_PERMUTE = ("    permute(g, s, l.mode, key, n, a.npad, p, staged ? xrow : "
                "nullptr);\n")
_SCATTER = ("    const uint32_t slot = atomicAdd(&hist[m >> shift], 1u);\n"
            "    s.B[slot] = ((m & low) << 16) | uint32_t(j);\n")
_NO_STAT = replace(_K12_MAXT, "    const float st = 0.0f;")
_NO_CUMSUM = replace(_K12_CUMSUM, "")
_NO_SORT = replace(_NETWORK, "    if (lo < hi) continue;\n" + _NETWORK)
# edits of the committed source for K12 (--k12 --parts): parts taken out
# one after another from the end of an item's chain, then other layouts
K12_PARTS = {
    "K12 without the statistic": (_NO_STAT, False),
    "K12 without the statistic and the cumsum": (
        chain(_NO_STAT, _NO_CUMSUM), False),
    "K12 with only the draws, the bucket scan and the scatter": (chain(
        _NO_STAT, _NO_CUMSUM, _NO_SORT),
        False),
    "K12 with only the draws and the bucket scan": (chain(
        _NO_STAT, _NO_CUMSUM, _NO_SORT, replace(_SCATTER, "")), False),
    "K12 with an empty item": (chain(
        _NO_STAT, _NO_CUMSUM, replace(_K12_PERMUTE, "")), False),
    "K12 with insertion sorts only (no network)": (_NO_NETWORK, True),
    "K12 with two buffers only where they take a block's share in one "
    "round (no wide-row rule)": (replace(
        "(share <= kd || npad >= kWideRow)", "share <= kd"), True),
    "K12 with the row's values staged at every width": (replace(
        "  const bool staged = l.mode == kDouble && a.npad >= kWideRow;",
        "  const bool staged = l.mode == kDouble && a.npad >= 4;"), True),
    "K12 without the row's values staged": (replace(
        "  const bool staged = l.mode == kDouble && a.npad >= kWideRow;",
        "  const bool staged = false;"), True),
    "K12 with K7's groups of the width, one buffer": (replace(
        "  const Layout l = perm_layout(a.npad, nact * a.P, gridDim.x);",
        "  Layout l = k7_layout(a.npad);\n"
        "  l.bytes = (kPermBudget / l.k) & ~15;\n"
        "  l.mode = a.npad >= kSlabTier ? kSlab : kSingle;"), True),
}


def variant_libs(src_path: Path, edits: dict, prefix: str,
                 signatures: dict) -> dict:
    """{label: library} for each (label, edit) of edits: src_path with the
    edit (None: as it is) under its own name in VARIANT_DIR, the builds
    compiled in parallel."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    text = src_path.read_text()
    srcs = {}
    for label, edit in edits.items():
        name = prefix + re.sub(r"\W+", "_", label).strip("_").lower()
        src = VARIANT_DIR / f"{name}.cu"
        src.write_text(edit(text) if edit else text)
        srcs[label] = (name, src)
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda ns: cuda_lib.build(*ns), srcs.values()))
    return {label: cuda_lib.load(name, signatures, src)
            for label, (name, src) in srcs.items()}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card after one warm-up call, from
    CUDA events, with a sleep kernel holding the stream while the host
    queues the reps calls (the device's time, not the wrappers')."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * reps * host_s, 2.0) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def panel_like(dev: torch.device, seed: int) -> tuple[dict, dict, dict]:
    """(K7's arguments, K8's arguments, K7's arguments with every row
    walking) as the module docstring says."""
    rng = np.random.default_rng(seed)
    key0 = torch.tensor([0, seed], dtype=torch.int64, device=dev)
    W, Tmax = 32, 32768
    n = np.full(W, 2, np.int64)
    n[:2] = (2476, 4810)
    x = np.zeros((W, Tmax), np.float32)
    for r in range(2):
        v = rng.normal(0, 1, n[r])
        v[n[r] // 3:n[r] // 2] += 0.3
        x[r, :n[r]] = v - v.mean()
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    seg_c = t(np.arange(W) % 3)
    seg_lo = t(rng.integers(0, 15000, W))
    walk = {"x": t(x), "n": t(n),
            "tss": t((x.astype(np.float64) ** 2).sum(1).astype(np.float32)),
            "key0": key0, "seg_c": seg_c, "seg_lo": seg_lo,
            "walking": t(np.arange(W) < 2), "hybrid": t(n > 200),
            "ostat": torch.full((W,), float("inf"), device=dev),
            "nrejc": torch.full((W,), 20, dtype=torch.int64, device=dev),
            "sbdry": torch.full((600,), 1 << 40, dtype=torch.int64,
                                device=dev),
            "n_perm": 1024, "al0": 2, "kmax": 25, "n_min": 200}
    L = 2 * W
    wn = np.full(L, 2, np.int64)
    wn[[0, W]] = 2474
    m1 = np.full(L, 1, np.int64)
    m1[[0, W]] = 2
    xw = np.zeros((L, Tmax), np.float32)
    for lane in (0, W):
        xw[lane, :wn[lane]] = rng.normal(0, 1, wn[lane])
    xwt = t(xw)
    edge = {"xw": xwt, "wn": t(wn), "m1": t(m1),
            "xbar": xwt.double().sum(1).float() / t(wn).float(),
            "ostat": torch.full((L,), float("inf"), device=dev),
            "active": t(np.isin(np.arange(L), (0, W))),
            "key0": key0, "seg_c": seg_c, "seg_lo": seg_lo,
            "seg_n": t(rng.integers(3000, 9000, W)),
            "limit": torch.tensor(100.0, device=dev), "n_perm": 10000}
    nm = rng.integers(2000, 8001, W)
    xm = np.zeros((W, Tmax), np.float32)
    for r in range(W):
        v = rng.normal(0, 1, nm[r])
        v[nm[r] // 3:nm[r] // 2] += 0.3
        xm[r, :nm[r]] = v - v.mean()
    many = dict(walk, x=t(xm), n=t(nm),
                tss=t((xm.astype(np.float64) ** 2).sum(1).astype(np.float32)),
                walking=t(np.ones(W, bool)), hybrid=t(nm > 200))
    return walk, edge, many


def perm_like(dev: torch.device, seed: int) -> dict:
    """K12's arguments for the launches of the module docstring."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = {}
    for name, npad, n, P, rows in (("level", 4096, 2476, 768, 1),
                                   ("chunk", 8192, 7593, 512, 1),
                                   ("33 rows", 4096, 3000, 768, 33),
                                   ("16384", 16384, 12000, 768, 1),
                                   ("16384, P 512", 16384, 12000, 512, 1)):
        S = max(rows, 32 if npad == 4096 else 1)
        nn = np.full(S, 20, np.int64)
        nn[:rows] = n
        x = np.zeros((S, npad), np.float32)
        for r in range(S):
            v = rng.normal(0, 1, nn[r])
            v[: nn[r] // 3] += 0.3
            x[r, :nn[r]] = v - v.mean()
        out[name] = {"x": t(x), "n": t(nn),
                     "tss": t((x.astype(np.float64) ** 2).sum(1)
                              .astype(np.float32)),
                     "keys": t(rng.integers(0, 2 ** 32, (S, 2))),
                     "mask": t(np.arange(S) < rows), "hybrid": t(nn > 200),
                     "P": P, "al0": 2, "kmax": 25, "max_len": 200}
    return out


def perm_call(lib, args: dict, dev: torch.device):
    """A call of lib's K12 on args and the output it writes."""
    S, npad = args["x"].shape
    grid = mc.perm_grid(dev)
    slab = torch.empty(grid * npad if npad >= mc.SLAB_TIER else 1,
                       dtype=torch.int32, device=dev)
    out = torch.empty((S, args["P"]), dtype=torch.float32, device=dev)
    a = args

    def call():
        cuda_lib.check(cuda_lib.launch(
            dev, lib.cbs_perm, a["x"].data_ptr(), a["n"].data_ptr(),
            a["tss"].data_ptr(), a["keys"].data_ptr(), a["mask"].data_ptr(),
            a["hybrid"].data_ptr(), slab.data_ptr(), out.data_ptr(), S, npad,
            a["P"], a["al0"], a["kmax"], a["max_len"], grid), "cbs_perm")

    return call, out


def time_k12(args, dev: torch.device) -> int:
    """--k12: the committed K12 and, with --parts, K12_PARTS' builds, each
    on perm_like's launches, timed in turns (committed, builds, builds
    reversed, committed)."""
    cases = perm_like(dev, args.seed)
    builds = {"committed": (cuda_lib.load("cbs_mega", mc._SIGNATURES),
                            True)}
    if args.parts:
        libs = variant_libs(cuda_lib.CSRC_DIR / "cbs_mega.cu",
                            {k: e for k, (e, _x) in K12_PARTS.items()},
                            "cbs_mega_k12_", mc._SIGNATURES)
        for label, (_edit, exact) in K12_PARTS.items():
            builds[label] = (libs[label], exact)
    if args.old is not None:
        builds["old, as it is"] = (variant_libs(
            args.old, {"as it is": None}, "cbs_mega_old_k12_",
            {"cbs_perm": mc._SIGNATURES["cbs_perm"]})["as it is"], True)
    calls = {}
    for label, (lib, exact) in builds.items():
        for case, a in cases.items():
            call, out = perm_call(lib, a, dev)
            call()
            torch.cuda.synchronize()
            if exact and not torch.equal(
                    out.view(torch.int32),
                    mc.perm_stats_plain(**a).view(torch.int32)):
                raise SystemExit(f"cbs_kernel_variants: {label} differs "
                                 f"from the plain version on {case}")
            calls[label, case] = call
    times: dict = {k: {c: [] for c in cases} for k in builds}
    for label in list(builds) + list(reversed(builds)):
        for case in cases:
            times[label][case].append(cuda_ms(calls[label, case],
                                              args.reps))
    grid = mc.perm_grid(dev)
    for label, (_lib, exact) in builds.items():
        print(json.dumps({"build": label, "exact": exact,
                          "K12_ms": times[label]}), flush=True)
    print(json.dumps({"committed_layouts": {
        c: mc.perm_layout(a["x"].shape[1], int(a["mask"].sum()) * a["P"],
                          grid) for c, a in cases.items()}}), flush=True)
    print(gpu_line(), flush=True)
    return 0


LEVEL_CASES = ("panel", "bench_cbs", "largest")
# the earlier design's K15 set-up entry point, which takes no scratch
OLD_EDGE_SETUP = [_P] * 19 + [_I] * 3 + [_P]


def level_coverage(case: str, seed: int) -> dict:
    """The engine's input for a LEVEL_CASES case (module docstring)."""
    if case == "panel":
        rng = np.random.default_rng(seed)
        cov = {}
        for c, n in enumerate((19921, 19941, 19923)):
            v = rng.normal(0.0, 1.0, n)
            v[n // 5:n // 4] += 1.0
            v[n // 2:n // 2 + 3000] -= 0.8
            cov[f"chr{c + 1}"] = v
        return cov
    if case == "bench_cbs":
        rng = np.random.default_rng(1)
        T = 16 * 1024
        cov = {}
        for b in range(24):
            c = rng.normal(0.0, 1.0, size=T)
            c[T // 4: T // 3] += 1.5
            c[T // 2: T // 2 + 600] -= 1.2
            cov[f"chr{b}"] = c
        return cov
    rng = np.random.default_rng(3)
    return {f"chr{c}": rng.normal(0.0, 1.0, size=1 << 16)
            for c in range(192)}


_LEVEL_WRAPPERS = ("prologue", "edge_setup", "tail_decide", "keep_table")


def first_level_inputs(cov: dict, dev: torch.device) -> dict:
    """The arguments (cloned) of the first call of K13's and K15's
    wrappers, of K11 carrying K14 (tail_decide) and of keep_table (K15's
    keep flags with K16) in an eager engine run over cov on the card."""
    import functools

    from canvas_tpu_torch.ops import cbs_mega

    got: dict = {}
    orig = {k: getattr(cl, k) for k in _LEVEL_WRAPPERS}

    def recorder(name):
        def call(*args):
            got.setdefault(name, [a.clone() if torch.is_tensor(a) else
                                  {k: v.clone() for k, v in a.items()}
                                  if isinstance(a, dict) else a
                                  for a in args])
            return orig[name](*args)
        return call

    run = cbs_mega._mega_recurse
    cbs_mega._mega_recurse = functools.partial(run, graph=False)
    for k in _LEVEL_WRAPPERS:
        setattr(cl, k, recorder(k))
    try:
        cbs_mega.run_cbs_mega(cov, device=dev)
    finally:
        cbs_mega._mega_recurse = run
        for k in _LEVEL_WRAPPERS:
            setattr(cl, k, orig[k])
    return got


def on_level_lib(lib, fn):
    """fn() with the wrappers calling `lib`, a build of cbs_level.cu."""
    committed = cuda_lib.load("cbs_level", cl._SIGNATURES)
    cuda_lib._LIBS["cbs_level"] = lib
    try:
        return fn()
    finally:
        cuda_lib._LIBS["cbs_level"] = committed


def level_calls(kernel: str, inputs: dict, lib, old: bool,
                dev: torch.device):
    """(call, outputs, plain outputs) of K13 or K15 on a case's recorded
    inputs, into a copy of the level's tensors: through its wrapper on
    `lib`, a build of cbs_level.cu; K15 of an old build through its entry
    point, which takes no scratch."""
    if kernel == "K13":
        contigs, tab, pending0, lv, al0 = inputs["prologue"]
        W = lv["x"].shape[0]
        want = cl.prologue_plain(contigs, tab, pending0, W, al0)
        out = {k: v.clone() for k, v in lv.items()}
        return (lambda: on_level_lib(lib, lambda: cl.prologue(
            contigs, tab, pending0, out, al0)), out, want)
    tab, S, lv, walked, alpha, n_perm = inputs["edge_setup"]
    want = cl.edge_setup_plain(lv["x"], lv["n"], lv["ti"], lv["tj"],
                               lv["trivial"], walked, alpha, n_perm,
                               lv["x"].shape[1])
    out = {k: v.clone() for k, v in lv.items()}
    if old:
        def call():
            cuda_lib.check(cuda_lib.launch(
                dev, lib.cbs_edge_setup, tab[3 * S:].data_ptr(),
                *(out[k].data_ptr() for k in ("x", "n", "ti", "tj",
                                               "trivial")),
                walked.data_ptr(), alpha.data_ptr(),
                *(out[k].data_ptr() for k in cl._SETUP_OUT),
                lv["x"].shape[0], lv["x"].shape[1], n_perm),
                "cbs_edge_setup")
        return call, out, want
    return (lambda: on_level_lib(lib, lambda: cl.edge_setup(
        tab, S, out, walked, alpha, n_perm)), out, want)


def time_level(args, dev: torch.device) -> int:
    """--k13 / --k15: the committed K13 and K15 and, with --old, an
    earlier cbs_level.cu's, on each LEVEL_CASES case's first level,
    checked bit for bit against their plain versions, timed in turns
    (committed, old, old, committed)."""
    kernels = [k for k, on in (("K13", args.k13), ("K15", args.k15)) if on]
    builds = {"committed": cuda_lib.load("cbs_level", cl._SIGNATURES)}
    if args.old is not None:
        builds["old, as it is"] = variant_libs(
            args.old, {"as it is": None}, "cbs_level_old_",
            {"cbs_prologue": cl._SIGNATURES["cbs_prologue"],
             "cbs_edge_setup": OLD_EDGE_SETUP})["as it is"]
    inputs = {c: first_level_inputs(level_coverage(c, args.seed), dev)
              for c in LEVEL_CASES}
    calls = {}
    for label, lib in builds.items():
        for kernel in kernels:
            for case in LEVEL_CASES:
                call, out, want = level_calls(kernel, inputs[case], lib,
                                              label != "committed", dev)
                call()
                torch.cuda.synchronize()
                bad = [k for k, v in want.items() if not (
                    torch.equal(out[k].view(torch.int32),
                                v.view(torch.int32))
                    if v.dtype == torch.float32 else torch.equal(out[k], v))]
                if bad:
                    raise SystemExit(f"cbs_kernel_variants: {label} differs "
                                     f"from {kernel}'s plain version on "
                                     f"{case}: {bad}")
                calls[label, kernel, case] = call
    times: dict = {key: [] for key in calls}
    for label in list(builds) + list(reversed(builds)):
        for (lb, kernel, case), call in calls.items():
            if lb == label:
                times[lb, kernel, case].append(cuda_ms(call, args.reps))
    for label in builds:
        print(json.dumps({"build": label, "exact": True, **{
            f"{kernel}_ms": {case: times[label, kernel, case]
                             for case in LEVEL_CASES}
            for kernel in kernels}}), flush=True)
    shapes = {}
    for c in LEVEL_CASES:
        contigs, tab, pending0, lv, al0 = inputs[c]["prologue"]
        W, Tmax = lv["x"].shape
        S = pending0.shape[0]
        n = tab[2 * S:3 * S] - tab[S:2 * S]
        shapes[c] = {"rows": W, "Tmax": Tmax,
                     "gathered": int(torch.clamp(n[:W], min=0).sum()),
                     "K13_tiles": cl.prologue_layout(W, Tmax),
                     "K15_tiles": cl.edge_layout(W, Tmax)}
    print(json.dumps({"cases": shapes}), flush=True)
    print(gpu_line(), flush=True)
    return 0


# the entry points of the design before K14 rode in K11's launch and K15's
# keep flags in K16's: cbs_stats.cu's and cbs_level.cu's
OLD_STATS_SIGNATURES = {
    "cbs_tail_table": [_P, _P],
    "cbs_tail_grid": [_P],
    "cbs_tail_p": [_P, _P, _I] + [_P] * 6 + [_I] * 4 + [_P] * 2,
}
OLD_LEVEL_SIGNATURES = {
    "cbs_decide": [_P] * 14 + [ctypes.c_longlong] + [_I] * 3 + [_P],
    "cbs_edge_keep": [_P] * 13 + [_I] * 2 + [_P],
    "cbs_table": [_P] * 17 + [_I] * 3 + [_P],
}
_K14_OUT = ("b", "p1", "ostat", "hybrid", "needs", "trivial", "nrejc")


def fused_calls(inputs: dict, dev: torch.device, old_stats=None,
                old_level=None) -> dict:
    """On a case's first level (inputs: first_level_inputs), each call
    into copies of the level's tensors, table and pending flags, with
    (outputs, plain outputs) to check: "K14" K11 carrying K14 (or, given
    the old libraries, PR 18's three launches, K14's two around K11),
    "K11" K11 alone on the same rows (the committed tail_kernel, or the
    old one), "K16" K15's keep flags with K16 (or the old keep launch and
    K16's), "keep" the old keep launch alone, and "restore" the copies
    that put the table and pending flags back before every K16 call (a
    table update moves the table on), whose time the K16 calls include."""
    from canvas_tpu_torch.ops import cbs_stats_cuda as st

    tab14, S, lv14, alpha, kmax, n_grid, n_perm, n_min = \
        inputs["tail_decide"]
    args16 = inputs["keep_table"]
    tab0, pend0, lv16 = args16[:3]
    count, cnt, walked, wchunks, _a, _n, max_levels = args16[3:]
    W = lv14["t2"].shape[0]
    lv = {k: v.clone() for k, v in lv14.items()}
    want14 = cl.tail_decide_plain(lv14, alpha, kmax, n_grid, n_perm, n_min)
    out16 = {k: v.clone() for k, v in lv16.items()}
    tab, pend = tab0.clone(), pend0.clone()
    want16 = cl.keep_table_plain(tab0, pend0, lv16, count, cnt, walked,
                                 wchunks, alpha, n_perm, max_levels)
    live = tab14[3 * S + cl.LIVE]
    b = want14["b"]

    def restore():
        tab.copy_(tab0)
        pend.copy_(pend0)

    calls = {"restore": (restore, None)}
    if old_stats is None:
        calls["K14"] = (lambda: cl.tail_decide(
            tab14, S, lv, alpha, kmax, n_grid, n_perm, n_min),
            (lambda: {k: lv[k] for k in _K14_OUT}, want14))

        def k11():
            st.tail_p(b, lv["n_eff"], kmax, n_grid, live=live)

        def k16():
            restore()
            cl.keep_table(tab, pend, out16, count, cnt, walked, wchunks,
                          alpha, n_perm, max_levels)
    else:
        table = torch.empty(2 * st.NU_SERIES_TERMS, dtype=torch.float64,
                            device=dev)
        cuda_lib.check(cuda_lib.launch(dev, old_stats.cbs_tail_table,
                                       table.data_ptr()), "cbs_tail_table")
        grid = ctypes.c_int(0)
        cuda_lib.check(old_stats.cbs_tail_grid(ctypes.byref(grid)),
                       "cbs_tail_grid")
        nlive = torch.zeros(2, dtype=torch.int32, device=dev)
        xs = torch.empty(W * n_grid, dtype=torch.float64, device=dev)
        points = torch.empty(W * n_grid, dtype=torch.int32, device=dev)
        part = torch.empty(W * n_grid * st._NU_PARTS, dtype=torch.float64,
                           device=dev)
        ctl = tab14[3 * S:]

        def tail(b_in):
            cuda_lib.check(cuda_lib.launch(
                dev, old_stats.cbs_tail_p, b_in.data_ptr(),
                lv["n_eff"].data_ptr(), 1, table.data_ptr(), xs.data_ptr(),
                points.data_ptr(), part.data_ptr(), nlive.data_ptr(),
                lv["p1"].data_ptr(), W, kmax, n_grid, grid.value,
                live.data_ptr()), "cbs_tail_p")

        def decide(phase):
            cuda_lib.check(cuda_lib.launch(
                dev, old_level.cbs_decide, ctl.data_ptr(),
                *(lv[k].data_ptr() for k in ("t2", "ti", "tj", "n",
                                             "analyzable", "p1")),
                alpha.data_ptr(),
                *(lv[k].data_ptr() for k in ("b", "ostat", "hybrid",
                                             "needs", "trivial", "nrejc")),
                min(int(n_min), 1 << 62), W, n_perm, phase), "cbs_decide")

        def k14():
            decide(0)
            tail(lv["b"])
            decide(1)

        def k11():
            tail(b)

        def keep():
            cuda_lib.check(cuda_lib.launch(
                dev, old_level.cbs_edge_keep, tab0[3 * S:].data_ptr(),
                count.data_ptr(), cnt.data_ptr(),
                *(out16[k].data_ptr() for k in ("degen", "quick0",
                                                "test_both", "ti", "tj",
                                                "n")),
                alpha.data_ptr(),
                *(out16[k].data_ptr() for k in ("keep1", "keep2",
                                                "echunks")), W, n_perm),
                "cbs_edge_keep")

        def k16():
            restore()
            keep()
            cuda_lib.check(cuda_lib.launch(
                dev, old_level.cbs_table, tab.data_ptr(), pend.data_ptr(),
                *(out16[k].data_ptr() for k in (
                    "fsel", "contig", "seg_lo", "n", "pending", "analyzable",
                    "accepted", "keep1", "keep2", "ti", "tj", "needs")),
                walked.data_ptr(), wchunks.data_ptr(),
                out16["echunks"].data_ptr(), S, W, max_levels), "cbs_table")

        calls["K14"] = (k14, (lambda: {k: lv[k] for k in _K14_OUT}, want14))
        calls["keep"] = (keep, None)
    calls["K11"] = (k11, None)
    keep_names = ("keep1", "keep2", "echunks")
    calls["K16"] = (k16, (lambda: ({k: out16[k] for k in keep_names}, tab,
                                   pend),
                          ({k: want16[0][k] for k in keep_names},
                           want16[1], want16[2])))
    return calls


def _bits(a, b) -> bool:
    if isinstance(a, dict):
        return all(_bits(a[k], b[k]) for k in b)
    if isinstance(a, tuple):
        return all(_bits(x, y) for x, y in zip(a, b))
    if a.dtype in (torch.float32, torch.float64):
        w = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(w), b.view(w))
    return torch.equal(a, b)


def graph_of(fns) -> "torch.cuda.CUDAGraph":
    """The calls fns (run once eagerly first) captured in one CUDA graph."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    return g


def time_k14_k16(args, dev: torch.device) -> int:
    """--k14 --k16: K11 carrying K14 and keep_table (K15's keep flags with
    K16), and with --old DIR PR 18's launches built from DIR's
    cbs_stats.cu and cbs_level.cu (K14's two around K11; K15's keep and
    K16), on each LEVEL_CASES case's first level: each checked bit for
    bit against the chained plain versions, then timed in turns
    (committed, old, old, committed), eagerly and as CUDA graphs replayed
    (each group alone, and both groups in one graph: the level's part that
    changed)."""
    builds = {"committed": (None, None)}
    if args.old is not None:
        stats = variant_libs(args.old / "cbs_stats.cu", {"as it is": None},
                             "cbs_stats_old_", OLD_STATS_SIGNATURES)
        level = variant_libs(args.old / "cbs_level.cu", {"as it is": None},
                             "cbs_level_old_", OLD_LEVEL_SIGNATURES)
        builds["old"] = (stats["as it is"], level["as it is"])
    inputs = {c: first_level_inputs(level_coverage(c, args.seed), dev)
              for c in LEVEL_CASES}
    timed: dict = {}
    for label, (old_stats, old_level) in builds.items():
        for case in LEVEL_CASES:
            calls = fused_calls(inputs[case], dev, old_stats, old_level)
            for name, (fn, check) in calls.items():
                fn()
                torch.cuda.synchronize()
                if check is not None and not _bits(check[0](), check[1]):
                    raise SystemExit(f"cbs_kernel_variants: {label} {name} "
                                     f"differs from its plain versions on "
                                     f"{case}")
            fns = {name: fn for name, (fn, _c) in calls.items()}
            for name, fn in fns.items():
                timed[label, case, name, "eager"] = fn
                timed[label, case, name, "graph"] = graph_of([fn]).replay
            timed[label, case, "K14 and K16", "graph"] = graph_of(
                [fns["K14"], fns["K16"]]).replay
    times: dict = {key: [] for key in timed}
    for label in list(builds) + list(reversed(builds)):
        for key, fn in timed.items():
            if key[0] == label:
                times[key].append(cuda_ms(fn, args.reps))
    for label in builds:
        for case in LEVEL_CASES:
            row = {f"{name}_{mode}_ms": t
                   for (lb, c, name, mode), t in times.items()
                   if lb == label and c == case}
            print(json.dumps({"build": label, "case": case, "exact": True,
                              **row}), flush=True)
    shapes = {c: {"rows": inputs[c]["tail_decide"][2]["t2"].shape[0],
                  "slots": inputs[c]["keep_table"][1].shape[0]}
              for c in LEVEL_CASES}
    print(json.dumps({"cases": shapes}), flush=True)
    print(gpu_line(), flush=True)
    return 0


def old_calls(lib, walk: dict, edge: dict, dev: torch.device):
    """(K7 call, K8 call, results) of a one-key-a-row library, handed the
    keys the committed kernels derive; results() returns (accepted,
    chunks, chunk-0 statistics, count, cnt, chunk-0 subset sums)."""
    W, Tmax = walk["x"].shape
    L = edge["xw"].shape[0]
    keys = mc.seg_keys(walk["key0"], walk["seg_c"], walk["seg_lo"],
                       walk["n"])
    ekeys = mc.edge_keys(edge["key0"], edge["seg_c"], edge["seg_lo"],
                         edge["seg_n"], L)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    sort = torch.empty(grid * Tmax if Tmax > 32768 else 1, dtype=torch.int32,
                       device=dev)
    w_state = torch.empty((4, W), dtype=torch.int64, device=dev)
    w_ps = torch.empty((W, mc.P_CHUNK), dtype=torch.float32, device=dev)
    acc = torch.empty(W, dtype=torch.bool, device=dev)
    chunks = torch.empty(W, dtype=torch.int64, device=dev)
    stats = torch.full((W, mc.P_CHUNK), -1.0, device=dev)
    e_state = torch.empty((2, L), dtype=torch.int64, device=dev)
    e_ps = torch.empty((L, mc.P_CHUNK), dtype=torch.float32, device=dev)
    count = torch.empty(L, dtype=torch.int64, device=dev)
    cnt = torch.empty(L, dtype=torch.int64, device=dev)
    sums = torch.full((L, mc.P_CHUNK), -1.0, device=dev)
    a, e = walk, edge

    def k7():
        cuda_lib.check(cuda_lib.launch(
            dev, lib.cbs_walk, a["x"].data_ptr(), a["n"].data_ptr(),
            a["tss"].data_ptr(), keys.data_ptr(), a["walking"].data_ptr(),
            a["hybrid"].data_ptr(), a["ostat"].data_ptr(),
            a["nrejc"].data_ptr(), a["sbdry"].data_ptr(), w_state.data_ptr(),
            w_ps.data_ptr(), sort.data_ptr(), acc.data_ptr(),
            chunks.data_ptr(), stats.data_ptr(), W, Tmax,
            a["sbdry"].shape[0], a["n_perm"], a["al0"], a["kmax"],
            a["n_min"], grid), "cbs_walk")

    def k8():
        cuda_lib.check(cuda_lib.launch(
            dev, lib.cbs_edge, e["xw"].data_ptr(), e["wn"].data_ptr(),
            e["m1"].data_ptr(), e["xbar"].data_ptr(), e["ostat"].data_ptr(),
            e["active"].data_ptr(), ekeys.data_ptr(), e["limit"].data_ptr(),
            e_state.data_ptr(), e_ps.data_ptr(), sort.data_ptr(),
            count.data_ptr(), cnt.data_ptr(), sums.data_ptr(), L, Tmax,
            e["n_perm"], grid), "cbs_edge")

    return k7, k8, lambda: (acc, chunks, stats, count, cnt, sums)


def committed_calls(walk: dict, edge: dict, dev: torch.device, lib=None):
    """(K7 call, K8 call, results) through the wrappers, on the committed
    library or, given `lib`, on that build of the committed source."""
    W = walk["x"].shape[0]
    L = edge["xw"].shape[0]
    stats = torch.full((W, mc.P_CHUNK), -1.0, device=dev)
    sums = torch.full((L, mc.P_CHUNK), -1.0, device=dev)
    out: dict = {}
    committed = cuda_lib.load("cbs_mega", mc._SIGNATURES)

    def on_lib(fn):
        cuda_lib._LIBS["cbs_mega"] = lib or committed
        try:
            return fn()
        finally:
            cuda_lib._LIBS["cbs_mega"] = committed

    def k7():
        out["walk"] = on_lib(lambda: mc.walk(**walk, stats=stats))

    def k8():
        out["edge"] = on_lib(lambda: mc.edge_counts(**edge, sums=sums))

    return k7, k8, lambda: (*out["walk"], stats, *out["edge"], sums)


def same(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="a cbs_mega.cu that takes one key a row (with "
                         "--k13 or --k15, an earlier cbs_level.cu)")
    ap.add_argument("--old-parts", action="store_true",
                    help="also time --old with each part taken out")
    ap.add_argument("--parts", action="store_true",
                    help="also time the committed source with each part "
                         "taken out (PARTS)")
    ap.add_argument("--no-committed", action="store_true",
                    help="time only --old and its edits")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--k12", action="store_true",
                    help="time K12 (with --parts, K12_PARTS too) instead")
    ap.add_argument("--k13", action="store_true",
                    help="time K13 instead")
    ap.add_argument("--k15", action="store_true",
                    help="time K15 instead")
    ap.add_argument("--k14", action="store_true",
                    help="with --k16, time K11 carrying K14 and K15's "
                         "keep flags with K16 instead (--old: a directory "
                         "holding an earlier cbs_stats.cu and "
                         "cbs_level.cu)")
    ap.add_argument("--k16", action="store_true",
                    help="see --k14")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cbs_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.k12:
        return time_k12(args, dev)
    if args.k14 or args.k16:
        return time_k14_k16(args, dev)
    if args.k13 or args.k15:
        return time_level(args, dev)
    walk, edge, many = panel_like(dev, args.seed)

    def both(make, exact):
        """(K7, K8, K7 with every row walking, results of all, exact)."""
        k7, k8, res = make(walk)
        k7m, k8m, resm = make(many)
        k8m()         # resm() reads the edge results of its own calls too
        return k7, k8, k7m, lambda: (*res(), *resm()), exact

    builds: dict = {}
    if not args.no_committed:
        builds["committed"] = both(
            lambda w: committed_calls(w, edge, dev), True)
    if args.parts:
        libs = variant_libs(cuda_lib.CSRC_DIR / "cbs_mega.cu",
                            {k: e for k, (e, _x) in PARTS.items()},
                            "cbs_mega_part_", mc._SIGNATURES)
        for label, (_edit, exact) in PARTS.items():
            builds[label] = both(
                lambda w, lib=libs[label]: committed_calls(w, edge, dev, lib),
                exact)
    if args.old is not None:
        olds = {k: v for k, v in OLD_VARIANTS.items()
                if v[0] is None or args.old_parts}
        libs = variant_libs(args.old, {k: e for k, (e, _x) in olds.items()},
                            "cbs_mega_old_", OLD_SIGNATURES)
        for label, (_edit, exact) in olds.items():
            builds[f"old, {label}"] = both(
                lambda w, lib=libs[label]: old_calls(lib, w, edge, dev),
                exact)
    ref = None
    work: dict = {}
    for label, (k7, k8, k7m, results, exact) in builds.items():
        k7()
        k8()
        k7m()
        torch.cuda.synchronize()
        got = [t.clone() for t in results()]
        # the chunks each walking row and active lane took: a build that
        # drops work must still take as many as the others
        work[label] = (got[1][:2].tolist(), got[4][[0, 32]].tolist())
        if exact:
            if ref is None:
                ref = got
            elif not same(got, ref):
                raise SystemExit(f"cbs_kernel_variants: {label} differs from "
                                 f"the first exact build")
    order = list(builds) + list(reversed(builds))
    times: dict = {k: {"K7": [], "K8": [], "K7m": []} for k in builds}
    for label in order:
        k7, k8, k7m = builds[label][:3]
        times[label]["K7"].append(cuda_ms(k7, args.reps))
        times[label]["K8"].append(cuda_ms(k8, args.reps))
        times[label]["K7m"].append(cuda_ms(k7m, args.reps))
    for label, (*_calls, exact) in builds.items():
        print(json.dumps({"build": label, "exact": exact,
                          "K7_ms": times[label]["K7"],
                          "K8_ms": times[label]["K8"],
                          "K7_32_walking_ms": times[label]["K7m"],
                          "K7_chunks": work[label][0],
                          "K8_chunks": work[label][1]}), flush=True)
    print(gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
