"""Time kernels K7 (walks) and K8 (edge tests) of csrc/cbs_mega.cu on one
CUDA card, beside another build of the source: an earlier design, or the
same source with a part taken out to see what the rest costs.

    python3 -m canvas_tpu_torch.tools.cbs_kernel_variants \\
        [--old PATH [--old-parts]] [--no-committed] [--reps N]

The inputs are made from a seed, shaped like the first walking and
edge-testing levels of chip_smoke.py's panel (Tumor-normal-enrichment,
three contigs of about 19,930 bins): K7 on 32 rows at Tmax 32,768, two of
them walking (hybrid, n 2,476 and 4,810); K8 on 64 lanes (32 rows, two
edges each), two of them active (wn 2,474, m1 2).  Each row and lane runs
a fixed number of chunks whatever its statistics (K7: ostat +inf and a
boundary no count reaches, so a walk ends at n_perm = 1,024, two chunks;
K8: ostat +inf, so a lane runs all 20 chunks of n_perm = 10,000), so a
variant that changes the statistics does the same amount of work.

--parts builds the committed source with each edit of PARTS, a part taken
out (or, where marked exact, written another way), and times it too.

--old PATH takes a cbs_mega.cu whose entry points take one threefry key a
row (the design that gives a whole block to each permutation and draws K7's
keys twice), for example one written by `git show
<commit>:canvas_tpu_torch/csrc/cbs_mega.cu`.  It is built as it is and,
with --old-parts, with each edit of OLD_VARIANTS, under its own name in
canvas_tpu_torch/_build/variants/, and handed the keys that the committed
kernels derive on the card (ops/cbs_mega_cuda.seg_keys and edge_keys), so
every exact build must give the committed kernels' flags, counts and
statistics.  Every build is timed twice, in the order committed, builds,
builds reversed, committed, with CUDA events (a sleep kernel holds the
stream while the calls are queued).  Prints one JSON line a build and
kernel, and last the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
    "K7 without the buckets' insertion sort": (replace(
        "for (int i = lo + 1; i < hi; ++i) {",
        "for (int i = hi; i < hi; ++i) {"), False),
    "K7 without the gather of x (a hash of the word instead)": (replace(
        "if (kb + q < k1) v[q] = __ldg(xrow + (buf[kb + q] & 0xFFFFu));",
        "if (kb + q < k1) v[q] = __uint_as_float(0x3F800000u | ((buf[kb + q]"
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


def variant_lib(src_path: Path, label: str, edit, prefix: str,
                signatures: dict):
    name = prefix + re.sub(r"\W+", "_", label).strip("_").lower()
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = VARIANT_DIR / f"{name}.cu"
    text = src_path.read_text()
    src.write_text(edit(text) if edit else text)
    return cuda_lib.load(name, signatures, src)


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


def panel_like(dev: torch.device, seed: int) -> tuple[dict, dict]:
    """(K7's arguments, K8's arguments) as the module docstring says."""
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
    return walk, edge


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
                    help="a cbs_mega.cu that takes one key a row")
    ap.add_argument("--old-parts", action="store_true",
                    help="also time --old with each part taken out")
    ap.add_argument("--parts", action="store_true",
                    help="also time the committed source with each part "
                         "taken out (PARTS)")
    ap.add_argument("--no-committed", action="store_true",
                    help="time only --old and its edits")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cbs_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    walk, edge = panel_like(dev, args.seed)
    builds: dict = {}
    if not args.no_committed:
        builds["committed"] = (*committed_calls(walk, edge, dev), True)
    if args.parts:
        for label, (edit, exact) in PARTS.items():
            lib = variant_lib(cuda_lib.CSRC_DIR / "cbs_mega.cu", label, edit,
                              "cbs_mega_part_", mc._SIGNATURES)
            builds[label] = (*committed_calls(walk, edge, dev, lib), exact)
    if args.old is not None:
        for label, (edit, exact) in OLD_VARIANTS.items():
            if edit is not None and not args.old_parts:
                continue
            lib = variant_lib(args.old, label, edit, "cbs_mega_old_",
                              OLD_SIGNATURES)
            builds[f"old, {label}"] = (*old_calls(lib, walk, edge, dev),
                                       exact)
    ref = None
    work: dict = {}
    for label, (k7, k8, results, exact) in builds.items():
        k7()
        k8()
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
    times: dict = {k: {"K7": [], "K8": []} for k in builds}
    for label in order:
        k7, k8 = builds[label][:2]
        times[label]["K7"].append(cuda_ms(k7, args.reps))
        times[label]["K8"].append(cuda_ms(k8, args.reps))
    for label, (_k7, _k8, _res, exact) in builds.items():
        print(json.dumps({"build": label, "exact": exact,
                          "K7_ms": times[label]["K7"],
                          "K8_ms": times[label]["K8"],
                          "K7_chunks": work[label][0],
                          "K8_chunks": work[label][1]}), flush=True)
    print(gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
