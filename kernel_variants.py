#!/usr/bin/env python3
"""Time design variants of kernels B2 and B4 on one CUDA card.

    python3 kernel_variants.py [--b4] [--old OLD.cu ...] [--seed N]

Each variant is the committed source (canvas_tpu_torch/csrc/viterbi.cu or
arc_scan.cu) with one edit: a constant changed, or a part of the kernel
taken out to see what the rest costs.  It is built under its own name in
canvas_tpu_torch/_build/variants/ and timed with chip_smoke.py's inputs
and timer, in turns with the committed kernel.  B2 runs at chip_smoke.py's
shape; B2's "no chain" and "no loads" are not meant to equal the plain
version (they drop work), the others must.

B4 runs as the frontier engine launches it, at chip_smoke.py's three
shapes and two of many rows of one width, and as the whole-recursion
engine launches it, at every tier width 1,024 to 65,536 under a row mask
of 3 rows of 32 (chip_smoke.py's tier cases) and of 6 rows of 64 (the
lowpass benchmark's first level), live and with live 0 (a level after the
run's end).  Each --old (an earlier commit's arc_scan.cu, written by `git
show` under the ignored scratch/) is timed beside, in the same turns.
Each line says whether the build equals the plain version (B4's "list
alone" is not meant to) and, for builds with a tally word, the pair terms
its first phase computed, beside the plain walk's and the seed's.  The
register count of each B4 build's arc_scan_blocks is printed first.
--b4 times B4 alone.  Prints one JSON line a variant and shape and, last,
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
from canvas_tpu_torch.ops import arc_scan_cuda as ac  # noqa: E402
from canvas_tpu_torch.ops import cbs_stats_cuda as st  # noqa: E402
from canvas_tpu_torch.ops import cuda_lib  # noqa: E402
from canvas_tpu_torch.ops import viterbi_cuda as vc  # noqa: E402

VARIANT_DIR = cuda_lib.BUILD_DIR / "variants"


def constant(name: str, value: int):
    return lambda src: re.sub(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", src)


def replace(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise ValueError(f"variant edit not found: {old!r}")
        return src.replace(old, new)
    return edit


B2_VARIANTS = {
    "committed": None,
    "no chain (each step adds e only)": replace(
        "} else if (kUniform) {",
        "} else if (kUniform) {\n#pragma unroll\n"
        "        for (int j = 0; j < S; ++j) M[j] += e[j];\n"
        "      } else if (false) {"),
    "no loads (the chain on the ring as it is)": replace(
        "copy_async4(&ring[g % kCmRing][s][row][ln], src + k * step);",
        "(void)src;"),
    "64 lanes a block, ring of 4": lambda s: constant("kCmRing", 4)(
        constant("kCmLanes", 64)(s)),
    "128 lanes a block, 4 steps a group, ring of 4": lambda s: constant(
        "kCmRing", 4)(constant("kCmGroup", 4)(constant("kCmLanes", 128)(s))),
}

B4_VARIANTS = {
    "committed": None,
    "no floors (every block the seed admits)": replace(
        "fmaxf(seed, decode(__ldcg(seg_floors + k)));", "seed;"),
    "8-lag register window": constant("kRun", 8),
    "the list alone (no item computed)": replace(
        "    if (!scan_item(",
        "    if (tid == 0) s_item = fetched;\n    if (true || !scan_item("),
}


def variant_lib(base: str, label: str, edit, signatures):
    if edit is None:
        return cuda_lib.load(base, signatures)
    name = base + "_" + re.sub(r"\W+", "_", label).strip("_")
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = VARIANT_DIR / f"{name}.cu"
    src.write_text(edit((cuda_lib.CSRC_DIR / f"{base}.cu").read_text()))
    return cuda_lib.load(name, signatures, src)


def b2(seed: int, dev: torch.device) -> None:
    log_em, mask, lt, li = smoke.decode_inputs(seed, dev)
    B, T, S = log_em.shape
    nC = T // smoke.CHUNK
    L = B * nC
    em = log_em.reshape(B, nC, smoke.CHUNK, S).permute(2, 3, 0, 1) \
        .reshape(smoke.CHUNK, S, L).contiguous()
    base = (torch.arange(nC, device=dev, dtype=torch.int32)
            * smoke.CHUNK).repeat(B)
    lane_len = mask.sum(dim=1).to(torch.int32).repeat_interleave(nC)
    want = vc.chunk_matrices_plain(em, base, lane_len, lt, li)
    lt_c, li_c = vc._model_args(lt, li)
    uniform = int(vc.uniform_transitions(lt) is not None)
    out = torch.empty_like(want)
    runs = {}
    for label, edit in B2_VARIANTS.items():
        lib = variant_lib("viterbi", label, edit, vc._SIGNATURES)

        def run(lib=lib):
            cuda_lib.check(lib.viterbi_chunk_matrices(
                em.data_ptr(), base.data_ptr(), lane_len.data_ptr(),
                out.data_ptr(), smoke.CHUNK, L, lt_c, li_c, uniform,
                cuda_lib.current_stream(dev)), label)
        run()
        torch.cuda.synchronize()
        runs[label] = (run, torch.equal(out, want))
    report("B2", runs, [B, T, S])


# B4 as the frontier engine launches it, no mask: chip_smoke.py's shapes
# and two of many rows of one width (segments, padded length, length of
# every segment or None for lengths drawn in (0.6 npad, npad])
B4_FRONTIER = smoke.B4_SHAPES + ((64, 8_192, None), (256, 1_024, None))
# B4 as the whole-recursion engine launches it, once a tier 1,024-65,536:
# (W, the rows of the tier under the mask); 3 rows of 32 as chip_smoke.py's
# tier cases, 6 of 64 as the lowpass benchmark's first level
B4_ENGINE = ((32, (0, 7, 31)), (64, (0, 5, 11, 23, 40, 63)))
# the arc_scan entry point of a source without the persistent grid: no
# grid and no tally word
_DENSE_ARC_SCAN = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 3


def b4_builds(olds: list[Path]) -> dict:
    """label -> (library, whether it takes the grid and tally word): the
    committed source, each edit of B4_VARIANTS and each earlier source."""
    builds = {label: (variant_lib("arc_scan", label, edit, ac._SIGNATURES),
                      True) for label, edit in B4_VARIANTS.items()}
    for i, old in enumerate(olds):
        text = old.read_text()
        persistent = "arc_scan_occupancy" in text
        VARIANT_DIR.mkdir(parents=True, exist_ok=True)
        src = VARIANT_DIR / f"arc_scan_old{i}.cu"
        src.write_text(text)
        builds[f"old: {old.name}"] = (cuda_lib.load(
            f"arc_scan_old{i}", ac._SIGNATURES if persistent
            else {"arc_scan": _DENSE_ARC_SCAN}, src), persistent)
    for name, log in cuda_lib.PTXAS_LOG.items():
        if name.startswith("arc_scan"):
            used = re.findall(r"Compiling entry function '\w*arc_scan_blocks"
                              r"\w*'.*?(\d+) bytes spill stores.*?Used "
                              r"(\d+) registers", log, re.S)
            smoke.emit({"kernel": "B4", "build": name,
                        "arc_scan_blocks_spill_stores_registers": used})
    return builds


def b4_cases(seed: int, dev: torch.device):
    """(shape, cs, n, mask or None) for every frontier shape and engine
    tier launch, with chip_smoke.py's inputs."""
    import numpy as np

    for B, npad, length in B4_FRONTIER:
        cs, n, _tss = smoke.b4_inputs(seed + npad, B, npad, length, dev)
        yield [B, npad, length], cs, n, None
    rng = np.random.default_rng(seed + 7)
    for W, rows in B4_ENGINE:
        for k in range(10, 17):
            cs, n, mask = smoke.b4_tier_rows(rng, 1 << k, dev, W, rows)
            yield [W, 1 << k, f"{len(rows)} masked"], cs, n, mask


def b4(seed: int, dev: torch.device, olds: list[Path]) -> None:
    """B4 at the frontier shapes and the engine's tier launches (live and,
    under the mask, dead), every build in turns; each line says whether
    the build equals the plain version (live launches) and its tally of
    pair terms beside the plain walk's bounds on it."""
    builds = b4_builds(olds)
    sms, per_sm = ac.occupancy(dev)
    for shape, cs, n, mask in b4_cases(seed, dev):
        B, npad = cs.shape
        seed_v, lag_hi, psd2, _ti, _tj, n32 = st.arc_inputs(
            cs, n, npad, 2, mask=mask)
        sel = slice(None) if mask is None else torch.nonzero(mask)[:, 0]
        walk: dict = {}
        want = ac.arc_scan_plain(cs[sel], n32[sel], lag_hi[sel], seed_v[sel],
                                 psd2[sel], 2, count=walk)
        scratch = torch.empty(ac.scratch_words(B, psd2.shape[1]),
                              dtype=torch.int32, device=dev)
        best = torch.empty(B, dtype=torch.float32, device=dev)
        bl0 = torch.empty(B, dtype=torch.int32, device=dev)
        terms = torch.zeros((), dtype=torch.int64, device=dev)
        for states in ((1, 0) if mask is not None else (1,)):
            live = torch.full((), states, dtype=torch.int64, device=dev)
            runs, extra = {}, {}
            for label, (lib, persistent) in builds.items():
                def run(lib=lib, persistent=persistent):
                    head = (cs.data_ptr(), n32.data_ptr(), lag_hi.data_ptr(),
                            seed_v.data_ptr(), psd2.data_ptr(),
                            scratch.data_ptr(), best.data_ptr(),
                            bl0.data_ptr(), B, npad, 2, npad)
                    tail = (cuda_lib.ptr(mask), live.data_ptr())
                    args = (*head, sms * per_sm, *tail, terms.data_ptr()) \
                        if persistent else (*head, *tail)
                    cuda_lib.check(lib.arc_scan(
                        *args, cuda_lib.current_stream(dev)), label)
                terms.zero_()
                run()
                torch.cuda.synchronize()
                runs[label] = (run, not states or (
                    torch.equal(best[sel].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(bl0[sel], want[1])))
                extra[label] = {
                    "live": states, "grid": sms * per_sm,
                    "terms": int(terms) if persistent else None,
                    "walk_terms": walk["terms"],
                    "seed_terms": walk["seed_terms"]}
            report("B4", runs, shape, extra)


def report(kernel: str, runs: dict, shape: list,
           extra: dict | None = None) -> None:
    """Times each variant twice, in the order committed, variants,
    variants reversed, committed; prints both times of each, with the
    variant's entries of `extra`."""
    order = list(runs) + list(reversed(runs))
    times: dict[str, list[float]] = {k: [] for k in runs}
    for label in order:
        times[label].append(smoke.cuda_ms(runs[label][0], 20, queued=True))
    for label, (_run, equal) in runs.items():
        smoke.emit({"kernel": kernel, "shape": shape, "variant": label,
                    "equal": equal, "ms": times[label],
                    **(extra or {}).get(label, {})})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--b4", action="store_true", help="time B4 only")
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="an earlier arc_scan.cu to time beside B4 "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if not args.b4:
        b2(args.seed, dev)
    b4(args.seed, dev, args.old)
    print(smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
