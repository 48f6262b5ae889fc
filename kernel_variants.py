#!/usr/bin/env python3
"""Time design variants of kernels B2 and B4 on one CUDA card.

    python3 kernel_variants.py [--seed N]

Each variant is the committed source (canvas_tpu_torch/csrc/viterbi.cu or
arc_scan.cu) with one edit: a constant changed, or a part of the kernel
taken out to see what the rest costs.  It is built under its own name in
canvas_tpu_torch/_build/variants/ and timed at chip_smoke.py's shapes with
chip_smoke.py's inputs and timer, in turns with the committed kernel.  B4
variants must equal the plain version; B2's "no chain" and "no loads" are
not meant to (they drop work), the others must.  Prints one JSON line a
variant and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
from canvas_tpu_torch.ops import arc_scan_cuda as ac  # noqa: E402
from canvas_tpu_torch.ops import cbs_device as cd  # noqa: E402
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
        "const float floor_k = fmaxf(seed[b], decode(seg_floors[k]));",
        "const float floor_k = seed[b];"),
    "8-lag register window": constant("kRun", 8),
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


def b4(seed: int, dev: torch.device) -> None:
    for B, npad, length in smoke.B4_SHAPES:
        cs, n, _tss = smoke.b4_inputs(seed + npad, B, npad, length, dev)
        seed_v, lag_hi, psd2, _ti, _tj = cd.arc_scan_inputs(cs, n, npad, 2)
        want = ac.arc_scan_plain(cs, n, lag_hi, seed_v, psd2, 2)
        nblk = psd2.shape[1]
        scratch = torch.empty(B * nblk * (ac.MAX_SUB + 1), dtype=torch.int32,
                              device=dev)
        best = torch.empty(B, dtype=torch.float32, device=dev)
        bl0 = torch.empty(B, dtype=torch.int32, device=dev)
        runs = {}
        for label, edit in B4_VARIANTS.items():
            lib = variant_lib("arc_scan", label, edit, ac._SIGNATURES)

            def run(lib=lib):
                cuda_lib.check(lib.arc_scan(
                    cs.data_ptr(), n.data_ptr(), lag_hi.data_ptr(),
                    seed_v.data_ptr(), psd2.data_ptr(), scratch.data_ptr(),
                    best.data_ptr(), bl0.data_ptr(), B, npad, 2, npad,
                    None, None, cuda_lib.current_stream(dev)), label)
            run()
            torch.cuda.synchronize()
            runs[label] = (run, torch.equal(best.view(torch.int32),
                                            want[0].view(torch.int32))
                           and torch.equal(bl0, want[1]))
        report("B4", runs, [B, npad, length])


def report(kernel: str, runs: dict, shape: list) -> None:
    """Times each variant twice, in the order committed, variants,
    variants reversed, committed; prints both times of each."""
    order = list(runs) + list(reversed(runs))
    times: dict[str, list[float]] = {k: [] for k in runs}
    for label in order:
        times[label].append(smoke.cuda_ms(runs[label][0], 20, queued=True))
    for label, (_run, equal) in runs.items():
        smoke.emit({"kernel": kernel, "shape": shape, "variant": label,
                    "equal": equal, "ms": times[label]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    b2(args.seed, dev)
    b4(args.seed, dev)
    print(smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
