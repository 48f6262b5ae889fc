"""The check's two readings for a cell, at the cell's own size, over
several seeds in one process: the control (the plain reference with its
values and cumulative sums held in bfloat16, put in the program's place)
and, with --program, the program itself, each against the reference, on
the samples a run of that seed would check.  With --f32-sums, also the
reference with its sums accumulated in float32, against the reference.

    python3 -m cnvbench.control --workload <name> --seeds 1 2 3 [--program]
        [--f32-sums] [--check N]

Prints a JSON line a seed: the checked samples, contigs_off of the control
and of the program, and the seconds each side took; the benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cnvbench import check, generator, spec
from cnvbench.reference import cbs as reference


def readings(cell, seed: int, device: torch.device, program: bool,
             count: int | None = None, f32_sums: bool = False) -> dict:
    """One seed's readings: the pool's checked samples (drawn as a run
    draws them, from the whole pool, which a window cycles through; with
    `count`, that many instead of the mix's)."""
    pool = generator.make_pool(cell.config, cell.mix, seed, device)
    picked = check.draw(range(len(pool)), count or cell.mix["check"], seed)
    out = {"seed": seed, "samples": picked}
    if program:
        from cnvbench.harness import System

        system = System(device, cell.config["alpha"])
        system(pool[0])                         # the shape's capture
        got = {k: system(pool[k])[0] for k in picked}
        system.release()
    t = time.perf_counter()
    want = {k: reference.segment(pool[k], device) for k in picked}
    out["reference_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ctl = {k: reference.segment(pool[k], device, reference.CONTROL)
           for k in picked}
    out["control_s"] = time.perf_counter() - t
    # each checked sample's design index (the pool's order is the seed's)
    design = generator.rng_of(seed).permutation(len(pool))
    rows = {k: {"design": int(design[k]),
                "control_off": check.contigs_off(ctl[k], want[k])}
            for k in picked}
    for k in picked:
        if f32_sums:
            rows[k]["f32_sums_off"] = check.contigs_off(reference.segment(
                pool[k], device, reference.F32_SUMS), want[k])
        if program:
            rows[k]["program_off"] = check.contigs_off(got[k], want[k])
    for name in ("control_off", "f32_sums_off", "program_off"):
        if name in rows[picked[0]]:
            out[name] = sum(r[name] for r in rows.values())
    out["by_sample"] = list(rows.values())
    out["contigs"] = sum(len(pool[k]) for k in picked)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--f32-sums", action="store_true")
    ap.add_argument("--check", type=int, default=None,
                    help="samples a seed (default: the mix's)")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("cnvbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in args.seeds:
        print(json.dumps({"workload": cell.name,
                          **readings(cell, s, dev, args.program,
                                     args.check, args.f32_sums)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
