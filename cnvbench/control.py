"""The check's two readings for a cell, at the cell's own size, over
several seeds in one process: the control (the cell's partition's
`control`, the plain reference in the precision below the one the
configuration states, put in the program's place) and, with --program,
the program itself, each against the reference, on the samples a run of
that seed would check.  With --variant NAME (the partition's
`VARIANTS`, such as CBS's f32_sums), also that variant of the reference
against the reference.

    python3 -m cnvbench.control --workload <name> --seeds 1 2 3 [--program]
        [--variant NAME ...] [--check N]

Prints a JSON line a seed: the checked samples, the compared number of
the control, of each variant and of the program, and the seconds each
side took; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cnvbench import check, spec


def readings(cell, seed: int, device: torch.device, program: bool,
             count: int | None = None, variants: tuple = ()) -> dict:
    """One seed's readings: the pool's checked samples (drawn as a run
    draws them, from the whole pool, which a window cycles through; with
    `count`, that many instead of the mix's)."""
    part = cell.partition
    pool = part.make_pool(cell.config, cell.mix, seed, device)
    picked = check.draw(range(len(pool)), count or cell.mix["check"], seed)
    out = {"seed": seed, "samples": picked}
    if program:
        system = part.System(device, cell.config)
        system(pool[0])                         # the shape's capture
        got = {k: system(pool[k])[0] for k in picked}
        system.release()
    t = time.perf_counter()
    want = {k: part.reference(pool[k], device) for k in picked}
    out["reference_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ctl = {k: part.control(pool[k], device) for k in picked}
    out["control_s"] = time.perf_counter() - t
    # each checked sample's design index (the pool's order is the seed's)
    design = part.design(seed, len(pool))
    rows = {k: {"design": int(design[k]),
                "control_off": part.off(ctl[k], want[k])}
            for k in picked}
    for k in picked:
        for name in variants:
            rows[k][f"{name}_off"] = part.off(
                part.VARIANTS[name](pool[k], device), want[k])
        if program:
            rows[k]["program_off"] = part.off(got[k], want[k])
    for name in ("control_off", *(f"{v}_off" for v in variants),
                 "program_off"):
        if name in rows[picked[0]]:
            out[name] = sum(r[name] for r in rows.values())
    out["by_sample"] = list(rows.values())
    out["parts"] = sum(part.parts(pool[k]) for k in picked)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="a variant of the reference to read (repeatable)")
    ap.add_argument("--check", type=int, default=None,
                    help="samples a seed (default: the mix's)")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    unknown = sorted(set(args.variant) - set(cell.partition.VARIANTS))
    if unknown:
        ap.error(f"no variant {', '.join(unknown)} of {cell.name}'s reference")
    if not torch.cuda.is_available():
        print("cnvbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in args.seeds:
        print(json.dumps({"workload": cell.name,
                          **readings(cell, s, dev, args.program,
                                     args.check, tuple(args.variant))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
