"""Run one cell of the benchmark of canvas_tpu_torch.

    python3 -m cnvbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device (and with --trace 1 busy_s, window_s and a breakdown), and last the
checks that decided `correct`, each number beside its limit; the checks
are also the last lines of standard error.  Exits 2, printing no result,
without enough CUDA devices, without the program beside it, or where a
JAX module was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "canvas_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (canvas_tpu_torch is not canvas_tpu)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cnvbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"cnvbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"{found} found", file=sys.stderr)
        return 2
    try:
        import canvas_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"cnvbench: the program canvas_tpu_torch is not beside the "
              f"benchmark: {e}", file=sys.stderr)
        return 2
    from cnvbench import harness

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"cnvbench: modules loaded that the benchmark must not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
