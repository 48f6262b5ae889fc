"""How `correct` is decided: the program's answers against the plain
reference's, on a sample of the pool's samples that the window timed.

The cell's partition module names the number compared (`COMPARED`), its
limit (`LIMIT`), the parts of a sample it counts (`PARTS`, `parts`), how
many of them differ between two answers (`off`), and the reference.  The
number sums, over the checked samples, the parts whose answer differs
from the reference's; and over every call that served a pool sample
again, the parts whose answer differs from the first call's on that
sample (a fault that shows only once the system has been reused, such as
a stale buffer).  A checked sample is drawn from the seed among the
samples whose timed calls the partition finds checkable.
"""

from __future__ import annotations

import time

from cnvbench.generator import rng_of

CHECK_STREAM = 1 << 20       # the draw of checked samples, apart from
                             # the pool's streams


def draw(served, count: int, seed: int) -> list[int]:
    """`count` of the pool indices in `served`, drawn from the seed."""
    served = sorted(served)
    if not served:
        return []
    rng = rng_of(seed, CHECK_STREAM)
    pick = rng.choice(len(served), size=min(count, len(served)),
                      replace=False)
    return sorted(served[i] for i in pick)


def check(pool: list, outputs: dict, repeats: list, served, count: int,
          seed: int, partition, device, log) -> tuple[dict, dict]:
    """(checks, info): checks {COMPARED: {"value", "limit"}} over `count`
    samples drawn from `served`, each the program's `outputs[k]` against
    partition.reference(pool[k], device), and over `repeats`, (k, output)
    pairs each against outputs[k]; info the samples, the repeats, the
    parts and seconds."""
    picked = draw(served, count, seed)
    t0 = time.perf_counter()
    what = partition.PARTS
    off = sum(partition.off(out, outputs[k]) for k, out in repeats)
    parts = sum(partition.parts(pool[k]) for k, _ in repeats)
    log(f"check: {len(repeats)} repeated calls: {off} of {parts} {what} "
        f"off the first call's")
    for k in picked:
        t = time.perf_counter()
        want = partition.reference(pool[k], device)
        n_off = partition.off(outputs[k], want)
        off += n_off
        n = partition.parts(pool[k])
        parts += n
        log(f"check: sample {k}: {n_off} of {n} {what} off the "
            f"reference ({time.perf_counter() - t:.2f} s)")
    info = {"samples": picked, "repeats": len(repeats), "parts": parts,
            "seconds": time.perf_counter() - t0}
    return {partition.COMPARED: {"value": off,
                                 "limit": partition.LIMIT}}, info


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
