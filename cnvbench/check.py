"""How `correct` is decided: the program's segments against the plain
reference's, on a sample of the pool's samples that the window timed.

The number compared is `contigs_off`: over the checked samples, the
contigs whose segment lengths differ from the reference's in any way;
and over every call that served a pool sample again, the contigs whose
lengths differ from the first call's on that sample (a fault that shows
only once the engine has been reused, such as a stale buffer).
CBS's outputs are discrete and the engine is deterministic (threefry
permutations from a fixed key, exact decisions), so the comparison is
exact and its limit 0.  A checked sample is drawn from the seed among the
samples that the timed calls served with the whole-recursion engine (the
reference models that engine; a sample whose segment table overflowed
went to the frontier engine, which draws other permutations).  A sample
that the engine served but the reference finds too large for the table
counts all its contigs off.
"""

from __future__ import annotations

import time

import numpy as np

from cnvbench.generator import rng_of

LIMITS = {"contigs_off": 0}
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


def contigs_off(got: dict | None, want: dict | None) -> int:
    """Contigs of one sample whose segment lengths differ."""
    if want is None or got is None:
        return len(want or got or {}) or 1
    names = set(want) | set(got)
    return sum(1 for c in names
               if c not in got or c not in want
               or not np.array_equal(np.asarray(got[c]),
                                     np.asarray(want[c])))


def check(pool: list, outputs: dict, repeats: list, served, count: int,
          seed: int, reference, log) -> tuple[dict, dict]:
    """(checks, info): checks {"contigs_off": {"value", "limit"}} over
    `count` samples drawn from `served`, each the program's `outputs[k]`
    against reference(pool[k]), and over `repeats`, (k, output) pairs each
    against outputs[k]; info the samples, the repeats, contigs and
    seconds."""
    picked = draw(served, count, seed)
    t0 = time.perf_counter()
    off = sum(contigs_off(out, outputs[k]) for k, out in repeats)
    contigs = sum(len(pool[k]) for k, _ in repeats)
    log(f"check: {len(repeats)} repeated calls: {off} of {contigs} contigs "
        f"off the first call's")
    for k in picked:
        t = time.perf_counter()
        want = reference(pool[k])
        n_off = contigs_off(outputs[k], want)
        off += n_off
        contigs += len(pool[k])
        log(f"check: sample {k}: {n_off} of {len(pool[k])} contigs off the "
            f"reference ({time.perf_counter() - t:.2f} s)")
    info = {"samples": picked, "repeats": len(repeats), "contigs": contigs,
            "seconds": time.perf_counter() - t0}
    return {"contigs_off": {"value": off,
                            "limit": LIMITS["contigs_off"]}}, info


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
