"""One run of a cell: the pool from the seed, the system warmed on the
cell's own shape, a closed loop of one client over the pool for the
window, the metrics by their readers, then the check against the plain
reference.

What differs from one partition method to another, the pool, the system
under test, what can be checked and the reference, comes from the cell's
partition module (`partitions/<name>.py`, found by spec.py).  A call of
the system returns once its answer is on the host; the harness reads the
clock around it.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

from cnvbench import check as checks_mod
from cnvbench import trace as trace_mod

WARM_CALLS = 2          # set-up: calls on the cell's own shape
MAX_FAILED = 8          # failed calls after which the window stops


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Context:
    """What the metrics' readers read: each timed call, the window on the
    host clock (perf_counter seconds), the set-up seconds, and with
    --trace 1 the trace."""
    samples: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    setup_s: float = 0.0
    trace: trace_mod.Trace | None = None


def measure(system, pool: list, seconds: float, sample_bins, prof=None):
    """The closed loop: calls over the pool in order, each started when
    the last returned, until one ends past `seconds`.  With `prof` (a
    trace.Profiled), the calls that start in the window's first
    trace.TRACE_SECONDS are traced, each in its span.  Returns (records,
    outputs, repeats, window): a record a call (its bins counted by
    `sample_bins`), the first output of every pool sample, (pool index,
    output) of every later call that served a sample again, and the
    window's (start, end)."""
    records, outputs, repeats = [], {}, []
    failed = 0
    if prof is not None:
        prof.start()            # seconds on a first start: kept out
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        k = i % len(pool)
        if prof is not None and \
                time.perf_counter() - start >= trace_mod.TRACE_SECONDS:
            prof.stop()
        t0 = time.perf_counter()
        try:
            with trace_mod.annotate() if prof is not None and prof.active \
                    else nullcontext():
                out, info = system(pool[k])
            ok = out is not None
        except Exception:                       # a failed call is counted
            if not failed:
                log(traceback.format_exc())
            out, info, ok = None, {}, False
        t1 = time.perf_counter()
        failed += not ok
        records.append({"k": k, "bins": sample_bins(pool[k]),
                        "t0": t0, "t1": t1, "ok": ok, **info})
        if ok:
            if k in outputs:
                repeats.append((k, out))
            else:
                outputs[k] = out
        i += 1
        if t1 >= deadline or failed >= MAX_FAILED:
            if prof is not None:
                prof.stop()
            return records, outputs, repeats, (start, t1)


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_process: float, system=None) -> dict:
    """One run: the result line's object, `checks` last."""
    part = cell.partition
    t0 = time.perf_counter()
    pool = part.make_pool(cell.config, cell.mix, seed, device)
    t1 = time.perf_counter()
    system = system or part.System(device, cell.config)
    for k in range(min(WARM_CALLS, len(pool))):
        system(pool[k])
    log(f"set-up: process start to the pool {t0 - t_process:.3f} s, the "
        f"pool {t1 - t0:.3f} s, {WARM_CALLS} warm calls "
        f"{time.perf_counter() - t1:.3f} s")
    prof = trace_mod.Profiled() if traced else None
    # the collector's pauses stay out of the window, as in timeit
    gc.collect()
    gc.disable()
    try:
        records, outputs, repeats, window = measure(
            system, pool, seconds, part.sample_bins, prof)
    finally:
        gc.enable()
    ctx = Context(records, window, window[0] - t_process,
                  prof.trace if traced else None)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(device)
    if traced:
        busy = trace_mod.device_busy(ctx.trace) / 1e6
        w = ctx.trace.window
        dev.update(busy_s=busy, window_s=(w[1] - w[0]) / 1e6 if w else 0.0)
    if hasattr(system, "release"):
        system.release()
    failed = sum(not r["ok"] for r in records)
    served = {r["k"] for r in records if r["ok"] and part.checkable(r)}

    checks, info = checks_mod.check(
        pool, outputs, repeats, served, cell.mix["check"], seed, part,
        device, log)
    correct = checks_mod.passed(checks) and failed == 0 and bool(
        info["samples"])
    if not info["samples"]:
        log(f"check: {part.NOTHING_CHECKABLE}")
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced:
        out["breakdown"] = trace_mod.breakdown(ctx.trace)
    out["check_samples"] = info["samples"]
    out["check_repeats"] = info["repeats"]
    out["check_seconds"] = info["seconds"]
    out["checks"] = checks
    return out
