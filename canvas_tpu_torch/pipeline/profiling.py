"""Per-stage timing + structured run metrics (SURVEY.md §5), and the
program's spans.

The reference scatters timestamped Console.WriteLine progress lines and two
Stopwatch timers; here every stage runs under a `stage(...)` context that
records wall time and peak RSS into a run-wide report that the
orchestrator writes as JSON next to the outputs.  On a CUDA device a stage
synchronizes the device before it reads the clock, so a stage's time holds
the device work it queued.

`span(name)` marks a phase inside a call (the CBS entry's preparation, the
engine's set-up, replay batches and reads, the assembly) for a torch
profiler that someone else runs: while one records, the span is a
`torch.profiler.record_function` range, kept by the profiler with the
kernels and written into its trace on their clock; while none records it
is a shared no-op context after one check of the profiler's state.
"""

from __future__ import annotations

import contextlib
import json
import resource
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass
class StageRecord:
    name: str
    seconds: float
    peak_rss_mb: float
    extra: dict = field(default_factory=dict)


@dataclass
class RunProfile:
    records: list[StageRecord] = field(default_factory=list)
    started: float = field(default_factory=time.time)
    # optional stage-boundary hook (the workflows install
    # Checkpointer.stage here so -c/-s start/stop-checkpoint flags see
    # every stage transition; raising from it aborts the workflow)
    gate: object = None
    # the run's device; stage clocks are read after a device sync on CUDA
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str, **extra):
        if self.gate is not None:
            self.gate(name)
        self._sync()
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            self.records.append(StageRecord(name, dt, rss, extra))

    def note(self, name: str, **extra) -> None:
        self.records.append(StageRecord(name, 0.0, 0.0, extra))

    def report(self) -> dict:
        return {
            "total_seconds": time.time() - self.started,
            "stages": [
                {"name": r.name, "seconds": round(r.seconds, 3),
                 "peak_rss_mb": round(r.peak_rss_mb, 1), **r.extra}
                for r in self.records
            ],
        }

    def write(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2) + "\n")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a range in the torch profiler's
    trace while a profiler records, and does nothing otherwise (no
    record_function is entered: it costs microseconds even then)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


_ACTIVE: RunProfile | None = None


def current() -> RunProfile:
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = RunProfile()
    return _ACTIVE


def reset(device: str | torch.device) -> RunProfile:
    global _ACTIVE
    _ACTIVE = RunProfile(device=torch.device(device))
    return _ACTIVE
