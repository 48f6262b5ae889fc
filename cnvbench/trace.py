"""The traced window: torch.profiler over the host and the card, its
chrome trace read back into device intervals, host events and the
samples' spans, all on the trace's clock (microseconds).

The benchmark's own spans are `SAMPLE` annotations around each call of
the system; the program's kernels are known by their function names.
A traced run records the calls that start in the first TRACE_SECONDS of
its window: the profiler's processing grows with the events recorded,
and the run has to end in its time.
"""

from __future__ import annotations

import heapq
import json
import re
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

SAMPLE = "cnvbench.sample"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
TOP = 10
TRACE_SECONDS = 5.0


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (name, start, end)
    samples: list = field(default_factory=list)  # (start, end)

    @property
    def window(self) -> tuple[float, float] | None:
        if not self.samples:
            return None
        return self.samples[0][0], self.samples[-1][1]


def parse(doc: dict) -> Trace:
    """A Trace from a chrome trace's JSON object."""
    t = Trace()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            t.device.append((name, *span))
        elif cat == "user_annotation" and name == SAMPLE:
            t.samples.append(span)
        elif cat in HOST_CATS:
            t.host.append((name, *span))
    for v in (t.device, t.host, t.samples):
        v.sort(key=lambda e: (e[-2], e[-1]))
    return t


class Profiled:
    """torch.profiler over the host and the card between start() and
    stop(); `trace` is the Trace after stop().  The chrome trace goes to
    a temporary file in TMPDIR and is deleted."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.trace: Trace | None = None
        self.active = False

    def start(self) -> None:
        self._prof.start()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._prof.stop()
        self.active = False
        with tempfile.TemporaryDirectory(prefix="cnvbench-") as d:
            path = Path(d) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            self.trace = parse(json.loads(path.read_text()))


def annotate():
    """The span of one call of the system in the trace."""
    import torch

    return torch.profiler.record_function(SAMPLE)


def union(spans) -> list[tuple[float, float]]:
    """Merged, sorted intervals of (start, end) or (name, start, end)."""
    out: list[list[float]] = []
    for s in sorted((e[-2], e[-1]) for e in spans):
        if out and s[0] <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s[1])
        else:
            out.append([s[0], s[1]])
    return [(a, b) for a, b in out]


def covered(merged, a: float, b: float) -> float:
    """The length of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def short_name(name: str) -> str:
    """A kernel's function name without its namespace and signature."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?(?:[A-Za-z_]\w*::)*([A-Za-z_]\w*)\s*[(<]",
                 name)
    return m.group(1) if m else name[:60]


def device_busy(trace: Trace) -> float:
    """Microseconds of the window in which an operation ran on the card."""
    w = trace.window
    return covered(union(trace.device), *w) if w else 0.0


def kernel_us(trace: Trace, names) -> float:
    """Device microseconds of the kernels whose function is one of names,
    inside the window."""
    w = trace.window
    if not w:
        return 0.0
    return sum(max(0.0, min(e, w[1]) - max(s, w[0]))
               for n, s, e in trace.device if short_name(n) in names)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the card's idle
    time summed by what the host was doing meanwhile (the innermost host
    event running, or the system's own host code inside a call, or the
    harness between calls), seconds each."""
    w = trace.window
    if not w:
        return {"device_ops": [], "idle_gaps": []}
    ops: dict = {}
    for n, s, e in trace.device:
        d = max(0.0, min(e, w[1]) - max(s, w[0]))
        if d > 0:
            k = short_name(n)
            ops[k] = ops.get(k, 0.0) + d
    gaps: dict = {}
    merged = union(trace.device)
    edges = [w[0]] + [x for s, e in merged for x in (s, e)] + [w[1]]
    host, samples = trace.host, trace.samples
    active: list = []   # a heap of (-start, end, name), latest start on top
    i = j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        t, b = max(a, w[0]), min(b, w[1])
        while t < b:
            while i < len(host) and host[i][1] <= t:
                n, s, e = host[i]
                heapq.heappush(active, (-s, e, n))
                i += 1
            while active and active[0][1] <= t:
                heapq.heappop(active)
            while j < len(samples) and samples[j][1] <= t:
                j += 1
            call = samples[j] if j < len(samples) else (b, b)
            inside = call[0] <= t
            nxt = min(b, host[i][1] if i < len(host) else b,
                      active[0][1] if active else b,
                      call[1] if inside else call[0])
            if active:
                label = active[0][2]
            elif inside:
                label = "system, host code outside torch calls"
            else:
                label = "harness, between calls"
            gaps[label] = gaps.get(label, 0.0) + (nxt - t)
            t = nxt

    def top(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
