"""canvas_tpu_torch's spans and counters inside the CBS entry and the
whole-recursion engine, and the benchmark's readers of them, on the CPU:
the span helper off and on, the spans a call records and their order, the
stopping boundary's and the engine's counters, the operator report's
counters, and each reader on a synthetic trace."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from canvas_tpu_torch.ops import cbs, cbs_mega
from canvas_tpu_torch.pipeline import profiling, runner
from cnvbench import harness, spec, trace

ROOT = Path(__file__).resolve().parent.parent
N_PERM = 1000
SPANS = ("cbs.run", "cbs.prepare", "engine.start", "engine.batch",
         "engine.read", "cbs.assemble")


def _step_input():
    """Two contigs: a step of +3 at bin 300 of 600, and 400 bins of
    noise, so the first level analyses both whole and the second the
    step's two pieces."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 600)
    a[300:] += 3.0
    return {"a": a, "b": rng.normal(0, 1, 400)}


def _pairs(n: int) -> int:
    return n * (n + 1) // 2


@pytest.fixture
def counting_record_function(monkeypatch):
    """torch.profiler.record_function replaced by a wrapper that counts
    the ranges entered."""
    entered = []
    orig = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return orig(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return entered


def test_span_off_enters_no_record_function(counting_record_function):
    assert not torch.autograd._profiler_enabled()
    with profiling.span("cbs.prepare"):
        pass
    cbs_mega.run_cbs_mega(_step_input(), n_perm=N_PERM, device="cpu")
    assert counting_record_function == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("cbs.prepare"):
            pass
    assert counting_record_function == ["cbs.prepare"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A CPU profiler's trace of run_cbs_mega inside an outer range, then
    of run_cbs (the host path on the CPU), read by cnvbench.trace."""
    cov = _step_input()
    cbs_mega.run_cbs_mega(cov, n_perm=N_PERM, device="cpu")    # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            out = cbs_mega.run_cbs_mega(cov, n_perm=N_PERM, device="cpu")
        cbs.run_cbs(cov, n_perm=N_PERM, device="cpu")
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())


def test_engine_spans_in_order_inside_the_call(traced):
    out, doc = traced
    t = trace.parse(doc)
    (o0, o1), = [(s, e) for n, s, e in t.host if n == "outer"]
    inside = [n for n, s, e in t.host
              if n in SPANS and o0 <= s and e <= o1]
    assert len(out["a"]) == 2      # two levels: each its batch and read
    assert inside == ["cbs.prepare", "engine.start", "engine.batch",
                      "engine.read", "engine.batch", "engine.read",
                      "cbs.assemble"]
    # run_cbs, after the outer range: its root span, around the host path
    runs = [(s, e) for n, s, e in t.host if n == "cbs.run"]
    assert len(runs) == 1 and runs[0][0] >= o1
    assert not [n for n, s, e in t.host
                if n in SPANS[1:] and s >= runs[0][0]]


def test_spans_are_host_events_never_device_intervals(traced):
    _, doc = traced
    t = trace.parse(doc)
    assert set(SPANS) <= {n for n, _, _ in t.host}
    # on the card the profiler also puts each range on the device's
    # timeline, as a gpu_user_annotation: still no device interval
    card = {"traceEvents": doc["traceEvents"] + [
        {"ph": "X", "cat": "gpu_user_annotation", "name": n, "ts": 1.0,
         "dur": 2.0} for n in SPANS]}
    assert not [n for n, _, _ in trace.parse(card).device if n in SPANS]


def test_boundary_counts_each_computation_once():
    args = (700, 0.01, 0.05)     # no other test's boundary
    before = dict(cbs.BOUNDARY)
    cbs.compute_boundary(*args)
    cbs.compute_boundary(*args)
    assert cbs.BOUNDARY["computed"] == before["computed"] + 1
    assert cbs.BOUNDARY["seconds"] > before["seconds"]


def test_work_counts_the_arc_pairs_of_each_level():
    """The first level analyses each contig whole; the second, the two
    pieces of the split contig; the other is no longer pending."""
    work0, note0 = dict(cbs_mega.WORK), runner._cbs_work()
    counts: dict = {}
    out = cbs_mega.run_cbs_mega(_step_input(), n_perm=N_PERM, device="cpu",
                                counts=counts)
    l1, l2 = out["a"]
    assert counts["levels"] == 2 and len(out["b"]) == 1
    want = _pairs(600) + _pairs(400) + _pairs(int(l1)) + _pairs(int(l2))
    assert counts["arc_pairs"] == want
    # B4's arc terms are the kernel's tally: none on CPU tensors
    assert counts["arc_terms"] == 0
    assert cbs_mega.WORK == {
        "calls": work0["calls"] + 1,
        "arc_pairs": work0["arc_pairs"] + want,
        "walk_chunks": work0["walk_chunks"] + counts["walk_chunks"],
        "arc_terms": work0["arc_terms"]}
    note = {k: v - note0[k] for k, v in runner._cbs_work().items()}
    # on CPU tensors the levels run eagerly, a read after each
    assert note == {"engine_calls": 1, "arc_pairs": want,
                    "walk_chunks": counts["walk_chunks"],
                    "graph_replays": 0, "engine_reads": 2}


def _reader(name):
    return spec.load_reader(ROOT / f"cnvbench/metrics/{name}.py")


def test_arc_terms_reader_without_the_word(monkeypatch):
    """A program whose tally has no arc terms (before B4 kept one) reads
    nothing, and raises nothing."""
    monkeypatch.setattr(cbs_mega, "WORK", {
        "calls": 4, "walk_chunks": 50, "arc_pairs": 38_000_000_000})
    read = _reader("kernel.arc_terms_m")
    assert read(harness.Context(trace=_card_trace())) is None


def _card_trace():
    """Two traced calls, 0-100 and 100-200 us, with a kernel and the
    program's spans; a span crossing the window's end is cut there."""
    return trace.Trace(
        device=[("walk_kernel", 10.0, 30.0)],
        host=[("cbs.run", 1.0, 99.0), ("cbs.prepare", 2.0, 6.0),
              ("engine.start", 6.0, 7.0), ("engine.read", 8.0, 40.0),
              ("engine.read", 41.0, 45.0), ("cbs.assemble", 46.0, 49.0),
              ("cbs.prepare", 101.0, 103.0), ("engine.start", 103.0, 104.0),
              ("engine.read", 105.0, 150.0), ("cbs.assemble", 195.0, 205.0)],
        samples=[(0.0, 100.0), (100.0, 200.0)])


@pytest.mark.parametrize("name,want", [
    ("cbs.prepare_ms", (4 + 2) / 2 / 1e3),
    ("cbs.assemble_ms", (3 + 5) / 2 / 1e3),
    ("engine.start_ms", (1 + 1) / 2 / 1e3),
    ("engine.read_wait_ms", (32 + 4 + 45) / 2 / 1e3),
])
def test_span_readers(name, want):
    read = _reader(name)
    assert read(harness.Context(trace=_card_trace())) == pytest.approx(want)
    assert read(harness.Context(trace=None)) is None
    # a trace without the span (the parent's program) reads nothing
    bare = _card_trace()
    bare.host = [e for e in bare.host if e[0] == "cbs.run"]
    assert read(harness.Context(trace=bare)) is None


class _Engine:
    def __init__(self, capture_s):
        self.capture_s = capture_s


@pytest.mark.parametrize("name,want", [
    ("cbs.boundary_s", 4.5), ("engine.capture_s", 1.25),
    ("kernel.arc_pairs_m", 9_500.0), ("kernel.walk_chunks", 12.5),
    ("kernel.arc_terms_m", 1_250.0),
])
def test_counter_readers(monkeypatch, name, want):
    monkeypatch.setattr(cbs, "BOUNDARY", {"computed": 1, "seconds": 4.5})
    monkeypatch.setattr(cbs_mega, "WORK", {
        "calls": 4, "walk_chunks": 50, "arc_pairs": 38_000_000_000,
        "arc_terms": 5_000_000_000})
    monkeypatch.setattr(cbs_mega, "_ENGINES", {
        torch.device("cuda", 0): _Engine(1.25)})
    read = _reader(name)
    assert read(harness.Context(trace=_card_trace())) == pytest.approx(want)
    assert read(harness.Context(trace=None)) is None
    # the parent's program keeps no such counter: nothing to read
    monkeypatch.delattr(cbs, "BOUNDARY")
    monkeypatch.delattr(cbs_mega, "WORK")
    monkeypatch.setattr(cbs_mega, "_ENGINES", {
        torch.device("cuda", 0): _Engine(None)})
    assert read(harness.Context(trace=_card_trace())) is None
