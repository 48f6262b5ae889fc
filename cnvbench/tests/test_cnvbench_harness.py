"""The harness on the CPU at a tiny size: a cell end to end, the last
line's shape, files found by name, the import check, the trace's
readings, and the faults that must make `correct` false."""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cnvbench import check, generator, harness, run, spec, trace
from cnvbench.tests.conftest import ROOT, CpuSystem, tiny_tree

CPU = torch.device("cpu")
SEED = 2 ** 31 + 7
WARM_POOL = harness.WARM_CALLS   # a pool the warm calls cover whole


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture(scope="module")
def cell(tree):
    return spec.load_cell("tiny.cell", tree / "BENCHMARK.json",
                          tree / "cnvbench")


@pytest.fixture(scope="module")
def warm_cell(cell):
    """The tiny cell with a pool that the warm calls serve whole, so that
    a system that keeps each sample's answer runs many calls in the
    window."""
    return dataclasses.replace(cell, mix={**cell.mix, "pool": WARM_POOL})


@pytest.fixture(scope="module")
def result(cell):
    return harness.run_cell(cell, SEED, 0.5, False, CPU, time.perf_counter(),
                            system=CpuSystem())


def test_tiny_cell_end_to_end(result):
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"bins_per_s", "sample_p95_ms",
                                      "setup_s"}
    assert result["checks"] == {"contigs_off": {"value": 0, "limit": 0}}


def test_last_line_shape(result):
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_traced_run_reports_per_layer_metrics(cell):
    out = harness.run_cell(cell, SEED, 0.2, True, CPU, time.perf_counter(),
                           system=CpuSystem())
    assert out["correct"] is True
    # counters only: the CPU has no device trace to read
    assert set(out["metrics"]) == {"cbs.mega_share", "cbs.levels",
                                   "engine.replays"}
    assert out["metrics"]["cbs.mega_share"]["value"] == 100.0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_new_files_found_by_name(tmp_path):
    """A configuration, a mix and a per-layer metric that exist only as
    new files and entries are picked up by name."""
    tree = tiny_tree(tmp_path, extra_metric="calls.count")
    (tree / "cnvbench/metrics/calls.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.samples))\n")
    c = spec.load_cell("tiny.cell", tree / "BENCHMARK.json",
                       tree / "cnvbench")
    assert c.config["name"] == "tiny_wgs" and c.mix["name"] == "tiny_mix"
    assert "calls.count" in c.readers
    ctx = harness.Context(samples=[{}, {}, {}])
    assert c.readers["calls.count"](ctx) == 3.0
    assert [m["name"] for m in c.end_to_end] == ["bins_per_s",
                                                 "sample_p95_ms", "setup_s"]


def test_repo_cells_load():
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        c = spec.load_cell(w["name"])
        assert c.readers and c.config["contigs"] and c.mix["pool"] > 0
        assert "partition" not in c.config
        assert c.partition.__file__ == str(ROOT / "cnvbench/partitions/cbs.py")


def test_import_check_compares_top_level_names_whole(monkeypatch):
    for name in ("canvas_tpu_torch", "canvas_tpu_torchx", "jaxy", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    for name in ("canvas_tpu", "jax.numpy", "jaxlib", "flax.linen",
                 "canvas_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == ["canvas_tpu", "canvas_tpu.ops",
                                       "flax.linen", "jax.numpy", "jaxlib"]


def test_harness_loads_no_jax():
    code = ("import sys; import cnvbench.harness, cnvbench.control, "
            "canvas_tpu_torch.ops.cbs, canvas_tpu_torch.ops.cbs_mega; "
            "from cnvbench import run, spec; spec.load_partition('cbs'); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, cnvbench.reference.cbs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'canvas_tpu', 'canvas_tpu_torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "cnvbench.run", "--workload",
         "lowpass.tumour", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_cli_alone_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and cnvbench/, the
    program is missing: a non-zero exit and no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cnvbench", tmp_path / "cnvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "cnvbench.run", "--workload",
         "lowpass.tumour", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


# --- faults: the timed path broken underneath, `correct` must be false --

class Broken:
    """The real system with its answers broken as `fault` says (None: as
    they are).  It runs the engine once a sample and keeps its answer."""

    def __init__(self, fault: str):
        self.inner = CpuSystem()
        self.fault = fault
        self.calls = 0
        self.memo: dict = {}        # the engine's answer, once a sample

    def __call__(self, sample):
        if id(sample) not in self.memo:
            self.memo[id(sample)] = self.inner(sample)
        out, info = self.memo[id(sample)]
        names = list(sample)
        self.calls += 1
        if self.fault == "stale_on_reuse":
            # right on the warm calls and the window's first pass over the
            # pool, wrong on every call after
            if self.calls > harness.WARM_CALLS + len(self.memo):
                c = names[0]
                out = {**out, c: np.asarray([len(sample[c]) - 1, 1])}
        elif self.fault == "unchanged":        # no split at all
            out = {c: np.asarray([len(sample[c])]) for c in names}
        elif self.fault == "half_left_out":  # every other contig dropped
            out = {c: out[c] for i, c in enumerate(names) if i % 2 == 0}
        elif self.fault == "one_answer_altered":
            c = max(names, key=lambda c: len(out[c]))
            v = np.array(out[c])
            if len(v) > 1:
                v[0] += 1
                v[1] -= 1
            else:
                v = np.asarray([v[0] - 1, 1])
            out = {**out, c: v}
        return out, info


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "one_answer_altered", "stale_on_reuse"])
def test_faults_fail_the_check(warm_cell, fault):
    out = harness.run_cell(warm_cell, SEED, 0.5, False, CPU,
                           time.perf_counter(), system=Broken(fault))
    assert out["correct"] is False
    assert out["checks"]["contigs_off"]["value"] >= 1
    if fault == "stale_on_reuse":
        assert out["check_repeats"] >= 1


def test_repeats_are_checked(warm_cell):
    """Every timed call after a pool sample's first is a repeat, held to
    the first call's answer on that sample."""
    out = harness.run_cell(warm_cell, SEED, 0.5, False, CPU,
                           time.perf_counter(), system=Broken(None))
    assert out["correct"] is True
    assert out["check_repeats"] == out["attempted"] - WARM_POOL >= 1


def test_failed_calls_fail_the_run(cell):
    inner = CpuSystem()
    calls = []

    def flaky(sample):                    # the timed calls raise
        calls.append(1)
        if len(calls) > harness.WARM_CALLS:
            raise RuntimeError("injected")
        return inner(sample)
    out = harness.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter(),
                           system=flaky)
    assert out["correct"] is False and out["failed"] == out["attempted"]


# --- the generator ---------------------------------------------------------

def test_pool_is_the_designs_in_the_seeds_order(cell):
    """Every seed gets the same samples, bin for bin, in another order."""
    a = generator.make_pool(cell.config, cell.mix, SEED, CPU)
    b = generator.make_pool(cell.config, cell.mix, SEED, CPU)
    c = generator.make_pool(cell.config, cell.mix, SEED + 1, CPU)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)

    def key(s):
        return b"".join(v.tobytes() for v in s.values())
    assert sorted(map(key, a)) == sorted(map(key, c))
    assert all(v.dtype == np.float32 for s in a for v in s.values())


def test_fixed_bins_follow_the_bin_size():
    c = json.loads((ROOT / "cnvbench/configs/somatic_lowpass_wgs.json")
                   .read_text())
    n = generator.contig_bins(c)
    assert n["chr1"] == 49_791 and sum(n.values()) == 617_641


def test_manifest_targets_and_pseudo_counts():
    """The targets kind takes a manifest's targets a contig; the
    pseudo-counts are f32(ratio x counts_per_ratio)."""
    cfg = {"contigs": {"a": 10_000_000, "b": 5_000_000},
           "bins": {"kind": "targets", "per_contig": {"a": 300, "b": 120}},
           "coverage": {"kind": "ratio_pseudo_counts",
                        "counts_per_ratio": 40, "log2_sd": [0.0, 0.0]}}
    mix = {"pool": 2, "design_seed": 3, "purity": [1.0, 1.0],
           "events": [0, 0], "arm_share": 0.5, "arm_bp": [1e6, 2e6],
           "focal_bp": [1e5, 2e5], "min_event_bins": 1,
           "copy_numbers": [3], "focal_only": []}
    pool = generator.make_pool(cfg, mix, SEED, CPU)
    assert [len(pool[0][c]) for c in ("a", "b")] == [300, 120]
    assert all(np.all(v == 40.0) for s in pool for v in s.values())


def test_check_draws_from_the_seed():
    assert check.draw(range(48), 2, 5) == check.draw(range(48), 2, 5)
    assert len(check.draw({3, 9}, 4, 5)) == 2 and check.draw([], 2, 5) == []


# --- the trace -------------------------------------------------------------

def _trace_doc():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return {"traceEvents": [
        x("user_annotation", trace.SAMPLE, 0, 100),
        x("user_annotation", trace.SAMPLE, 120, 80),
        x("cpu_op", "aten::copy_", 0, 30),
        x("cuda_runtime", "cudaGraphLaunch", 40, 5),
        x("cuda_runtime", "cudaMemcpyAsync", 60, 40),
        x("kernel", "(anonymous namespace)::walk_kernel((anonymous "
                    "namespace)::WalkArgs)", 10, 20),
        x("kernel", "void (anonymous namespace)::arc_scan_blocks<2>("
                    "float const*)", 25, 15),
        x("kernel", "arc_scan_replay(float const*)", 130, 10),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 5),
        x("gpu_user_annotation", trace.SAMPLE, 0, 100),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 3}]}


def test_trace_readings():
    t = trace.parse(_trace_doc())
    assert t.window == (0.0, 200.0)
    assert trace.device_busy(t) == 30 + 5 + 10
    assert trace.kernel_us(t, {"walk_kernel"}) == 20
    assert trace.kernel_us(t, {"arc_scan_blocks", "arc_scan_replay"}) == 25
    ctx = harness.Context(trace=t)
    read = {m: spec.load_reader(ROOT / f"cnvbench/metrics/{m}.py")
            for m in ("device.idle_share", "engine.host_ms",
                      "kernel.walk_ms", "kernel.arc_scan_ms")}
    assert read["device.idle_share"](ctx) == pytest.approx(100 * 155 / 200)
    assert read["engine.host_ms"](ctx) == pytest.approx(
        ((100 - 35) + (80 - 10)) / 2 / 1e3)
    assert read["kernel.walk_ms"](ctx) == pytest.approx(0.01)
    assert read["kernel.arc_scan_ms"](ctx) == pytest.approx(0.0125)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["walk_kernel", 20e-6]
    gaps = dict(b["idle_gaps"])
    # idle: 0-10 under aten::copy_, 40-45 under the graph launch, 45-60
    # in the call's own code, 60-90 and 95-100 under the copy call,
    # 100-120 between calls, 120-130 and 140-200 in the second call
    assert gaps == pytest.approx({
        "aten::copy_": 10e-6, "cudaGraphLaunch": 5e-6,
        "cudaMemcpyAsync": 35e-6, "harness, between calls": 20e-6,
        "system, host code outside torch calls": 85e-6})


def test_trace_readers_find_nothing_without_a_trace():
    ctx = harness.Context(samples=[], trace=None)
    for m in ("device.idle_share", "engine.host_ms", "kernel.walk_ms",
              "kernel.arc_scan_ms", "cbs.levels", "engine.replays",
              "cbs.mega_share", "bins_per_s", "sample_p95_ms"):
        assert spec.load_reader(ROOT / f"cnvbench/metrics/{m}.py")(ctx) \
            is None
