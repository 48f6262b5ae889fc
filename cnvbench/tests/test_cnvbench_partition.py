"""A configuration of another partition method, added as new files only:
a throwaway benchmark tree whose configuration names the partition `toy`
(the change points of piecewise-constant tracks), run through the
unchanged harness, check and control.  Also the files that name no
program module, and a partition that has no file."""

import ast
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from cnvbench import control, harness, spec
from cnvbench.tests.conftest import BENCH, ROOT

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5

TOY = '''"""A toy partition method: the change points of piecewise-constant
tracks, levels a quarter apart near 1,000."""

import numpy as np

COMPARED = "steps_off"
LIMIT = 0
PARTS = "tracks"
NOTHING_CHECKABLE = "the toy served nothing checkable"
WRONG = None            # the design index of a sample answered wrongly
CHECKABLE = True


def _rng(*key):
    return np.random.default_rng([k % (1 << 64) for k in key])


def design(seed, size):
    return _rng(seed).permutation(size)


def make_pool(config, mix, seed, device):
    pool = []
    n = config["bins"]
    for i in range(mix["pool"]):
        rng = _rng(mix["design_seed"], i)
        tracks = {}
        for t in range(config["tracks"]):
            cuts = np.sort(rng.choice(np.arange(1, n), 7, replace=False))
            levels = 1000.0 + 0.25 * rng.permutation(8)
            tracks[f"t{t}"] = np.repeat(
                levels, np.diff(np.r_[0, cuts, n])).astype(np.float32)
        pool.append({"index": i, "tracks": tracks})
    return [pool[i] for i in design(seed, len(pool))]


def sample_bins(sample):
    return sum(len(v) for v in sample["tracks"].values())


class System:
    def __init__(self, device, config):
        self.calls = 0

    def __call__(self, sample):
        self.calls += 1
        out = {t: np.flatnonzero(np.diff(v)) + 1
               for t, v in sample["tracks"].items()}
        if sample["index"] == WRONG:
            out["t0"] = out["t0"][1:]
        return out, {"calls": self.calls, "checkable": CHECKABLE}

    def release(self):
        pass


def checkable(record):
    return record["checkable"]


def _steps(tracks):
    return {t: [i for i in range(1, len(v)) if v[i] != v[i - 1]]
            for t, v in tracks.items()}


def reference(sample, device):
    return _steps(sample["tracks"])


def control(sample, device):
    return _steps({t: v.astype(np.float16)
                   for t, v in sample["tracks"].items()})


VARIANTS = {"same": reference}


def parts(sample):
    return len(sample["tracks"])


def off(got, want):
    return sum(list(got.get(t, [])) != list(w) for t, w in want.items())
'''

CALLS_READER = "def read(ctx):\n    return float(ctx.samples[-1]['calls'])\n"


def toy_tree(tmp: Path, partition: str = "toy", **consts) -> Path:
    """A benchmark tree under tmp with one toy cell: BENCHMARK.json, the
    configuration, the mix, partitions/toy.py (its constants set from
    `consts`) and the readers of its metrics."""
    bench = tmp / "cnvbench"
    for d in ("configs", "traffic", "partitions", "metrics"):
        (bench / d).mkdir(parents=True)
    toy = TOY
    for name, value in consts.items():
        toy = toy.replace(f"\n{name} = ", f"\n{name} = {value!r}  # ", 1)
    (bench / "partitions/toy.py").write_text(toy)
    (bench / "configs/toy_tracks.json").write_text(json.dumps(
        {"name": "toy_tracks", "partition": partition, "tracks": 3,
         "bins": 400}))
    (bench / "traffic/toy_mix.json").write_text(json.dumps(
        {"name": "toy_mix", "pool": 3, "check": 3, "design_seed": 11}))
    for m in ("bins_per_s", "sample_p95_ms", "setup_s"):
        shutil.copy(BENCH / f"metrics/{m}.py", bench / "metrics")
    (bench / "metrics/toy.calls.py").write_text(CALLS_READER)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "toy_tracks", "source": "a test",
                       "file": "cnvbench/configs/toy_tracks.json",
                       "reduced": [], "why": "a test"}]
    doc["workloads"] = [{"name": "toy.cell", "config": "toy_tracks",
                         "traffic": "toy_mix", "chips": 1, "why": "a test"}]
    doc["per_layer"] = [{"name": "toy.calls", "unit": "calls",
                         "better": "higher", "source": "program_counter",
                         "layer": "toy", "moves": "bins_per_s",
                         "workloads": ["toy.cell"]}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp


def toy_cell(tmp: Path, **consts):
    tree = toy_tree(tmp, **consts)
    return spec.load_cell("toy.cell", tree / "BENCHMARK.json",
                          tree / "cnvbench")


def run(cell, traced=False):
    return harness.run_cell(cell, SEED, 0.2, traced, CPU,
                            time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
def test_toy_cell_runs_through_the_harness(tmp_path, traced):
    out = run(toy_cell(tmp_path), traced)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"] == {"steps_off": {"value": 0, "limit": 0}}
    assert out["check_samples"] == [0, 1, 2] and out["check_repeats"] >= 1
    want = {"toy.calls"} if traced else {"bins_per_s", "sample_p95_ms",
                                         "setup_s"}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


def test_toy_answering_one_sample_wrongly_is_not_correct(tmp_path):
    out = run(toy_cell(tmp_path, WRONG=1))
    assert out["correct"] is False
    assert out["checks"]["steps_off"]["value"] >= 1


def test_toy_with_nothing_checkable_is_not_correct(tmp_path, capsys):
    out = run(toy_cell(tmp_path, CHECKABLE=False))
    assert out["correct"] is False and out["check_samples"] == []
    assert "check: the toy served nothing checkable" in capsys.readouterr().err


def test_control_readings_on_the_toy_cell(tmp_path):
    r = control.readings(toy_cell(tmp_path), SEED, CPU, program=True,
                         variants=("same",))
    assert r["samples"] == [0, 1, 2] and r["parts"] == 9
    assert r["program_off"] == 0 and r["same_off"] == 0
    assert r["control_off"] >= 1
    assert sorted(s["design"] for s in r["by_sample"]) == [0, 1, 2]


def test_a_partition_with_no_file_is_refused(tmp_path):
    tree = toy_tree(tmp_path, partition="absent")
    with pytest.raises(FileNotFoundError):
        spec.load_cell("toy.cell", tree / "BENCHMARK.json",
                       tree / "cnvbench")


@pytest.mark.parametrize("module", ["harness.py", "check.py", "control.py"])
def test_shared_files_name_no_method(module):
    """The files every partition method shares import nothing of the
    program's operations or of a reference: those are the partition
    module's."""
    tree = ast.parse((BENCH / module).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module
              for a in n.names]
    assert not [n for n in names
                if n.startswith(("canvas_tpu_torch", "cnvbench.reference"))]
