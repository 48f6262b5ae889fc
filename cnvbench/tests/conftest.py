"""The benchmark's own tests: CPU tests of the harness at tiny sizes, and
card tests (marked `cuda`) that skip without a CUDA device."""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


class CpuSystem:
    """The system's whole-recursion engine on CPU tensors, its plain
    versions (run_cbs takes the engine only on a card), with the counters
    the cbs partition's System reports."""

    def __init__(self, alpha: float = 0.01):
        from canvas_tpu_torch.ops import cbs_mega

        self._mega, self.alpha = cbs_mega, alpha

    def __call__(self, sample: dict):
        import torch

        counts: dict = {}
        out = self._mega.run_cbs_mega(sample, alpha=self.alpha,
                                      device=torch.device("cpu"),
                                      counts=counts)
        return out, {"engine": "mega" if out is not None else None,
                     "levels": counts.get("levels"), "replays": 0}

    def release(self) -> None:
        self._mega._ENGINES.clear()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_tree(tmp: Path, extra_metric: str | None = None) -> Path:
    """A benchmark tree under tmp: BENCHMARK.json with one tiny cell
    (three contigs of 120 to 300 bins) and the cnvbench data and
    partition folders, copied, with the tiny configuration and mix added
    as files."""
    bench = tmp / "cnvbench"
    for d in ("configs", "traffic", "metrics", "partitions"):
        shutil.copytree(BENCH / d, bench / d)
    cfg = json.loads((BENCH / "configs/somatic_lowpass_wgs.json")
                     .read_text())
    cfg.update(name="tiny_wgs", contigs={"chrA": 3_000_000,
                                         "chrB": 2_000_000,
                                         "chrC": 1_200_000})
    cfg["bins"] = dict(cfg["bins"], bin_bp=10_000)
    cfg["coverage"] = dict(cfg["coverage"], depth=[1.2, 1.8])
    (bench / "configs/tiny_wgs.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic/lowpass_tumour.json").read_text())
    mix.update(name="tiny_mix", pool=3, check=1, events=[1, 3],
               arm_bp=[500_000, 1_000_000], focal_bp=[100_000, 300_000])
    (bench / "traffic/tiny_mix.json").write_text(json.dumps(mix))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "tiny_wgs", "source": "a test",
                       "file": "cnvbench/configs/tiny_wgs.json",
                       "reduced": [], "why": "a test"}]
    doc["workloads"] = [{"name": "tiny.cell", "config": "tiny_wgs",
                         "traffic": "tiny_mix", "chips": 1, "why": "a test"}]
    for m in doc["per_layer"]:
        m["workloads"] = ["tiny.cell"]
    if extra_metric:
        doc["per_layer"].append({
            "name": extra_metric, "unit": "calls", "better": "higher",
            "source": "program_counter", "layer": "kernels",
            "moves": "bins_per_s", "workloads": ["tiny.cell"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp
