"""What a run needs, found by name: the cell's entry in BENCHMARK.json,
its configuration (the entry's file, configs/<config>.json), the module of
the partition method that the configuration names in its `partition` key
(partitions/<name>.py; `cbs` where it names none), its traffic mix
(traffic/<traffic>.json) and a reader for each of its metrics
(metrics/<metric>.py, a `read(ctx)` that returns a number or None).

A later cell, mix, configuration or metric is a new entry and new files;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
BENCHMARK = BENCH_DIR.parent / "BENCHMARK.json"
DEFAULT_PARTITION = "cbs"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    partition: ModuleType           # partitions/<name>.py
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    readers: dict = field(default_factory=dict)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_module(prefix: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(path: Path):
    """The `read` function of a metric's reader file."""
    return _load_module("cnvbench_metric_", path).read


def load_partition(name: str, bench_dir: Path = BENCH_DIR):
    """The module of the partition method `name`, partitions/<name>.py."""
    return _load_module("cnvbench_partition_",
                        bench_dir / "partitions" / f"{name}.py")


def load_cell(workload: str, benchmark: Path = BENCHMARK,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named `workload`, with its files read.  Raises KeyError
    for a name that BENCHMARK.json does not have, FileNotFoundError for a
    file that is missing."""
    doc = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    w = cells[workload]
    configs = {c["name"]: c for c in doc["configs"]}
    config = json.loads((Path(benchmark).parent
                         / configs[w["config"]]["file"]).read_text())
    partition = load_partition(config.get("partition", DEFAULT_PARTITION),
                               bench_dir)
    mix = json.loads((bench_dir / "traffic"
                      / f"{w['traffic']}.json").read_text())
    e2e = [m for m in doc["end_to_end"] if _reports(m, workload)]
    per_layer = [m for m in doc["per_layer"] if _reports(m, workload)]
    readers = {m["name"]: load_reader(bench_dir / "metrics"
                                      / f"{m['name']}.py")
               for m in e2e + per_layer}
    return Cell(workload, w["chips"], config, mix, partition, e2e, per_layer,
                readers)
