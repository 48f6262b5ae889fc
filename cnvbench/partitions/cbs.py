"""CanvasPartition's CBS (`-m CBS`): what the benchmark needs of this one
partition method, found by the name a configuration gives in its
`partition` key (this one is also the default).

The system under test is canvas_tpu_torch's CBS entry,
`ops.cbs.run_cbs(coverage, alpha=..., device="cuda")`, one sample's
contigs a call, as the pipeline's CanvasPartition calls it.  A call
returns after the engine's read from the card; the system synchronises
once more before the harness reads the clock.  A sample is what
CanvasPartition receives, contig -> f32 bin values, from the general
traffic generator.

The number compared is `contigs_off`: over the checked samples, the
contigs whose segment lengths differ from the plain reference's
(`reference/cbs.py`) in any way; and over every call that served a pool
sample again, the contigs whose lengths differ from the first call's on
that sample (a fault that shows only once the engine has been reused,
such as a stale buffer).  CBS's outputs are discrete and the engine is
deterministic (threefry permutations from a fixed key, exact decisions),
so the comparison is exact and its limit 0.  A sample is checkable where
the timed call served it with the whole-recursion engine (the reference
models that engine; a sample whose segment table overflowed went to the
frontier engine, which draws other permutations).  A sample that the
engine served but the reference finds too large for the table counts all
its contigs off.
"""

from __future__ import annotations

import numpy as np
import torch

from cnvbench import generator
from cnvbench.reference import cbs as plain

COMPARED = "contigs_off"
LIMIT = 0
PARTS = "contigs"           # what `off` counts
NOTHING_CHECKABLE = ("no timed sample was served by the whole-recursion "
                     "engine, so none could be checked")

make_pool = generator.make_pool
sample_bins = generator.sample_bins


def design(seed: int, size: int) -> np.ndarray:
    """Each pool position's index in the mix's design: the order in which
    make_pool hands out the designed samples for the seed."""
    return generator.rng_of(seed).permutation(size)


class System:
    """canvas_tpu_torch's CBS entry on one CUDA device, and its counters:
    the engine that served the call, its levels, its CUDA graph
    replays."""

    def __init__(self, device: torch.device, config: dict):
        from canvas_tpu_torch.ops import cbs, cbs_mega

        self.device, self.alpha = device, config["alpha"]
        self._cbs, self._mega = cbs, cbs_mega

    def __call__(self, sample: dict) -> tuple[dict | None, dict]:
        replays = self._mega.GRAPHS["replays"]
        out = self._cbs.run_cbs(sample, alpha=self.alpha, device=self.device)
        torch.cuda.synchronize(self.device)
        return out, {"engine": self._cbs.last_engine(),
                     "levels": self._cbs._LAST_ENGINE["levels"],
                     "replays": self._mega.GRAPHS["replays"] - replays}

    def release(self) -> None:
        """Free the engine's buffers and graph on the card."""
        self._mega._ENGINES.clear()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()


def checkable(record: dict) -> bool:
    """Whether a timed call's answer is one the reference models."""
    return record.get("engine") == "mega"


def reference(sample: dict, device: torch.device) -> dict | None:
    return plain.segment(sample, device)


def control(sample: dict, device: torch.device) -> dict | None:
    """The control: the reference with its values and cumulative sums held
    in bfloat16, the step below the engine's float32."""
    return plain.segment(sample, device, plain.CONTROL)


def f32_sums(sample: dict, device: torch.device) -> dict | None:
    """The reference with its sums accumulated in float32 (on a CUDA
    device), a precision the configuration does not hold the engine to."""
    return plain.segment(sample, device, plain.F32_SUMS)


VARIANTS = {"f32_sums": f32_sums}


def parts(sample: dict) -> int:
    return len(sample)


def off(got: dict | None, want: dict | None) -> int:
    """Contigs of one sample whose segment lengths differ."""
    if want is None or got is None:
        return len(want or got or {}) or 1
    names = set(want) | set(got)
    return sum(1 for c in names
               if c not in got or c not in want
               or not np.array_equal(np.asarray(got[c]),
                                     np.asarray(want[c])))
