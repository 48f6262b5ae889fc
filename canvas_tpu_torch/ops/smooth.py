"""CanvasSmooth — repeated median filter on bin counts.

The reference applies a rolling median with half-windows 1..K per
chromosome until convergence or K iterations (CanvasSmooth.cs:23-80 with
Utilities.MedianFilter); used by the enrichment wrapper ahead of CanvasClean.
"""

from __future__ import annotations

import numpy as np

from canvas_tpu_torch.io.bins import BinSet
from canvas_tpu_torch.ops import stats

DEFAULT_MAX_HALF_WINDOW = 5  # CanvasSmooth default -h


def repeated_median_smooth(values: np.ndarray,
                           max_half_window: int = DEFAULT_MAX_HALF_WINDOW
                           ) -> np.ndarray:
    """RepeatedMedianSmoother: median filter with half-window 1, 2, .. K,
    stopping early when a pass changes nothing."""
    out = np.asarray(values, dtype=np.float64).copy()
    for half in range(1, max_half_window + 1):
        new = stats.median_filter(out, half)
        if np.array_equal(new, out):
            break
        out = new
    return out


def smooth(bins: BinSet,
           max_half_window: int = DEFAULT_MAX_HALF_WINDOW) -> BinSet:
    """Per-chromosome smoothing of a BinSet (CanvasSmooth.Run)."""
    counts = bins.count.astype(np.float64).copy()
    for name, sl in bins.contig_slices().items():
        counts[sl] = repeated_median_smooth(counts[sl], max_half_window)
    return bins.with_count(counts.astype(np.float32))
