"""Arithmetic over all of a run's samples: percentiles, rates and the
per-second timeline."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value (numpy's linear rule); NaN when
    there are none."""
    if len(values) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: float, seconds: float) -> float:
    return count / seconds


def timeline(segments: Sequence[Tuple[float, float]], width: float = 1.0
             ) -> List[float]:
    """Frames a ``width``-second bin from (end time in seconds from the
    start, frames) segments, each segment's frames spread evenly over its
    own span: the rate, bin by bin, that the bands show in."""
    if not segments:
        return []
    n_bins = int(np.ceil(segments[-1][0] / width))
    bins = np.zeros(max(n_bins, 1))
    start = 0.0
    for end, frames in segments:
        span = max(end - start, 1e-12)
        for b in range(int(start // width), int(np.ceil(end / width))):
            lo, hi = max(start, b * width), min(end, (b + 1) * width)
            if hi > lo and b < len(bins):
                bins[b] += frames * (hi - lo) / span
        start = end
    return [float(x) / width for x in bins]
