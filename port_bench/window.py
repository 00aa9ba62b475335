"""Arithmetic of the measured window: a rate over whole iterations and a
percentile over every iteration's wall time."""
from __future__ import annotations

import math
from typing import Sequence


def rate(work_per_iter: float, iterations: int, seconds: float) -> float:
    """Work completed per second: `iterations` whole iterations of
    `work_per_iter` each over the window's `seconds` of wall time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work_per_iter * iterations / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value: the
    smallest value that at least q% of them do not exceed."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]
