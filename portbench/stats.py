"""Order statistics over all samples of a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linear between the two
    nearest ranks (numpy's default); raises on no values."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def overlap(t0: float, t1: float, w0: float, w1: float) -> float:
    """Length of [t0, t1] inside [w0, w1]."""
    return max(0.0, min(t1, w1) - max(t0, w0))
