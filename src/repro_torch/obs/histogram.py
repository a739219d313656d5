"""Mergeable log-bucketed latency histograms: a copy of
``repro.obs.histogram.LatencyHistogram``.  The batched lane's
``latency_hist`` cells and the DES record into it, the scenarios read
percentiles back, the per-window telemetry records carry it as JSON
(:meth:`LatencyHistogram.to_jsonable`, read back by ``flash_crowd``), and
the metrics registry keeps one per named series.

The bucket layout is fixed: each power-of-two octave ``[2^(e-1), 2^e)`` is
split into 16 linear sub-buckets.  For ``v > 0`` with ``m, e =
math.frexp(v)`` the global index is ``e * 16 + int((m - 0.5) * 32)``, so a
bucket's relative width is at most 1/16 and a percentile read back is
within 6.25 % of the true order statistic.  Counts may be fractional: the
fluid lane records one weighted entry per window.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = ["LatencyHistogram", "bucket_bounds", "bucket_index"]

_SUBBUCKETS = 16


def bucket_index(v: float) -> int:
    """Global bucket index of a positive value."""
    m, e = math.frexp(v)
    return e * _SUBBUCKETS + int((m - 0.5) * 32)


def bucket_bounds(idx: int) -> Tuple[float, float]:
    """``[lo, hi)`` covered by global bucket ``idx``."""
    e, s = divmod(idx, _SUBBUCKETS)
    return math.ldexp(1.0 + s / 16.0, e - 1), math.ldexp(1.0 + (s + 1) / 16.0, e - 1)


class LatencyHistogram:
    """Sparse log-bucketed histogram.  Equality compares ``n``, ``zero``,
    the bucket counts and the min/max marks (not the order-dependent
    ``total``)."""

    __slots__ = ("counts", "n", "zero", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts: Dict[int, float] = {}
        self.n = 0.0
        self.zero = 0.0  # values <= 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v: float) -> None:
        self.record_weighted(v, 1.0)

    def record_weighted(self, v: float, count: float) -> None:
        """Record ``count`` observations of ``v`` (``count`` may be a float)."""
        if count <= 0.0:
            return
        self.n += count
        self.total += v * count
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= 0.0:
            self.zero += count
            return
        idx = bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0.0) + count

    @classmethod
    def from_samples(cls, values: Iterable[float]) -> "LatencyHistogram":
        """Histogram of a sample vector (one numpy pass from 512 samples)."""
        h = cls()
        vals = values if isinstance(values, list) else list(values)
        if len(vals) < 512:
            for v in vals:
                h.record(float(v))
            return h
        arr = np.asarray(vals, dtype=float)
        pos = arr[arr > 0.0]
        m, e = np.frexp(pos)
        idx = e.astype(np.int64) * _SUBBUCKETS + ((m - 0.5) * 32).astype(np.int64)
        uniq, cnt = np.unique(idx, return_counts=True)
        h.counts = {int(i): float(c) for i, c in zip(uniq, cnt)}
        h.n = float(arr.size)
        h.zero = float(arr.size - pos.size)
        h.total = float(math.fsum(vals))
        h.vmin = float(arr.min())
        h.vmax = float(arr.max())
        return h

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Exact merge: a new histogram with per-bucket counts added."""
        out = LatencyHistogram()
        out.counts = dict(self.counts)
        for idx, c in other.counts.items():
            out.counts[idx] = out.counts.get(idx, 0.0) + c
        out.n = self.n + other.n
        out.zero = self.zero + other.zero
        out.total = self.total + other.total
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        return out

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Approximate order statistic at rank ``q * (n - 1)``: linear inside
        the bucket holding the rank, clamped to ``[vmin, vmax]``; NaN when
        empty."""
        if not self.n:
            return float("nan")
        r = min(max(q, 0.0), 1.0) * (self.n - 1.0)
        if r < self.zero:
            return min(0.0, self.vmin)
        cum = self.zero
        for idx in sorted(self.counts):
            c = self.counts[idx]
            if r < cum + c:
                lo, hi = bucket_bounds(idx)
                v = lo + (r - cum + 0.5) / c * (hi - lo)
                return min(max(v, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, LatencyHistogram):
            return NotImplemented
        empty = not self.n and not other.n
        return (self.n == other.n and self.zero == other.zero
                and self.counts == other.counts
                and (self.vmin == other.vmin or empty)
                and (self.vmax == other.vmax or empty))

    def __hash__(self) -> int:  # identity: equal histograms may differ in ``total``
        return id(self)

    def __repr__(self) -> str:
        if not self.n:
            return "LatencyHistogram(empty)"
        return (f"LatencyHistogram(n={self.n:g}, mean={self.mean():.1f}, "
                f"p50={self.percentile(0.5):.1f}, p99={self.percentile(0.99):.1f})")

    def to_jsonable(self) -> dict:
        return {
            "scheme": "log16",
            "n": self.n,
            "zero": self.zero,
            "total": self.total,
            "min": self.vmin if self.n else None,
            "max": self.vmax if self.n else None,
            "counts": {str(idx): c for idx, c in sorted(self.counts.items())},
        }

    @classmethod
    def from_jsonable(cls, blob: Optional[dict]) -> "LatencyHistogram":
        """The histogram :meth:`to_jsonable` wrote (empty for a falsy blob)."""
        h = cls()
        if not blob:
            return h
        h.counts = {int(k): float(v) for k, v in blob.get("counts", {}).items()}
        h.n = float(blob.get("n", 0.0))
        h.zero = float(blob.get("zero", 0.0))
        h.total = float(blob.get("total", 0.0))
        h.vmin = blob["min"] if blob.get("min") is not None else math.inf
        h.vmax = blob["max"] if blob.get("max") is not None else -math.inf
        return h


def merge_all(hists: Iterable[LatencyHistogram]) -> LatencyHistogram:
    """Fold :meth:`LatencyHistogram.merge` over an iterable."""
    out = LatencyHistogram()
    for h in hists:
        out = out.merge(h)
    return out
