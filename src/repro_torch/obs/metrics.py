"""Named process-wide metrics and the wall-clock phase profiler (a copy of
``repro.obs.metrics``).

Components (the DES, the transfer queue, the control loop, the sweep)
register counters, gauges and histograms against the process-default
registry; ``run_scenario(..., profile=True)`` snapshots it into
``ResultTable.meta["metrics"]``.  Registries are per process: the workers
of a scalar-lane pool keep their own, so pool-run metrics show only the
parent's.  :class:`PhaseProfiler` is the one clock reader of the
simulation code: the DES and the planner call ``profiler.clock()`` and
``profiler.add()``, and an unprofiled run reads no clock.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator

from repro_torch.obs.histogram import LatencyHistogram

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "PhaseProfiler",
    "default_registry",
]


class Counter:
    """Monotonic named counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value:g})"


class Gauge:
    """Last-write-wins named gauge."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value:g})"


class MetricsRegistry:
    """Accessor-on-first-use registry of named metrics."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, LatencyHistogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> LatencyHistogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = LatencyHistogram()
        return h

    def snapshot(self) -> dict:
        """JSON-able view: counters and gauges as they are, each histogram
        as its count, mean and p50/p95/p99."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: {
                    "n": h.n,
                    "mean": h.mean(),
                    "p50": h.percentile(0.5),
                    "p95": h.percentile(0.95),
                    "p99": h.percentile(0.99),
                }
                for k, h in sorted(self._histograms.items())
            },
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry components register against."""
    return _DEFAULT


class PhaseProfiler:
    """Wall-clock phase accounting for a simulation (``SimJob.profile``).

    Phases are additive: ``add("window_pass", dt)`` accumulates across
    windows, and ``window_pass`` time is a subset of ``event_loop`` time.
    An unprofiled simulation makes no clock reads at all.
    """

    __slots__ = ("seconds", "calls", "clock")

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.clock = time.perf_counter

    def add(self, phase: str, dt: float) -> None:
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        self.calls[phase] = self.calls.get(phase, 0) + 1

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time the ``with`` body as one call of phase ``name``."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.add(name, self.clock() - t0)

    def snapshot(self) -> dict:
        return {
            "phases": {
                k: {"seconds": round(v, 6), "calls": self.calls.get(k, 0)}
                for k, v in sorted(self.seconds.items())
            }
        }
