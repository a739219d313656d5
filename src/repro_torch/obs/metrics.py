"""Named process-wide counters and the DES's wall-clock phase profiler
(the parts of ``repro.obs.metrics`` the serving path and the scalar lane
use)."""

from __future__ import annotations

import time
from typing import Dict


class Counter:
    """Monotonic named counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class MetricsRegistry:
    """Accessor-on-first-use registry of named counters."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c


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

    def snapshot(self) -> dict:
        return {
            "phases": {
                k: {"seconds": round(v, 6), "calls": self.calls.get(k, 0)}
                for k, v in sorted(self.seconds.items())
            }
        }
