"""Named process-wide counters (the part of ``repro.obs.metrics`` the
serving path uses)."""

from __future__ import annotations

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
