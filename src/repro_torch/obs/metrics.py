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

The serving engine and cluster record real-clock spans into the
process-default profiler (:func:`default_profiler`), which also keeps a
bounded log of every span (:class:`SpanRecord`): its name, its ends on
``time.perf_counter``, its id and its parent's.  While ``torch.profiler``
records, each span is also a profiler range of the same name whose argument
is the span id, so the device trace's clock and the log join.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs.histogram import LatencyHistogram

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "PhaseProfiler",
    "SpanRecord",
    "default_profiler",
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


class SpanRecord(NamedTuple):
    """One logged phase call: ``t0``/``t1`` on the profiler's clock, ``sid``
    its id (from 1), ``parent`` the id of the span open around it (0: none)
    and small ``args``."""

    name: str
    t0: float
    t1: float
    sid: int
    parent: int
    args: Dict[str, Any]


class _Phase:
    """One call of a phase; entered, it is what ``with ... as`` binds, so
    the body can add to :attr:`args` and read :attr:`t0`."""

    __slots__ = ("prof", "name", "args", "t0", "sid", "parent", "_range")

    def __init__(self, prof: "PhaseProfiler", name: str, args: Dict[str, Any]) -> None:
        self.prof = prof
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.sid = 0

    def __enter__(self) -> "_Phase":
        p = self.prof
        self._range = None
        if p.log is not None:
            self.sid = sid = next(p._ids)
            self.parent = p._open[-1] if p._open else 0
            p._open.append(sid)
            if getattr(_autograd_profiler, "_is_profiler_enabled", False):
                self._range = torch.autograd._record_function_with_args_enter(self.name, sid)
        self.t0 = p.clock()
        return self

    def __exit__(self, *exc) -> None:
        p = self.prof
        t0 = self.t0
        t1 = p.clock()
        p.add(self.name, t1 - t0)
        if self.sid:
            p._open.pop()
            if self._range is not None:
                torch.autograd._record_function_with_args_exit(self._range)
            p._append(SpanRecord(self.name, t0, t1, self.sid, self.parent, self.args))


class PhaseProfiler:
    """Wall-clock phase accounting for a simulation (``SimJob.profile``)
    and for the serving path (:func:`default_profiler`).

    Phases are additive: ``add("window_pass", dt)`` accumulates across
    windows, and ``window_pass`` time is a subset of ``event_loop`` time.
    An unprofiled simulation makes no clock reads at all.

    With ``log_size`` the profiler also logs each call of :meth:`phase` and
    :meth:`record` as a :class:`SpanRecord`, the newest ``log_size`` of
    them; :attr:`dropped` counts the records pushed out and
    :attr:`dropped_until` is the latest end among them.  Without a log
    (``log`` None, the default) it keeps only the sums.
    """

    __slots__ = ("seconds", "calls", "clock", "log", "dropped", "dropped_until",
                 "_ids", "_open")

    def __init__(self, log_size: int = 0) -> None:
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.clock = time.perf_counter
        self.log: Optional[Deque[SpanRecord]] = deque(maxlen=log_size) if log_size else None
        self.dropped = 0
        self.dropped_until = -math.inf
        self._ids = itertools.count(1)
        self._open: List[int] = []

    def add(self, phase: str, dt: float) -> None:
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        self.calls[phase] = self.calls.get(phase, 0) + 1

    def phase(self, name: str, **args: Any) -> _Phase:
        """Time the ``with`` body as one call of phase ``name``; logged with
        ``args`` as a child of the span open around it."""
        return _Phase(self, name, args)

    def record(self, name: str, t0: float, t1: float, **args: Any) -> None:
        """One call of phase ``name`` that did not run as a ``with`` body:
        from ``t0`` to ``t1``, read from :attr:`clock`.  Logged as a
        top-level span, with no profiler range."""
        self.add(name, t1 - t0)
        if self.log is not None:
            self._append(SpanRecord(name, t0, t1, next(self._ids), 0, args))

    def _append(self, rec: SpanRecord) -> None:
        log = self.log
        if len(log) == log.maxlen:
            self.dropped += 1
            self.dropped_until = max(self.dropped_until, log[0].t1)
        log.append(rec)

    def spans(self, t0: float, t1: float) -> Optional[List[SpanRecord]]:
        """The logged spans that start in ``[t0, t1]``, oldest first; None
        without a log or when a record that ended at or after ``t0`` was
        dropped."""
        if self.log is None or self.dropped_until >= t0:
            return None
        return sorted((r for r in self.log if t0 <= r.t0 <= t1), key=lambda r: r.sid)

    def snapshot(self) -> dict:
        return {
            "phases": {
                k: {"seconds": round(v, 6), "calls": self.calls.get(k, 0)}
                for k, v in sorted(self.seconds.items())
            }
        }


#: Records the process-default profiler keeps: a 51 s serving window logs
#: about 20 spans a tick at 3-5 ticks a second, a few thousand in all.
LOG_SIZE = 65_536

_DEFAULT_PROFILER = PhaseProfiler(log_size=LOG_SIZE)


def default_profiler() -> PhaseProfiler:
    """The process-wide profiler the serving path records its spans into."""
    return _DEFAULT_PROFILER
