"""Control-plane substrate: windowed counters and the feedback loop (a copy
of ``repro.core.substrate``).

A substrate (:class:`MemorySubstrate`) exposes ``clock_ns``,
``counters_delta()`` (a per-tier
:class:`~repro_torch.core.littles_law.TierWindow`, consumed on read) and
``apply(decision)``; :class:`ControlLoop` owns *when*: window scheduling,
feeding deltas to the decision law and recording its decisions.
:class:`WindowRecord` and :func:`window_record_jsonable` define the
per-window telemetry schema (the batched lane's ``record_windows``
records are in it).  :class:`StepTimingSubstrate` is the trainer's:
per-host step times for the straggler governor.  :class:`ReplaySubstrate`
replays a recorded counter trace, so any loop and law can be held to a
live system's decision sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Protocol, Sequence, Tuple

from repro_torch.core.littles_law import TierCounters, TierWindow
from repro_torch.obs.metrics import default_registry


class MemorySubstrate(Protocol):
    """Anything the control loop can instrument and throttle."""

    @property
    def clock_ns(self) -> float:
        """The substrate's current time in nanoseconds."""
        ...

    def counters_delta(self) -> Tuple[Any, ...]:
        """Counters accumulated since the last call (consumed on read):
        canonically a :class:`TierWindow`, fast tier first."""
        ...

    def apply(self, decision: Any) -> None:
        """Apply one window's decision to the substrate."""
        ...


class WindowedCounters:
    """A (fast, slow) pair of cumulative TierCounters with consume-on-read
    window deltas."""

    __slots__ = ("fast", "slow", "_fast_mark", "_slow_mark")

    def __init__(self) -> None:
        self.fast = TierCounters()
        self.slow = TierCounters()
        self._fast_mark = self.fast.snapshot()
        self._slow_mark = self.slow.snapshot()

    def delta(self) -> Tuple[TierCounters, TierCounters]:
        """(fast, slow) accumulated since the previous ``delta()`` call."""
        df = self.fast.delta(self._fast_mark)
        ds = self.slow.delta(self._slow_mark)
        self._fast_mark = self.fast.snapshot()
        self._slow_mark = self.slow.snapshot()
        return df, ds

    def reset(self) -> None:
        self.fast = TierCounters()
        self.slow = TierCounters()
        self._fast_mark = self.fast.snapshot()
        self._slow_mark = self.slow.snapshot()


class TierSetWindowedCounters:
    """One cumulative :class:`TierCounters` per tier (fast first);
    ``delta()`` returns the window's :class:`TierWindow`.  An attached
    sanitizer hook sees every window's ``(names, deltas)`` first."""

    __slots__ = ("tiers", "names", "_marks", "_sanitizer")

    def __init__(self, names: Sequence[str]) -> None:
        self.names = tuple(names)
        self.tiers = [TierCounters() for _ in self.names]
        self._marks = [t.snapshot() for t in self.tiers]
        self._sanitizer: Optional[Callable[..., None]] = None

    def delta(self) -> TierWindow:
        """Per-tier deltas accumulated since the previous call."""
        ds = [t.delta(m) for t, m in zip(self.tiers, self._marks)]
        self._marks = [t.snapshot() for t in self.tiers]
        if self._sanitizer is not None:
            self._sanitizer(self.names, ds)
        return TierWindow(ds, self.names)

    def attach_sanitizer(self, hook: Callable[..., None]) -> None:
        """Install the delta hook, ``hook(names, deltas)``: the sanitizers'
        ``check_counter_deltas`` (non-negative window deltas)."""
        self._sanitizer = hook

    def reset(self) -> None:
        self.tiers = [TierCounters() for _ in self.tiers]
        self._marks = [t.snapshot() for t in self.tiers]


@dataclasses.dataclass
class WindowRecord:
    """Telemetry for one control window."""

    index: int
    t_ns: float
    delta: Tuple[Any, ...]
    decision: Any


def _counters_jsonable(tc: TierCounters) -> dict:
    return {
        "inserts": tc.inserts,
        "occupancy_time": tc.occupancy_time,
        "class_counts": {c.value: n for c, n in tc.class_counts.items()},
    }


def _decision_jsonable(d: Any) -> Any:
    """One tier's decision as plain JSON (best effort for foreign laws)."""
    est = getattr(d, "estimate", None)
    out = {
        "max_concurrency": getattr(d, "max_concurrency", None),
        "rate_factor": getattr(d, "rate_factor", None),
        "phase": getattr(getattr(d, "phase", None), "value", None),
    }
    if est is not None:
        out["t_slow"] = est.t_slow
        out["t_slow_raw"] = est.t_slow_raw
        out["threshold"] = est.threshold
        out["backlogged"] = est.backlogged
        out["valid"] = est.valid
    return out


def window_record_jsonable(rec: WindowRecord) -> dict:
    """One :class:`WindowRecord` as a plain JSON-safe dict: the window's
    per-tier counter deltas (named when the delta is a TierWindow) and its
    per-tier decision(s)."""
    out: dict = {"window": rec.index, "t_ns": rec.t_ns}
    delta = rec.delta
    if isinstance(delta, TierWindow):
        out["tiers"] = {name: _counters_jsonable(tc)
                        for name, tc in zip(delta.names, delta)}
    elif isinstance(delta, tuple) and all(isinstance(tc, TierCounters) for tc in delta):
        out["tiers"] = {f"tier{i}": _counters_jsonable(tc) for i, tc in enumerate(delta)}
    else:
        out["delta"] = repr(delta)
    d = rec.decision
    if hasattr(d, "items") and hasattr(d, "tiers"):  # TierDecisions
        out["decision"] = {t: _decision_jsonable(td) for t, td in d.items()}
    elif d is not None:
        out["decision"] = _decision_jsonable(d)
    return out


class ControlLoop:
    """Drives a decision law over a substrate's windows.

    Event-driven hosts call :meth:`fire` exactly when a window elapses (the
    DES schedules :attr:`next_window_ns` as an event; the transfer queue
    interleaves boundaries with transfer completions in time order; the
    trainer fires once a step); hosts that move their clock in large steps
    call :meth:`poll`, which fires every boundary passed.  A
    :class:`TierWindow` delta goes to the law whole, a plain tuple splatted
    (the straggler governor's ``(step_times,)``).  ``controller=None``
    keeps the window cadence but makes no decisions.  ``record`` keeps a
    :class:`WindowRecord` of each decided window in :attr:`records`, and
    ``on_window`` is called with it; ``max_history`` caps the decisions and
    records kept (a trainer fires one window a step, forever).
    """

    def __init__(
        self,
        substrate: MemorySubstrate,
        controller: Optional[Any] = None,
        *,
        window_ns: float = 1_000_000.0,
        record: bool = True,
        max_history: Optional[int] = None,
        on_window: Optional[Callable[[WindowRecord], None]] = None,
    ) -> None:
        self.substrate = substrate
        self.controller = controller
        self.window_ns = float(window_ns)
        self.next_window_ns = float(window_ns)
        self.decisions: List[Any] = []
        self.records: List[WindowRecord] = []
        self._windows_run = 0
        self._record = record
        self._max_history = max_history
        self._on_window = on_window
        reg = default_registry()
        self._m_windows = reg.counter("control.windows")
        self._m_decisions = reg.counter("control.decisions")

    def due(self, now: Optional[float] = None) -> bool:
        now = self.substrate.clock_ns if now is None else now
        return now >= self.next_window_ns

    def fire(self) -> Optional[Any]:
        """Run one window now and advance the schedule by ``window_ns``."""
        self.next_window_ns += self.window_ns
        self._m_windows.inc()
        if self.controller is None:
            return None
        delta = self.substrate.counters_delta()
        decision = (self.controller.window(delta) if isinstance(delta, TierWindow)
                    else self.controller.window(*delta))
        self.decisions.append(decision)
        self._m_decisions.inc()
        self._windows_run += 1
        if self._record or self._on_window is not None:
            rec = WindowRecord(index=self._windows_run, t_ns=self.substrate.clock_ns,
                               delta=delta, decision=decision)
            if self._record:
                self.records.append(rec)
            if self._on_window is not None:
                self._on_window(rec)
        m = self._max_history
        if m is not None:
            if len(self.decisions) > 2 * m:
                del self.decisions[:-m]
            if len(self.records) > 2 * m:
                del self.records[:-m]
        self.substrate.apply(decision)
        return decision

    def poll(self, now: Optional[float] = None) -> List[Any]:
        """Fire every window boundary the clock has passed (in order)."""
        now = self.substrate.clock_ns if now is None else now
        fired: List[Any] = []
        while now >= self.next_window_ns:
            fired.append(self.fire())
        return fired

    @property
    def windows_run(self) -> int:
        return self._windows_run

    def reset(self) -> None:
        """Back to the first window: the schedule, the history and the
        controller's state (when it has a ``reset``)."""
        self.next_window_ns = self.window_ns
        self.decisions.clear()
        self.records.clear()
        self._windows_run = 0
        if self.controller is not None and hasattr(self.controller, "reset"):
            self.controller.reset()

    def telemetry(self) -> dict:
        """Summary counters for reports."""
        restricted = sum(
            1 for d in self.decisions if getattr(d, "restricted", False)
        )
        return {
            "windows": len(self.decisions),
            "restricted_windows": restricted,
            "window_ns": self.window_ns,
        }


class ReplaySubstrate:
    """A substrate that replays a recorded counter trace: the harness that
    holds a ControlLoop and decision law to a live system's decision
    sequence.  Each window consumes the next recorded delta; ``apply``
    keeps every decision in :attr:`applied`."""

    def __init__(
        self,
        deltas: Sequence[Tuple[Any, ...]],
        *,
        window_ns: float = 1.0,
    ) -> None:
        self._deltas = list(deltas)
        self._i = 0
        self.window_ns = window_ns
        self.applied: List[Any] = []

    @property
    def clock_ns(self) -> float:
        return self._i * self.window_ns

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._deltas)

    def counters_delta(self) -> Tuple[Any, ...]:
        delta = self._deltas[self._i]
        self._i += 1
        return delta

    def apply(self, decision: Any) -> None:
        self.applied.append(decision)


class StepTimingSubstrate:
    """Per-host step-service-time substrate for the straggler governor.

    The trainer records each host's step wall time; every window the control
    loop hands the governor one mean step time per host (0.0 for a host that
    missed the window entirely, the governor's worst signal) and applies the
    returned :class:`~repro_torch.core.controller.HostHealth` list as
    per-host dispatch rate factors.
    """

    def __init__(self, n_hosts: int) -> None:
        self.n_hosts = n_hosts
        self._sums = [0.0] * n_hosts
        self._counts = [0] * n_hosts
        self._clock_ns = 0.0
        self.health: List[Any] = []

    @property
    def clock_ns(self) -> float:
        return self._clock_ns

    def record_step(self, host: int, seconds: float) -> None:
        self._sums[host] += seconds
        self._counts[host] += 1
        self._clock_ns += seconds * 1e9

    def counters_delta(self) -> Tuple[List[float], ...]:
        times = [self._sums[h] / self._counts[h] if self._counts[h] else 0.0
                 for h in range(self.n_hosts)]
        self._sums = [0.0] * self.n_hosts
        self._counts = [0] * self.n_hosts
        return (times,)

    def apply(self, healths: List[Any]) -> None:
        self.health = healths

    def rate_factor(self, host: int) -> float:
        if not self.health:
            return 1.0
        return self.health[host].rate_factor
