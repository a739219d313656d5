"""Control-plane substrate: windowed counters and the feedback loop.

A copy of what the serving path uses from ``repro.core.substrate``.  A
substrate exposes ``clock_ns``, ``counters_delta()`` (a per-tier
:class:`~repro_torch.core.littles_law.TierWindow`, consumed on read) and
``apply(decision)``; :class:`ControlLoop` owns *when*: window scheduling,
feeding deltas to the decision law and recording its decisions.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.core.littles_law import TierCounters, TierWindow
from repro_torch.obs.metrics import default_registry


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


class TierSetWindowedCounters:
    """One cumulative :class:`TierCounters` per tier (fast first);
    ``delta()`` returns the window's :class:`TierWindow`."""

    __slots__ = ("tiers", "names", "_marks")

    def __init__(self, names: Sequence[str]) -> None:
        self.names = tuple(names)
        self.tiers = [TierCounters() for _ in self.names]
        self._marks = [t.snapshot() for t in self.tiers]

    def delta(self) -> TierWindow:
        """Per-tier deltas accumulated since the previous call."""
        ds = [t.delta(m) for t, m in zip(self.tiers, self._marks)]
        self._marks = [t.snapshot() for t in self.tiers]
        return TierWindow(ds, self.names)


class ControlLoop:
    """Drives a decision law over a substrate's windows.

    The host calls :meth:`fire` exactly when a window elapses (the transfer
    queue interleaves boundaries with transfer completions in time order).
    ``controller=None`` keeps the window cadence but makes no decisions.
    """

    def __init__(
        self,
        substrate: Any,
        controller: Optional[Any] = None,
        *,
        window_ns: float = 1_000_000.0,
    ) -> None:
        self.substrate = substrate
        self.controller = controller
        self.window_ns = float(window_ns)
        self.next_window_ns = float(window_ns)
        self.decisions: List[Any] = []
        reg = default_registry()
        self._m_windows = reg.counter("control.windows")
        self._m_decisions = reg.counter("control.decisions")

    def fire(self) -> Optional[Any]:
        """Run one window now and advance the schedule by ``window_ns``."""
        self.next_window_ns += self.window_ns
        self._m_windows.inc()
        if self.controller is None:
            return None
        decision = self.controller.window(self.substrate.counters_delta())
        self.decisions.append(decision)
        self._m_decisions.inc()
        self.substrate.apply(decision)
        return decision

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
