"""Little's-Law service-time estimation — MIKU's measurement half (§5.2, Eq. 1).

A copy of ``repro.core.littles_law`` (the port imports nothing from
``repro``), with :func:`merge_tier_counters`, the fold the merged-slow law
runs on, and :class:`TierWindow`, the per-tier window vector.  The shared
request-tracking structure the paper measures (the CHA's ToR) is, on the
serving path, the transfer queue's per-tier counters:

    T_avg = Occupancy / Inserts = alpha * T_fast + (1 - alpha) * T_slow   (Eq. 1)

With ``T_fast`` calibrated offline and ``alpha`` tracked from per-tier
insert counts, :class:`LittlesLawEstimator` solves Eq. 1 for ``T_slow`` and
flags a backlog when it exceeds a read/write-mix-adjusted threshold.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional, Sequence, Tuple


class OpClass(enum.Enum):
    """Memory instruction classes (paper §3, §5.2): pure reads, ordinary
    stores (read-modify-write), non-temporal stores (write-only) and
    page-migration copies (a read plus a write)."""

    LOAD = "load"
    STORE = "store"
    NT_STORE = "nt_store"
    MIGRATE = "migrate"


#: The application-issued instruction classes (what bw-tests and workload op
#: grids enumerate).  MIGRATE is engine-generated background traffic, never a
#: demand-workload op.
DEMAND_CLASSES = (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE)

#: Device-level (reads, writes) generated per retired request of each class.
ACCESS_MIX: Dict[OpClass, tuple] = {
    OpClass.LOAD: (1, 0),
    OpClass.STORE: (1, 1),
    OpClass.NT_STORE: (0, 1),
    OpClass.MIGRATE: (1, 1),
}


@dataclasses.dataclass
class TierCounters:
    """Cumulative counters for one memory tier, mirroring the uncore events:
    ``occupancy_time`` integrates entries-in-flight x dt, ``inserts`` counts
    completed insertions, ``class_counts`` drive the read/write mix."""

    inserts: int = 0
    occupancy_time: float = 0.0
    class_counts: Dict[OpClass, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in OpClass}
    )

    def record(self, op: OpClass, residency: float) -> None:
        """Record one request that held a shared-queue entry for ``residency``."""
        self.inserts += 1
        self.occupancy_time += residency
        self.class_counts[op] += 1

    def merge(self, other: "TierCounters") -> None:
        """Accumulate ``other``'s counts into this counter, in place."""
        self.inserts += other.inserts
        self.occupancy_time += other.occupancy_time
        for c in OpClass:
            self.class_counts[c] = (self.class_counts.get(c, 0)
                                    + other.class_counts.get(c, 0))

    def snapshot(self) -> "TierCounters":
        """An independent copy, for later :meth:`delta` marks."""
        return TierCounters(
            inserts=self.inserts,
            occupancy_time=self.occupancy_time,
            class_counts=dict(self.class_counts),
        )

    def delta(self, since: "TierCounters") -> "TierCounters":
        """Counters accumulated since an earlier snapshot (window counters)."""
        return TierCounters(
            inserts=self.inserts - since.inserts,
            occupancy_time=self.occupancy_time - since.occupancy_time,
            class_counts={
                c: self.class_counts.get(c, 0) - since.class_counts.get(c, 0)
                for c in OpClass
            },
        )

    @property
    def mean_service_time(self) -> float:
        if self.inserts == 0:
            return 0.0
        return self.occupancy_time / self.inserts

    def read_write_fractions(self) -> tuple:
        """(read_fraction, write_fraction) of device-level accesses."""
        reads = writes = 0
        for c, n in self.class_counts.items():
            r, w = ACCESS_MIX[c]
            reads += r * n
            writes += w * n
        total = reads + writes
        if total == 0:
            return (1.0, 0.0)
        return (reads / total, writes / total)


def merge_tier_counters(counters: "Sequence[TierCounters]") -> "TierCounters":
    """Fold several per-tier window deltas into one merged delta (plain
    sums, so the merged-slow window is recovered exactly from a per-tier
    vector: :class:`~repro_torch.core.controller.MergedSlowPolicy`)."""
    out = TierCounters()
    for tc in counters:
        out.merge(tc)
    return out


class TierWindow(tuple):
    """One window's ordered per-tier counter deltas (fast tier first), with
    the tier names carried alongside in :attr:`names`."""

    def __new__(
        cls,
        counters: "Sequence[TierCounters]",
        names: Optional["Sequence[str]"] = None,
    ) -> "TierWindow":
        self = super().__new__(cls, tuple(counters))
        if names is None:
            names = tuple(f"tier{i}" for i in range(len(self)))
        names = tuple(names)
        if len(names) != len(self):
            raise ValueError(
                f"TierWindow got {len(self)} counter(s) but "
                f"{len(names)} name(s)"
            )
        self._names = names
        return self

    def __reduce__(self):
        # Pickles (into a spawn worker) with its names, which a plain
        # tuple's reduce would drop.
        return (TierWindow, (tuple(self), self._names))

    @property
    def names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def fast(self) -> TierCounters:
        return self[0]

    @property
    def slow_names(self) -> Tuple[str, ...]:
        return self._names[1:]

    def merged_slow(self) -> TierCounters:
        """Tiers 1..n-1 folded into one delta: the merged slow window."""
        return merge_tier_counters(self[1:])

    @classmethod
    def zero(cls, names: "Sequence[str]") -> "TierWindow":
        """The identity window: one empty TierCounters per named tier."""
        return cls(tuple(TierCounters() for _ in names), tuple(names))

    def merge(self, other: "TierWindow") -> "TierWindow":
        """Element-wise fold of two windows over the same tier set (a name
        mismatch raises ``ValueError``); merging with :meth:`zero` is the
        identity."""
        if self.names != other.names:
            raise ValueError(
                f"cannot merge TierWindows over different tier sets: "
                f"{self.names} vs {other.names}"
            )
        return TierWindow(
            tuple(merge_tier_counters((a, b)) for a, b in zip(self, other)),
            self.names,
        )


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Calibration for the estimator (paper §5.2, measured offline).

    ``t_fast`` is the loaded fast-tier service time; the slow-tier backlog
    threshold is for pure reads, writes use ``write_threshold_scale`` x it.
    Above ``alpha_calm`` (almost no slow traffic) Eq. 1 is ill-conditioned
    and the slow tier's direct windowed residency is used instead.
    """

    t_fast: float
    slow_read_threshold: float
    write_threshold_scale: float = 2.0
    ewma: float = 0.5
    min_window_inserts: int = 16
    min_slow_inserts: int = 4
    alpha_calm: float = 0.97
    t_fast_class_scale: Optional[Dict["OpClass", float]] = None


@dataclasses.dataclass
class TierEstimate:
    """One estimation window's output."""

    t_avg: float
    alpha: float
    t_slow: float
    t_slow_raw: float
    threshold: float
    backlogged: bool
    valid: bool


class LittlesLawEstimator:
    """Decompose shared-queue occupancy into per-tier service times (Eq. 1).

    It never throttles anything itself — that is
    :class:`repro_torch.core.controller.MikuController`'s job.
    """

    def __init__(self, config: EstimatorConfig):
        self.config = config
        self._t_slow_ewma: Optional[float] = None
        self.history: list = []

    def reset(self) -> None:
        """Forget the EWMA state and the estimate history."""
        self._t_slow_ewma = None
        self.history.clear()

    def threshold_for_mix(self, slow_window: TierCounters) -> float:
        """The backlog threshold weighted by the window's read/write mix:
        loads -> thr, nt-stores -> 2*thr, stores -> 1.5*thr."""
        rf, wf = slow_window.read_write_fractions()
        scale = rf * 1.0 + wf * self.config.write_threshold_scale
        return self.config.slow_read_threshold * scale

    def t_fast_for_mix(self, fast_window: TierCounters) -> float:
        """t_fast adjusted for the fast window's instruction-class mix."""
        scales = self.config.t_fast_class_scale
        if not scales or fast_window.inserts == 0:
            return self.config.t_fast
        total = num = 0
        for c, n in fast_window.class_counts.items():
            num += n * scales.get(c, 1.0)
            total += n
        return self.config.t_fast * (num / max(total, 1))

    def update(
        self, fast_window: TierCounters, slow_window: TierCounters
    ) -> TierEstimate:
        """Solve Eq. 1 for one window's ``(fast, slow)`` deltas."""
        cfg = self.config
        total_inserts = fast_window.inserts + slow_window.inserts
        total_occ = fast_window.occupancy_time + slow_window.occupancy_time
        threshold = self.threshold_for_mix(slow_window)

        if (
            total_inserts < cfg.min_window_inserts
            or slow_window.inserts < cfg.min_slow_inserts
        ):
            # Too little slow-tier traffic to estimate: decay towards "no
            # backlog" so a quiet tier is eventually unthrottled.
            est = TierEstimate(
                t_avg=total_occ / total_inserts if total_inserts else 0.0,
                alpha=1.0 if slow_window.inserts == 0 else 0.0,
                t_slow=self._t_slow_ewma or 0.0,
                t_slow_raw=0.0,
                threshold=threshold,
                backlogged=False,
                valid=False,
            )
            self.history.append(est)
            return est

        t_avg = total_occ / total_inserts
        alpha = fast_window.inserts / total_inserts
        if alpha > cfg.alpha_calm:
            t_slow_raw = slow_window.mean_service_time
        else:
            t_slow_raw = (t_avg - alpha * self.t_fast_for_mix(fast_window)) / (
                1.0 - alpha
            )
        # A negative service time is measurement noise, not information.
        t_slow_raw = max(t_slow_raw, 0.0)

        if self._t_slow_ewma is None:
            self._t_slow_ewma = t_slow_raw
        else:
            a = cfg.ewma
            self._t_slow_ewma = a * t_slow_raw + (1.0 - a) * self._t_slow_ewma

        est = TierEstimate(
            t_avg=t_avg,
            alpha=alpha,
            t_slow=self._t_slow_ewma,
            t_slow_raw=t_slow_raw,
            threshold=threshold,
            backlogged=self._t_slow_ewma > threshold,
            valid=True,
        )
        self.history.append(est)
        return est

    def growth_rate(self, n: int = 3) -> float:
        """Geometric growth of the last ``n`` steps of valid raw estimates
        (the paper triggers on a threshold crossing that keeps growing
        exponentially): about 1.0 when flat, above 1 when growing."""
        valid = [h.t_slow_raw for h in self.history if h.valid and h.t_slow_raw > 0]
        if len(valid) < n + 1:
            return 1.0
        window = valid[-(n + 1):]
        ratios = [b / a for a, b in zip(window, window[1:]) if a > 0]
        if not ratios:
            return 1.0
        return math.exp(sum(math.log(max(r, 1e-9)) for r in ratios) / len(ratios))


def linear_percentile(sorted_xs: Sequence[float], q: float) -> float:
    """Order statistic with linear interpolation (numpy's default rule):
    rank ``q * (n - 1)`` of the ascending ``sorted_xs``, interpolated
    between the two bracketing order statistics; 0.0 when empty."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    r = min(max(q, 0.0), 1.0) * (n - 1)
    lo = int(r)
    if lo >= n - 1:
        return float(sorted_xs[-1])
    frac = r - lo
    a = float(sorted_xs[lo])
    return a + (float(sorted_xs[lo + 1]) - a) * frac
