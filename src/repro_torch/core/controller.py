"""MIKU — Dynamic Memory Request Control (paper §5.2), per slow tier.

A copy of the MIKU path of ``repro.core.controller``: one Little's-Law
estimator, throttle ladder and work-conserving promotion state per slow
tier (:class:`SlowTierMiku`), run as an ensemble by :class:`MikuController`
over per-tier windows (:class:`~repro_torch.core.littles_law.TierWindow`,
fast tier first) and answering with tier-addressed :class:`TierDecisions`.

Per slow tier: a backlog (smoothed ``T_slow`` above its mix-adjusted
threshold) demotes the tier's traffic to the most restrictive concurrency
level; if it persists there the request rate backs off; calm windows promote
one level at a time up to the instruction-class cap, and an idle fast tier
releases every restriction.  The serving path applies a decision as the
host link's in-flight cap and byte-rate.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.littles_law import (
    EstimatorConfig,
    LittlesLawEstimator,
    OpClass,
    TierCounters,
    TierEstimate,
)


class Phase(enum.Enum):
    UNRESTRICTED = "unrestricted"
    RESTRICTED = "restricted"


@dataclasses.dataclass(frozen=True)
class MikuConfig:
    """Controller calibration (paper §5.2 "Effective CXL request throttling")."""

    #: Ascending concurrency ladder; levels[0] is the paper's "level-3".
    levels: Sequence[int] = (1, 2, 4, 8, 16)
    #: Per-instruction-class backlog-free concurrency caps (paper: 8/4/1).
    class_caps: Dict[OpClass, int] = dataclasses.field(
        default_factory=lambda: {
            OpClass.LOAD: 8,
            OpClass.STORE: 4,
            OpClass.NT_STORE: 1,
            OpClass.MIGRATE: 2,
        }
    )
    #: Multiplicative rate steps below the most restrictive level.
    min_rate: float = 0.1
    rate_backoff: float = 0.5
    rate_recover: float = 2.0
    #: Consecutive calm windows required before a promotion.
    promote_patience: int = 1
    #: Promote only while t_slow < margin * threshold (hysteresis band).
    target_margin: float = 0.85
    #: A restricted backlog that shrank by this factor is draining: hold.
    drain_factor: float = 0.9
    #: Fast-tier insert share below which all restrictions are released.
    fast_idle_alpha: float = 0.02


@dataclasses.dataclass
class Decision:
    """What one slow tier's traffic is allowed during the next window."""

    max_concurrency: Optional[int]  # None = unrestricted
    rate_factor: float  # 1.0 = unthrottled request rate
    phase: Phase
    estimate: Optional[TierEstimate] = None

    @property
    def restricted(self) -> bool:
        return self.phase is Phase.RESTRICTED


@dataclasses.dataclass
class TierDecisions:
    """One :class:`Decision` per slow tier, in platform slow-tier order.
    Also reads like a single merged (most restrictive) :class:`Decision`."""

    tiers: Tuple[str, ...]
    decisions: Tuple[Decision, ...]

    def __post_init__(self) -> None:
        if len(self.tiers) != len(self.decisions) or not self.decisions:
            raise ValueError(
                f"TierDecisions needs one decision per slow tier, got "
                f"{len(self.tiers)} tier(s) / {len(self.decisions)} decision(s)"
            )

    def for_tier(self, tier: str) -> Decision:
        """The named slow tier's :class:`Decision` (ValueError if absent)."""
        return self.decisions[self.tiers.index(tier)]

    @property
    def max_concurrency(self) -> Optional[int]:
        caps = [d.max_concurrency for d in self.decisions
                if d.max_concurrency is not None]
        return min(caps) if caps else None

    @property
    def rate_factor(self) -> float:
        return min(d.rate_factor for d in self.decisions)

    @property
    def phase(self) -> Phase:
        return Phase.RESTRICTED if self.restricted else Phase.UNRESTRICTED

    @property
    def restricted(self) -> bool:
        return any(d.restricted for d in self.decisions)

    @property
    def estimate(self) -> Optional[TierEstimate]:
        return self.decisions[0].estimate


class SlowTierMiku:
    """One slow tier's MIKU state machine, fed ``(fast, this_tier)`` windows."""

    def __init__(
        self,
        config: MikuConfig,
        estimator_config: EstimatorConfig,
        tier: str = "slow",
    ):
        self.tier = tier
        self.config = config
        self.estimator = LittlesLawEstimator(estimator_config)
        self.phase = Phase.UNRESTRICTED
        self._level_idx = len(config.levels) - 1
        self._rate = 1.0
        self._calm_windows = 0
        self._prev_raw: Optional[float] = None

    def _class_cap(self, slow_classes: Sequence[OpClass]) -> int:
        """The least permissive cap among the classes present (1 for a
        class with no configured cap)."""
        caps = [self.config.class_caps.get(c, 1) for c in slow_classes]
        return min(caps) if caps else max(self.config.levels)

    def _level_value(self) -> int:
        return self.config.levels[self._level_idx]

    def _demote_fully(self) -> None:
        """Paper: move all slow-tier actors to level-3 at once."""
        self._level_idx = 0
        self._calm_windows = 0
        self.phase = Phase.RESTRICTED

    def window(
        self,
        fast_delta: TierCounters,
        slow_delta: TierCounters,
    ) -> Decision:
        """One estimation window: update the estimator, advance the ladder,
        return this tier's :class:`Decision`."""
        cfg = self.config
        est = self.estimator.update(fast_delta, slow_delta)
        slow_classes = [c for c, n in slow_delta.class_counts.items() if n > 0]

        raw = est.t_slow_raw if est.valid else None
        if self.phase is Phase.UNRESTRICTED:
            # Detection uses the smoothed estimate.
            if est.valid and est.backlogged:
                self._demote_fully()
                self._rate = 1.0
        else:
            fast_idle = (not est.valid and fast_delta.inserts == 0) or (
                est.valid and est.alpha < cfg.fast_idle_alpha
            )
            if fast_idle:
                # Work conservation: nobody is being hurt — release.
                self.phase = Phase.UNRESTRICTED
                self._level_idx = len(cfg.levels) - 1
                self._rate = 1.0
                self._calm_windows = 0
            elif raw is not None and raw > est.threshold:
                self._calm_windows = 0
                draining = (
                    self._prev_raw is not None
                    and raw < self._prev_raw * cfg.drain_factor
                )
                if draining:
                    pass  # the restriction is working; let the queue empty
                elif self._level_idx > 0:
                    self._demote_fully()
                else:
                    # Already at level-3: fine-grained rate control.
                    self._rate = max(cfg.min_rate, self._rate * cfg.rate_backoff)
            elif raw is not None and raw < cfg.target_margin * est.threshold:
                self._calm_windows += 1
                if self._calm_windows >= cfg.promote_patience:
                    self._calm_windows = 0
                    if self._rate < 1.0:
                        self._rate = min(1.0, self._rate * cfg.rate_recover)
                    else:
                        cap = self._class_cap(slow_classes)
                        nxt = self._level_idx + 1
                        if (
                            nxt < len(cfg.levels)
                            and cfg.levels[nxt] <= max(cap, cfg.levels[0])
                        ):
                            self._level_idx = nxt
            else:
                # In the hysteresis band (or invalid window): hold position.
                self._calm_windows = 0
        if raw is not None:
            self._prev_raw = raw

        if self.phase is Phase.UNRESTRICTED:
            return Decision(
                max_concurrency=None, rate_factor=1.0, phase=self.phase, estimate=est
            )
        return Decision(
            max_concurrency=self._level_value(),
            rate_factor=self._rate,
            phase=self.phase,
            estimate=est,
        )

    def reset(self) -> None:
        """Forget all ladder and estimator state (back to unrestricted)."""
        self.phase = Phase.UNRESTRICTED
        self._level_idx = len(self.config.levels) - 1
        self._rate = 1.0
        self._calm_windows = 0
        self._prev_raw = None
        self.estimator.reset()


def _as_seq(value, n: int, what: str) -> list:
    """Broadcast a single config to ``n`` units, or validate a sequence."""
    if isinstance(value, (list, tuple)):
        if len(value) < n:
            raise ValueError(
                f"MikuController got {len(value)} per-tier {what}(s) for "
                f"{n} slow tier(s)"
            )
        return list(value[:n])
    return [value] * n


def split_tier_window(
    deltas: Sequence[TierCounters],
) -> Tuple[TierCounters, Tuple[TierCounters, ...], Tuple[str, ...]]:
    """``(fast, slows, slow_names)`` from one per-tier delta vector; names
    come from a TierWindow when present, else ``slow{i}``."""
    if len(deltas) < 2:
        raise ValueError(
            "per-tier window needs the fast tier plus >=1 slow tier, "
            f"got {len(deltas)} tier(s)"
        )
    names = getattr(deltas, "names", None)
    slows = tuple(deltas[1:])
    slow_names = (
        tuple(names[1:]) if names is not None
        else tuple(f"slow{i}" for i in range(len(slows)))
    )
    return deltas[0], slows, slow_names


class MikuController:
    """A per-slow-tier ensemble of MIKU ladders over estimation windows.

    ``config`` / ``estimator_config`` are a single value (every slow tier
    gets its own unit with that calibration) or one entry per slow tier.
    Units are created when the first window reveals the slow tier count.
    """

    def __init__(
        self,
        config: Union[MikuConfig, Sequence[MikuConfig]],
        estimator_config: Union[EstimatorConfig, Sequence[EstimatorConfig]],
    ):
        self._configs = config
        self._est_configs = estimator_config
        self.units: List[SlowTierMiku] = []
        self._ensure_units(1)
        self.decisions: list = []

    def _ensure_units(
        self, n_slow: int, names: Optional[Sequence[str]] = None
    ) -> None:
        if len(self.units) < n_slow:
            cfgs = _as_seq(self._configs, n_slow, "MikuConfig")
            ests = _as_seq(self._est_configs, n_slow, "EstimatorConfig")
            for i in range(len(self.units), n_slow):
                tier = (
                    names[i] if names is not None and i < len(names)
                    else f"slow{i}"
                )
                self.units.append(SlowTierMiku(cfgs[i], ests[i], tier=tier))
        if names is not None:
            for i in range(min(len(names), len(self.units))):
                self.units[i].tier = names[i]

    def window(self, deltas: Sequence[TierCounters]) -> TierDecisions:
        """One window: per-tier deltas in (fast first), one :class:`Decision`
        per slow tier out; each unit sees the shared fast delta and its own
        tier's delta."""
        fast, slows, slow_names = split_tier_window(deltas)
        self._ensure_units(len(slows), slow_names)
        decision = TierDecisions(
            tiers=slow_names,
            decisions=tuple(
                unit.window(fast, s)
                for unit, s in zip(self.units, slows)
            ),
        )
        self.decisions.append(decision)
        return decision

    def reset(self) -> None:
        """Reset every per-tier unit and clear the decision history."""
        for unit in self.units:
            unit.reset()
        self.decisions.clear()
