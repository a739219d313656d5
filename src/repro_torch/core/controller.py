"""MIKU — Dynamic Memory Request Control (paper §5.2), per slow tier.

A copy of the MIKU path of ``repro.core.controller``: one Little's-Law
estimator, throttle ladder and work-conserving promotion state per slow
tier (:class:`SlowTierMiku`), run as an ensemble by :class:`MikuController`
over per-tier windows (:class:`~repro_torch.core.littles_law.TierWindow`,
fast tier first) and answering with tier-addressed :class:`TierDecisions`.
:class:`MergedSlowPolicy` is the merged-slow law: one ladder fed the fold
of every slow tier's window, its decision broadcast to each slow tier.
:class:`VectorMikuLadder` is the same state machine over ``(cells, units)``
tensors, for the batched sweep lane (a merged cell runs its one ladder as
unit 0).
:class:`StragglerGovernor` applies the same estimator to per-host step
service times in the trainer, answering with :class:`HostHealth` lists.

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
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.invariants import require
from repro_torch.core.littles_law import (
    ACCESS_MIX,
    EstimatorConfig,
    LittlesLawEstimator,
    OpClass,
    TierCounters,
    TierEstimate,
    merge_tier_counters,
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

    def items(self) -> Tuple[Tuple[str, Decision], ...]:
        """``(tier name, Decision)`` pairs in platform slow-tier order."""
        return tuple(zip(self.tiers, self.decisions))

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

    def migration_budget(self) -> int:
        """Concurrent migration streams this ladder tolerates on its tier:
        the MIGRATE class cap while unrestricted, the current level (bounded
        by that cap) while restricted, and zero once fine-grained rate
        control has engaged (best-effort copies stand down)."""
        cap = self.config.class_caps.get(OpClass.MIGRATE, 1)
        if self.phase is Phase.UNRESTRICTED:
            return cap
        if self._rate < 1.0:
            return 0
        return min(cap, self._level_value())

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

    _warned_pair = False  # process-wide: the deprecation warns once

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

    @property
    def config(self) -> MikuConfig:
        """Unit 0's ladder config (the single-ladder attribute)."""
        return self.units[0].config

    @property
    def estimator(self) -> LittlesLawEstimator:
        """Unit 0's estimator (the single-ladder attribute)."""
        return self.units[0].estimator

    def window(self, *deltas):
        """``window(deltas)`` with one per-tier vector (fast tier first) ->
        :class:`TierDecisions`.  The two-argument ``window(fast, slow)`` form
        is deprecated: it runs unit 0 (:meth:`pair_window`) and returns that
        unit's plain :class:`Decision`."""
        if len(deltas) == 1 and not isinstance(deltas[0], TierCounters):
            return self.window_vector(deltas[0])
        if len(deltas) == 2:
            if not MikuController._warned_pair:
                MikuController._warned_pair = True
                warnings.warn(
                    "MikuController.window(fast_delta, slow_delta) is "
                    "deprecated; pass one per-tier TierWindow "
                    "(window(deltas)) instead",
                    DeprecationWarning,
                    stacklevel=2,
                )
            return self.pair_window(*deltas)
        raise TypeError(
            "MikuController.window expects one per-tier delta vector or "
            f"the legacy (fast, slow) pair; got {len(deltas)} argument(s)"
        )

    def pair_window(self, fast_delta: TierCounters,
                    slow_delta: TierCounters) -> Decision:
        """Drive unit 0 with one merged ``(fast, slow)`` window (what
        :class:`MergedSlowPolicy` runs)."""
        decision = self.units[0].window(fast_delta, slow_delta)
        self.decisions.append(decision)
        return decision

    def window_vector(self, deltas: Sequence[TierCounters]) -> TierDecisions:
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

    def migration_budgets(self) -> Dict[str, int]:
        """Per-slow-tier migration budgets (tier name -> allowed concurrent
        migration streams), what a MIKU-coordinated tiering policy consults."""
        return {u.tier: u.migration_budget() for u in self.units}

    def reset(self) -> None:
        """Reset every per-tier unit and clear the decision history."""
        for unit in self.units:
            unit.reset()
        self.decisions.clear()


class MergedSlowPolicy:
    """The merged-slow law: each window folds tiers 1..n-1 of the per-tier
    vector into one slow delta, runs the wrapped controller's unit 0 once
    (:meth:`MikuController.pair_window`) and broadcasts its single decision
    to every slow tier."""

    def __init__(self, law: MikuController):
        self.law = law
        self.decisions: list = []

    def window(self, deltas: Sequence[TierCounters]) -> TierDecisions:
        fast, slows, slow_names = split_tier_window(deltas)
        d = self.law.pair_window(fast, merge_tier_counters(slows))
        decision = TierDecisions(tiers=slow_names, decisions=(d,) * len(slow_names))
        self.decisions.append(decision)
        return decision

    def reset(self) -> None:
        """Reset the wrapped controller and clear the decision history."""
        self.law.reset()
        self.decisions.clear()


class VectorMikuLadder:
    """The MIKU decision law over ``(cells, units)`` float64 tensors.

    A copy of ``repro.core.controller.VectorMikuLadder`` in torch, so the
    batched sweep lane can keep its ladder state on the card: every (cell,
    slow tier) pair carries its own estimator EWMA, ladder level, rate and
    promotion state, and :meth:`window` advances all of them with masks.
    The state machine is :class:`SlowTierMiku`'s, and it stays float64 so
    that its decision sequences equal the reference's on the same counters.
    Built from per-(cell, unit) :class:`SlowTierMiku` instances by
    :meth:`from_units`; all ladders share one rung sequence.
    """

    def __init__(self, cells: int, units: int, levels: Sequence[int],
                 device: torch.device):
        self.device = device
        self.cells = cells
        self.units = units
        f64 = dict(dtype=torch.float64, device=device)
        self.levels_arr = torch.tensor([float(v) for v in levels], **f64)
        self.n_levels = len(levels)
        shape = (cells, units)
        n_ops = len(OpClass)
        self.t_fast = torch.zeros(shape, **f64)
        self.slow_read_threshold = torch.zeros(shape, **f64)
        self.write_scale = torch.full(shape, 2.0, **f64)
        self.ewma_a = torch.full(shape, 0.5, **f64)
        self.alpha_calm = torch.full(shape, 0.97, **f64)
        self.min_window_inserts = torch.full(shape, 16.0, **f64)
        self.min_slow_inserts = torch.full(shape, 4.0, **f64)
        self.t_fast_scale = torch.ones(shape + (n_ops,), **f64)
        self.class_caps = torch.ones(shape + (n_ops,), **f64)
        self.min_rate = torch.full(shape, 0.1, **f64)
        self.rate_backoff = torch.full(shape, 0.5, **f64)
        self.rate_recover = torch.full(shape, 2.0, **f64)
        self.patience = torch.full(shape, 1.0, **f64)
        self.target_margin = torch.full(shape, 0.85, **f64)
        self.drain_factor = torch.full(shape, 0.9, **f64)
        self.fast_idle_alpha = torch.full(shape, 0.02, **f64)
        ops = tuple(OpClass)
        self.mix_reads = torch.tensor([float(ACCESS_MIX[c][0]) for c in ops], **f64)
        self.mix_writes = torch.tensor([float(ACCESS_MIX[c][1]) for c in ops], **f64)
        self.reset()

    def reset(self) -> None:
        """Reset every (cell, unit) ladder and estimator to the initial state."""
        shape = (self.cells, self.units)
        f64 = dict(dtype=torch.float64, device=self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        self.level = torch.full(shape, self.n_levels - 1, **i64)
        self.rate = torch.ones(shape, **f64)
        self.calm = torch.zeros(shape, **i64)
        self.restricted = torch.zeros(shape, dtype=torch.bool, device=self.device)
        self.prev_raw = torch.zeros(shape, **f64)
        self.has_prev = torch.zeros_like(self.restricted)
        self.t_slow = torch.zeros(shape, **f64)
        self.has_ewma = torch.zeros_like(self.restricted)

    @classmethod
    def from_units(
        cls,
        unit_grid: Sequence[Sequence[Optional[SlowTierMiku]]],
        device: Union[str, torch.device] = "cpu",
    ) -> "VectorMikuLadder":
        """Stack per-cell lists of :class:`SlowTierMiku` (None pads inactive
        slots) into one vector ladder on ``device``; every real unit must
        share the rung sequence (``ValueError`` otherwise)."""
        cells = len(unit_grid)
        units = max((len(row) for row in unit_grid), default=0) or 1
        levels: Optional[Tuple[int, ...]] = None
        for row in unit_grid:
            for u in row:
                if u is None:
                    continue
                lv = tuple(u.config.levels)
                if levels is None:
                    levels = lv
                elif lv != levels:
                    raise ValueError(
                        "VectorMikuLadder requires one shared ladder rung "
                        f"sequence; got {levels} and {lv}"
                    )
        self = cls(cells, units, levels or MikuConfig().levels, torch.device(device))
        ops = tuple(OpClass)
        # Fill host copies, then move each table to the device once.
        host = {name: getattr(self, name).cpu() for name in (
            "t_fast", "slow_read_threshold", "write_scale", "ewma_a",
            "alpha_calm", "min_window_inserts", "min_slow_inserts",
            "t_fast_scale", "class_caps", "min_rate", "rate_backoff",
            "rate_recover", "patience", "target_margin", "drain_factor",
            "fast_idle_alpha")}
        for ci, row in enumerate(unit_grid):
            for ui, u in enumerate(row):
                if u is None:
                    continue
                cfg, est = u.config, u.estimator.config
                scales = est.t_fast_class_scale or {}
                host["t_fast"][ci, ui] = est.t_fast
                host["slow_read_threshold"][ci, ui] = est.slow_read_threshold
                host["write_scale"][ci, ui] = est.write_threshold_scale
                host["ewma_a"][ci, ui] = est.ewma
                host["alpha_calm"][ci, ui] = est.alpha_calm
                host["min_window_inserts"][ci, ui] = est.min_window_inserts
                host["min_slow_inserts"][ci, ui] = est.min_slow_inserts
                host["t_fast_scale"][ci, ui] = torch.tensor(
                    [float(scales.get(c, 1.0)) for c in ops], dtype=torch.float64)
                host["class_caps"][ci, ui] = torch.tensor(
                    [float(cfg.class_caps.get(c, 1)) for c in ops], dtype=torch.float64)
                host["min_rate"][ci, ui] = cfg.min_rate
                host["rate_backoff"][ci, ui] = cfg.rate_backoff
                host["rate_recover"][ci, ui] = cfg.rate_recover
                host["patience"][ci, ui] = cfg.promote_patience
                host["target_margin"][ci, ui] = cfg.target_margin
                host["drain_factor"][ci, ui] = cfg.drain_factor
                host["fast_idle_alpha"][ci, ui] = cfg.fast_idle_alpha
        for name, t in host.items():
            setattr(self, name, t.to(self.device))
        return self

    def window(self, fast_ins, fast_occ, fast_cls, slow_ins, slow_occ,
               slow_cls) -> Dict[str, torch.Tensor]:
        """Advance every (cell, unit) ladder by one estimation window.

        ``fast_*`` are per-cell fast-tier window deltas (``fast_cls``
        shaped ``(cells, n_ops)``); ``slow_*`` are per-(cell, unit) deltas
        (``slow_cls`` shaped ``(cells, units, n_ops)``), float64 on the
        ladder's device.  Returns the decision tensors plus the estimate
        fields of :class:`~repro_torch.core.littles_law.TierEstimate`;
        ``cap`` is +inf for unrestricted pairs.
        """
        f_ins = fast_ins[:, None]
        f_occ = fast_occ[:, None]
        f_cls = fast_cls[:, None, :]
        tiny = 1e-300

        # -- estimator (LittlesLawEstimator.update, vectorized) ------------
        total_ins = f_ins + slow_ins
        total_occ = f_occ + slow_occ
        reads = (slow_cls * self.mix_reads).sum(-1)
        writes = (slow_cls * self.mix_writes).sum(-1)
        tot_rw = reads + writes
        rf = torch.where(tot_rw > 0, reads / tot_rw.clamp(min=tiny), 1.0)
        wf = torch.where(tot_rw > 0, writes / tot_rw.clamp(min=tiny), 0.0)
        threshold = self.slow_read_threshold * (rf + wf * self.write_scale)
        num = (f_cls * self.t_fast_scale).sum(-1)
        den = f_cls.sum(-1).clamp(min=1.0)
        t_fast = torch.where(f_ins > 0, self.t_fast * num / den, self.t_fast)
        valid = (total_ins >= self.min_window_inserts) & (
            slow_ins >= self.min_slow_inserts
        )
        t_avg = torch.where(total_ins > 0, total_occ / total_ins.clamp(min=tiny), 0.0)
        alpha_v = f_ins / total_ins.clamp(min=tiny)
        alpha = torch.where(valid, alpha_v,
                            torch.where(slow_ins == 0, 1.0, 0.0))
        slow_mean = torch.where(slow_ins > 0, slow_occ / slow_ins.clamp(min=tiny), 0.0)
        raw_eq1 = (t_avg - alpha * t_fast) / (1.0 - alpha).clamp(min=1e-12)
        raw = torch.where(alpha > self.alpha_calm, slow_mean, raw_eq1).clamp(min=0.0)
        raw = torch.where(valid, raw, 0.0)
        upd = torch.where(
            self.has_ewma,
            self.ewma_a * raw + (1.0 - self.ewma_a) * self.t_slow,
            raw,
        )
        self.t_slow = torch.where(valid, upd, self.t_slow)
        self.has_ewma = self.has_ewma | valid
        backlogged = valid & (self.t_slow > threshold)

        # -- ladder (SlowTierMiku.window, vectorized) ----------------------
        was_restricted = self.restricted
        demote_unres = ~was_restricted & backlogged
        fast_idle = (~valid & (f_ins == 0)) | (valid & (alpha < self.fast_idle_alpha))
        release = was_restricted & fast_idle
        over = was_restricted & ~fast_idle & valid & (raw > threshold)
        draining = over & self.has_prev & (raw < self.prev_raw * self.drain_factor)
        demote_again = over & ~draining & (self.level > 0)
        back_off = over & ~draining & (self.level == 0)
        under = (
            was_restricted & ~fast_idle & ~over & valid
            & (raw < self.target_margin * threshold)
        )
        hold = was_restricted & ~fast_idle & ~over & ~under

        calm = torch.where(over | hold, 0, self.calm)
        calm = torch.where(under, calm + 1, calm)
        do_promote = under & (calm >= self.patience)
        calm = torch.where(do_promote | release | demote_unres, 0, calm)
        recover = do_promote & (self.rate < 1.0)
        promote = do_promote & (self.rate >= 1.0)
        present = slow_cls > 0
        caps_masked = torch.where(present, self.class_caps, float("inf"))
        class_cap = torch.where(present.any(-1), caps_masked.amin(-1),
                                self.levels_arr[-1])
        nxt = self.level + 1
        nxt_val = self.levels_arr[nxt.clamp(max=self.n_levels - 1)]
        can = (nxt < self.n_levels) & (
            nxt_val <= class_cap.clamp(min=self.levels_arr[0])
        )

        level = torch.where(demote_unres | demote_again, 0, self.level)
        level = torch.where(release, self.n_levels - 1, level)
        level = torch.where(promote & can, self.level + 1, level)
        rate = torch.where(demote_unres | release, 1.0, self.rate)
        rate = torch.where(
            back_off, torch.maximum(self.min_rate, self.rate * self.rate_backoff),
            rate,
        )
        rate = torch.where(recover, (self.rate * self.rate_recover).clamp(max=1.0), rate)
        restricted = (was_restricted | demote_unres) & ~release

        self.level, self.rate, self.calm = level, rate, calm
        self.restricted = restricted
        self.prev_raw = torch.where(valid, raw, self.prev_raw)
        self.has_prev = self.has_prev | valid

        return {
            "cap": torch.where(restricted, self.levels_arr[level], float("inf")),
            "rate": torch.where(restricted, rate, 1.0),
            "restricted": restricted,
            "t_avg": t_avg,
            "alpha": alpha,
            "t_slow": self.t_slow.clone(),
            "t_slow_raw": raw,
            "threshold": threshold,
            "backlogged": backlogged,
            "valid": valid,
        }

    def migration_budgets(self) -> torch.Tensor:
        """Per-(cell, unit) migration budgets (int64, on the ladder's device)
        from the current ladder state, :meth:`SlowTierMiku.migration_budget`
        vectorized: the MIGRATE class cap while unrestricted, zero once rate
        control has engaged, else the current level bounded by that cap.
        Read after :meth:`window`, the post-window state a policy sees."""
        cap = self.class_caps[:, :, tuple(OpClass).index(OpClass.MIGRATE)]
        lvl = self.levels_arr[self.level]
        return torch.where(~self.restricted, cap,
                           torch.where(self.rate < 1.0, 0.0,
                                       torch.minimum(cap, lvl))).to(torch.int64)


# ---------------------------------------------------------------------------
# Straggler governor: the same estimator applied to per-host step service
# times.  A slow host is "an overloaded slow tier": its step service time is
# estimated per window; hosts whose estimate exceeds the threshold get their
# input shard rate-capped, then excluded.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostHealth:
    host: int
    t_step: float
    healthy: bool
    rate_factor: float


class StragglerGovernor:
    """Detect and mitigate straggler hosts via service-time estimation.

    ``threshold_scale`` x the median step time flags a straggler; mitigation
    follows MIKU's ladder: first halve the straggler's microbatch share
    (``rate_factor``), then exclude it (rate 0: its shard goes to healthy
    hosts) if it keeps degrading.  Recovery doubles the rate a window,
    mirroring the work-conserving promotion.
    """

    def __init__(self, n_hosts: int, threshold_scale: float = 1.35, ewma: float = 0.4,
                 patience: int = 2):
        self.n_hosts = n_hosts
        self.threshold_scale = threshold_scale
        self.ewma = ewma
        self.patience = patience
        self._t = [0.0] * n_hosts
        self._bad_windows = [0] * n_hosts
        self._rate = [1.0] * n_hosts

    def window(self, step_times: Sequence[float]) -> List[HostHealth]:
        require(len(step_times) == self.n_hosts, "host-count",
                "one step time per host required", expected=self.n_hosts,
                got=len(step_times))
        for h, t in enumerate(step_times):
            if t <= 0:  # the host missed the window entirely: the worst signal
                self._bad_windows[h] += 1
                continue
            self._t[h] = (t if self._t[h] == 0.0
                          else self.ewma * t + (1 - self.ewma) * self._t[h])
        alive = sorted(t for t in self._t if t > 0)
        if not alive:
            return [HostHealth(h, 0.0, True, 1.0) for h in range(self.n_hosts)]
        threshold = self.threshold_scale * alive[len(alive) // 2]
        out = []
        for h in range(self.n_hosts):
            if self._t[h] > threshold:
                self._bad_windows[h] += 1
                if self._bad_windows[h] >= self.patience:
                    # Demote: halve its shard; floor at exclusion.
                    self._rate[h] = 0.0 if self._rate[h] <= 0.25 else self._rate[h] / 2
            else:
                self._bad_windows[h] = 0
                if self._rate[h] < 1.0:
                    self._rate[h] = min(1.0, max(self._rate[h], 0.25) * 2)
            out.append(HostHealth(host=h, t_step=self._t[h], healthy=self._rate[h] >= 1.0,
                                  rate_factor=self._rate[h]))
        return out
