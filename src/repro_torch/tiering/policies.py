"""Tiering policy registry: static / hotness_lru / miku_coordinated.

A copy of ``repro.tiering.policies``.

A policy is a per-window pure-ish function ``decide(pagemap, ctx) ->
[MigrationJob]``; the hook enqueues whatever comes back into the
:class:`~repro_torch.tiering.engine.MigrationEngine`.  The context carries
the control plane's view of the world — the latest tier-addressed
:class:`~repro_torch.core.controller.TierDecisions` and the MIKU ladders'
per-tier migration budgets — so a policy can coordinate with (or ignore) the
bandwidth controller.

* ``static`` — never migrates; the frozen-placement baseline.
* ``hotness_lru`` — TPP-style: promote the hottest slow pages into free
  fast-tier capacity, demote the coldest fast pages when occupancy crosses
  the high watermark (down to the low watermark).
* ``miku_coordinated`` — ``hotness_lru``'s candidates, gated by MIKU: while
  a slow tier's ladder is restricting demand traffic (or its migration
  budget is zero), jobs crossing that tier are *deferred*, and per-window
  enqueue volume scales with the ladder's migration budget.  Migration is
  best-effort by construction: it only spends bandwidth the controller says
  the tier can give away.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.controller import TierDecisions
from repro_torch.tiering.engine import MigrationEngine, MigrationJob
from repro_torch.tiering.pagemap import PageMap


@dataclasses.dataclass
class PolicyContext:
    """What a policy may consult when deciding one window's migrations."""

    window: int
    tier_names: Tuple[str, ...]
    engine: MigrationEngine
    #: The control plane's latest tier-addressed decision (None when the sim
    #: runs without a controller, or before the first decision window).
    decisions: Optional[TierDecisions] = None
    #: Per-slow-tier migration budgets from the MIKU ladders (tier name →
    #: allowed concurrent migration streams); None without a MIKU ensemble.
    budgets: Optional[Dict[str, int]] = None
    #: Out-parameter: jobs the policy wanted but chose to defer this window
    #: (telemetry — the miku_coordinated deferral counter).
    deferred: int = 0


class StaticPolicy:
    """Placement is frozen at construction — the no-migration baseline."""

    name = "static"

    def decide(self, pagemap: PageMap, ctx: PolicyContext) -> List[MigrationJob]:
        """Never migrate (the placement-vector baseline)."""
        del pagemap, ctx
        return []


class HotnessLRUPolicy:
    """TPP-style promotion + watermark demotion over decayed hotness.

    ``promote_per_window`` bounds promotion aggressiveness (the naive
    configuration races exactly as hard as this allows); ``min_hotness``
    filters never-touched pages; the watermark pair bounds fast-tier
    occupancy, demoting coldest-first back to each region's home slow tier.
    """

    name = "hotness_lru"

    def __init__(
        self,
        promote_per_window: int = 64,
        demote_per_window: int = 64,
        high_watermark: float = 0.95,
        low_watermark: float = 0.85,
        min_hotness: float = 1e-9,
    ) -> None:
        self.promote_per_window = promote_per_window
        self.demote_per_window = demote_per_window
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.min_hotness = min_hotness

    # -- candidate selection ----------------------------------------------
    def _promotions(
        self, pagemap: PageMap, engine: MigrationEngine
    ) -> List[MigrationJob]:
        free = (
            pagemap.fast_capacity_pages
            - pagemap.fast_pages_used()
            - engine.queued_promotions()
        )
        budget = min(free, self.promote_per_window)
        if budget <= 0:
            return []
        candidates: List[Tuple[float, str, int, int]] = []
        for region in pagemap.regions.values():
            slow = np.flatnonzero(region.tier != 0)
            if not slow.size:
                continue
            hot = region.hotness[slow]
            keep = hot > self.min_hotness
            for page, h in zip(slow[keep], hot[keep]):
                if not engine.is_queued(region.name, int(page)):
                    candidates.append(
                        (float(h), region.name, int(page),
                         int(region.tier[page]))
                    )
        candidates.sort(key=lambda c: (-c[0], c[1], c[2]))
        return [
            MigrationJob(region=name, page=page, src=src, dst=0)
            for _, name, page, src in candidates[:budget]
        ]

    def _demotions(
        self, pagemap: PageMap, engine: MigrationEngine
    ) -> List[MigrationJob]:
        # Project occupancy past the copies already in flight: queued
        # demotions will free their pages once paid for, so re-demoting for
        # the same gap every window would overshoot far below the low
        # watermark while the engine drains.
        used = pagemap.fast_pages_used() - engine.queued_demotions()
        cap = pagemap.fast_capacity_pages
        if used <= self.high_watermark * cap:
            return []
        target = max(0, used - int(self.low_watermark * cap))
        budget = min(target, self.demote_per_window)
        candidates: List[Tuple[float, str, int, int]] = []
        for region in pagemap.regions.values():
            fast = region.pages_on(0)
            for page in fast:
                if not engine.is_queued(region.name, int(page)):
                    candidates.append(
                        (float(region.hotness[page]), region.name,
                         int(page), region.home_slow)
                    )
        candidates.sort(key=lambda c: (c[0], c[1], c[2]))  # coldest first
        return [
            MigrationJob(region=name, page=page, src=0, dst=dst)
            for _, name, page, dst in candidates[:budget]
        ]

    def decide(self, pagemap: PageMap, ctx: PolicyContext) -> List[MigrationJob]:
        """TPP-style: promote hottest slow pages into free fast capacity,
        demote coldest fast pages past the watermark."""
        return (
            self._promotions(pagemap, ctx.engine)
            + self._demotions(pagemap, ctx.engine)
        )


class MikuCoordinatedPolicy:
    """``hotness_lru`` candidates, admitted only with MIKU's consent.

    Per window, for each candidate job: look up the ladder state of the slow
    tier the copy would cross.  If that tier's decision is currently
    RESTRICTED, or its migration budget is 0, the job is deferred (counted,
    re-considered next window — hot pages stay hot).  Otherwise at most
    ``jobs_per_budget_unit × budget`` jobs are enqueued on that tier this
    window, so migration aggressiveness follows the ladder's promotion state
    instead of racing demand traffic.
    """

    name = "miku_coordinated"

    def __init__(self, jobs_per_budget_unit: int = 8, **base_kwargs) -> None:
        self.base = HotnessLRUPolicy(**base_kwargs)
        self.jobs_per_budget_unit = jobs_per_budget_unit

    def decide(self, pagemap: PageMap, ctx: PolicyContext) -> List[MigrationJob]:
        """Run the base policy, then defer jobs beyond the MIKU ladders'
        per-tier migration budgets (throttled tiers issue nothing)."""
        jobs = self.base.decide(pagemap, ctx)
        if not jobs:
            return jobs
        admitted: List[MigrationJob] = []
        taken: Dict[int, int] = {}
        for job in jobs:
            code = job.traffic_tier
            tier = ctx.tier_names[code]
            budget = (
                ctx.budgets.get(tier) if ctx.budgets is not None else None
            )
            if budget is not None:
                # The ladder's migration budget is the gate: 0 (fine-grained
                # rate control engaged — even level-3 demand concurrency is
                # too much) defers everything; a restricted-but-stable
                # ladder admits a budget-scaled trickle.
                if budget <= 0 or taken.get(code, 0) >= (
                    budget * self.jobs_per_budget_unit
                ):
                    ctx.deferred += 1
                    continue
            elif ctx.decisions is not None and tier in ctx.decisions.tiers:
                # No per-ladder budgets (merged law / foreign controller):
                # fall back to the coarse restricted bit.
                if ctx.decisions.for_tier(tier).restricted:
                    ctx.deferred += 1
                    continue
            taken[code] = taken.get(code, 0) + 1
            admitted.append(job)
        return admitted


POLICIES: Dict[str, Callable[..., object]] = {
    StaticPolicy.name: StaticPolicy,
    HotnessLRUPolicy.name: HotnessLRUPolicy,
    MikuCoordinatedPolicy.name: MikuCoordinatedPolicy,
}


def make_policy(name: str, **kwargs):
    """Instantiate a registered tiering policy by name (ValueError lists
    the registry)."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown tiering policy {name!r}; registered policies: "
            f"{', '.join(sorted(POLICIES))}"
        ) from None
    return cls(**kwargs)
