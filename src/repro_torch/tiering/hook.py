"""Tiering hook: TieringSpec (picklable config) -> TieringHook (per job).

A copy of ``repro.tiering.hook``.  The DES
(:class:`~repro_torch.core.des.TieredMemorySim`) drives a hook through
three duck-typed entry points:

* ``migration_workloads(platform)`` — the per-slow-tier MIGRATE
  pseudo-workloads (``mig-<tier>``) appended to the job's workload list
  (kernel migration daemons: a few cores issuing page-copy traffic);
* ``bind(sim)`` — resolve tier codes, build the PageMap/engine/policy,
  write the *initial* PageMap-derived routing into the sim's issue tables
  and gate the migration workloads closed;
* ``on_window(sim)`` — once a control window, after the ControlLoop fired:
  drain migration completions into page moves, feed demand completions to
  the hotness tracker, run the policy, re-resolve each tracked workload's
  routing and re-gate migration issue.

The batched lane binds a hook to a job's exported state instead
(``bind_export``, through :func:`repro_torch.core.des.export_state`), which
it leaves equal to what a bound sim exports; its twin
:class:`~repro_torch.memsim.batched.tiering.VectorTiering` runs the
per-window pass for a whole cell group.  ``summary()`` is the end-of-run
summary of ``SimResult.tiering``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.controller import TierDecisions
from repro_torch.core.des import WorkloadSpec, cumulative_fractions
from repro_torch.core.device_model import PlatformModel
from repro_torch.core.invariants import require
from repro_torch.core.littles_law import OpClass
from repro_torch.tiering.engine import MigrationEngine
from repro_torch.tiering.pagemap import HotSetPattern, PageMap
from repro_torch.tiering.policies import PolicyContext, make_policy


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One tracked workload's page region (initial placement + access
    pattern).  ``workload`` names a demand workload of the same job."""

    workload: str
    n_pages: int
    placement: Dict[str, float]
    pattern: HotSetPattern = HotSetPattern()


@dataclasses.dataclass(frozen=True)
class TieringSpec:
    """Everything a job needs to build a fresh tiering hook (picklable)."""

    regions: Tuple[RegionSpec, ...]
    policy: str = "hotness_lru"
    policy_args: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Fast-tier page budget shared by all regions.
    fast_capacity_pages: int = 1024
    page_bytes: int = 4096
    hotness_decay: float = 0.5
    #: The migration pseudo-workloads: cores per slow tier and per-core MLP
    #: (how hard the copy engine races when it has backlog).
    mig_cores: int = 4
    mig_mlp: int = 64
    #: False models a kernel migration daemon outside MIKU's reach (the
    #: *naive* configuration); True makes migration a MIKU-governed request
    #: class like any other slow-tier actor.
    mig_miku_managed: bool = True

    def build(self) -> "TieringHook":
        """Construct a fresh per-job hook (the spec itself stays picklable)."""
        return TieringHook(self)


#: Migration pseudo-workload name prefix (one per slow tier).
MIG_PREFIX = "mig-"


class TieringHook:
    """Per-job tiering state machine (see the module docstring)."""

    def __init__(self, spec: TieringSpec) -> None:
        self.spec = spec
        self.pagemap: Optional[PageMap] = None
        self.window_log: List[dict] = []
        self.deferred_jobs = 0
        self._windows = 0

    def migration_workloads(self, platform: PlatformModel) -> List[WorkloadSpec]:
        """The per-slow-tier migration pseudo-workloads (``mig-<tier>``)
        this spec contributes to the job's workload list."""
        return [
            WorkloadSpec(
                name=f"{MIG_PREFIX}{tier}",
                op=OpClass.MIGRATE,
                tier=tier,
                n_cores=self.spec.mig_cores,
                mlp=self.spec.mig_mlp,
                miku_managed=self.spec.mig_miku_managed,
            )
            for tier in platform.tier_names[1:]
        ]

    # -- binding -----------------------------------------------------------
    def _build(self, platform: PlatformModel, w_names: List[str], granularity: int,
               effmlp: List[int]) -> None:
        """The PageMap, engine and policy of a job whose workload list (the
        migration workloads included) is ``w_names``; gates the migration
        workloads closed in ``effmlp`` (effective MLP 0 until there is
        backlog), remembering each one's own."""
        spec = self.spec
        names = platform.tier_names
        self.pagemap = PageMap(names, spec.fast_capacity_pages, decay=spec.hotness_decay)
        wl_names = set(w_names)
        for region in spec.regions:
            if region.workload not in wl_names:
                raise ValueError(
                    f"tiering region tracks unknown workload {region.workload!r}; "
                    f"job workloads: {', '.join(sorted(wl_names))}"
                )
            self.pagemap.add_region(region.workload, region.n_pages, spec.page_bytes,
                                    region.placement, region.pattern)
        self.policy = make_policy(spec.policy, **spec.policy_args)
        # One page's copy = page_bytes of traffic on its slow link, issued
        # as MIGRATE macro-requests of (access_bytes x granularity) each.
        self.engine = MigrationEngine({
            code: math.ceil(spec.page_bytes
                            / (platform.tiers[code].access_bytes * granularity))
            for code in range(1, len(names))
        })
        wi_by_name = {n: i for i, n in enumerate(w_names)}
        self._region_wi = {r.workload: wi_by_name[r.workload] for r in spec.regions}
        self._mig_wi: Dict[int, int] = {
            code: wi_by_name[f"{MIG_PREFIX}{tier}"]
            for code, tier in enumerate(names) if code > 0
        }
        self._mig_effmlp = {wi: effmlp[wi] for wi in self._mig_wi.values()}
        for wi in self._mig_wi.values():
            effmlp[wi] = 0

    def bind(self, sim) -> None:
        """Attach to a constructed :class:`~repro_torch.core.des.
        TieredMemorySim` (its workload list holds
        :meth:`migration_workloads`): resolve the regions, gate the migration
        workloads and write the initial routing into its issue tables."""
        self._build(sim.platform, [w.name for w in sim.workloads], sim.granularity,
                    sim._w_effmlp)
        self._stat_mark = list(sim._stat_completed)
        self._apply_placements(sim)

    def bind_export(self, export: dict, platform: PlatformModel) -> None:
        """Attach to a job's exported state instead of a live sim (the
        batched lane's planning): the export's routing vectors and effective
        MLPs become a bound sim's."""
        self._build(platform, list(export["w_names"]), export["granularity"],
                    export["w_effmlp"])
        for name, wi in self._region_wi.items():
            fr = self.pagemap.regions[name].tier_fractions()
            if export["n_tiers"] == 2:
                frac = float(fr[0])
                export["w_tier_frac"][wi] = [frac, 1.0 - frac]
            else:
                cum, acc = [], 0.0
                for f in fr:
                    acc += float(f)
                    cum.append(acc)
                export["w_tier_frac"][wi] = cumulative_fractions(cum)

    # -- per-window pass ---------------------------------------------------
    def on_window(self, sim) -> bool:
        """One per-window tiering pass: sample accesses into the PageMap,
        drain completed copies, run the policy, re-resolve placements and
        budgets.  Returns True when routing or budgets changed."""
        require(self.pagemap is not None, "tiering-bind",
                "on_window before bind(): the hook has no PageMap yet")
        self._windows += 1
        completed = sim._stat_completed
        deltas = [c - m for c, m in zip(completed, self._stat_mark)]
        self._stat_mark = list(completed)

        # 1. Completed MIGRATE traffic retires jobs and flips pages.
        promoted = demoted = 0
        mig_done: Dict[str, int] = {}
        for code, wi in self._mig_wi.items():
            if deltas[wi]:
                mig_done[sim.platform.tier_names[code]] = deltas[wi]
                p, d = self.engine.on_completions(code, deltas[wi], self.pagemap)
                promoted += p
                demoted += d

        # 2. Demand completions are the sampled access stream that feeds the
        #    hotness tracker.
        for name, wi in self._region_wi.items():
            self.pagemap.record_window(name, deltas[wi])

        # 3. The policy, under the control plane's latest view.
        ctx = PolicyContext(
            window=self._windows,
            tier_names=sim.platform.tier_names,
            engine=self.engine,
            decisions=self._latest_decisions(sim),
            budgets=self._budgets(sim),
        )
        jobs = self.policy.decide(self.pagemap, ctx)
        enqueued = self.engine.enqueue(jobs)
        self.deferred_jobs += ctx.deferred

        # 4. Routing re-resolution and migration issue gating: only a window
        #    that moved routing or re-opened migration issue makes the DES
        #    re-pump its issue path.
        changed = self._apply_placements(sim)
        for code, wi in self._mig_wi.items():
            want = self._mig_effmlp[wi] if self.engine.pending_reqs(code) else 0
            if sim._w_effmlp[wi] != want:
                sim._w_effmlp[wi] = want
                changed = True

        self.window_log.append({
            "window": self._windows,
            "t_ns": sim.now,
            "promoted": promoted,
            "demoted": demoted,
            "enqueued": enqueued,
            "deferred": ctx.deferred,
            "backlog_pages": self.engine.backlog_pages(),
            "migrated_bytes": self.engine.migrated_bytes,
            "mig_reqs_completed": mig_done,
            "fast_fraction": {
                name: self.pagemap.fast_fraction(name) for name in self._region_wi
            },
        })
        return changed

    @staticmethod
    def _latest_decisions(sim) -> Optional[TierDecisions]:
        ds = sim.control.decisions
        if ds and isinstance(ds[-1], TierDecisions):
            return ds[-1]
        return None

    @staticmethod
    def _budgets(sim) -> Optional[Dict[str, int]]:
        budgets = getattr(sim.controller, "migration_budgets", None)
        return budgets() if callable(budgets) else None

    def _apply_placements(self, sim) -> bool:
        """Write each tracked workload's PageMap-derived routing into the
        sim's issue tables (two-tier platforms stay on the single-draw
        ``ddr_fraction`` path) and refold its throttle.  Returns whether any
        routing entry changed."""
        require(self.pagemap is not None, "tiering-bind",
                "_apply_placements before bind(): the hook has no PageMap")
        n = sim._n_tiers
        changed = False
        for name, wi in self._region_wi.items():
            fr = self.pagemap.regions[name].tier_fractions()
            if n == 2:
                frac = float(fr[0])
                if sim._w_frac[wi] != frac:
                    sim._w_frac[wi] = frac
                    sim._w_cum[wi] = None
                    sim._w_placed_slow[wi] = ()
                    sim._recompute_throttle(wi)
                    changed = True
            else:
                acc = 0.0
                cum = []
                for f in fr:
                    acc += float(f)
                    cum.append(acc)
                cum[-1] = float("inf")
                cum = tuple(cum)
                if sim._w_cum[wi] != cum:
                    sim._w_frac[wi] = None
                    sim._w_cum[wi] = cum
                    sim._w_placed_slow[wi] = tuple(i for i in range(1, n) if fr[i] > 0.0)
                    sim._recompute_throttle(wi)
                    changed = True
        return changed

    def summary(self) -> dict:
        """End-of-run summary (pages promoted/demoted, migrated bytes,
        deferrals, final fast fractions) for ``SimResult.tiering``."""
        require(self.pagemap is not None, "tiering-bind",
                "summary() before bind(): the hook has no PageMap")
        return {
            **self.engine.counters(),
            "policy": self.policy.name,
            "windows": self._windows,
            "deferred_jobs": self.deferred_jobs,
            "fast_pages_used": self.pagemap.fast_pages_used(),
            "occupancy": self.pagemap.occupancy(),
            "fast_fraction": {
                name: self.pagemap.fast_fraction(name) for name in self._region_wi
            },
        }
