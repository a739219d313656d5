"""Tiering hook: TieringSpec (picklable config) -> TieringHook (per job).

A copy of ``repro.tiering.hook`` trimmed to what the batched lane needs:

* ``migration_workloads(platform)`` — the per-slow-tier MIGRATE
  pseudo-workloads (``mig-<tier>``) appended to the job's workload list
  (kernel migration daemons: a few cores issuing page-copy traffic).
* ``bind(export, platform)`` — resolve tier codes, build the
  PageMap/engine/policy, write the *initial* PageMap-derived routing into
  the job's exported state and gate the migration workloads closed.
* ``summary()`` — the end-of-run summary of ``SimResult.tiering``.

The reference binds to a live ``TieredMemorySim`` and writes into its issue
tables.  The port has no event DES, so :meth:`TieringHook.bind` works on the
exported state of :func:`repro_torch.core.des.export_state` instead and
leaves it equal to what the reference's bound sim exports.  The scalar
per-window pass (``on_window``) needs the event DES, which is not ported
(ROADMAP queue A, "the scalar DES lane"); the batched lane's twin
:class:`~repro_torch.memsim.batched.tiering.VectorTiering` runs that pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.des import WorkloadSpec
from repro_torch.core.device_model import PlatformModel
from repro_torch.core.invariants import require
from repro_torch.core.littles_law import OpClass
from repro_torch.tiering.engine import MigrationEngine
from repro_torch.tiering.pagemap import HotSetPattern, PageMap
from repro_torch.tiering.policies import make_policy


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
    """Per-job tiering state, bound to the job's exported state."""

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

    def bind(self, export: dict, platform: PlatformModel) -> None:
        """Attach to a job's exported state (its workload list already holds
        :meth:`migration_workloads`): resolve regions, write the initial
        routing vectors and gate the migration workloads closed."""
        spec = self.spec
        names = tuple(export["tier_names"])
        self.pagemap = PageMap(names, spec.fast_capacity_pages, decay=spec.hotness_decay)
        wl_names = set(export["w_names"])
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
        g = export["granularity"]
        self.engine = MigrationEngine({
            code: math.ceil(spec.page_bytes / (platform.tiers[code].access_bytes * g))
            for code in range(1, len(names))
        })
        wi_by_name = {n: i for i, n in enumerate(export["w_names"])}
        self._region_wi = {r.workload: wi_by_name[r.workload] for r in spec.regions}
        self._mig_wi: Dict[int, int] = {
            code: wi_by_name[f"{MIG_PREFIX}{tier}"]
            for code, tier in enumerate(names) if code > 0
        }
        # Gate migration issue closed until there is backlog (effective MLP
        # 0), remembering each pseudo-workload's own.
        self._mig_effmlp = {wi: export["w_effmlp"][wi] for wi in self._mig_wi.values()}
        for wi in self._mig_wi.values():
            export["w_effmlp"][wi] = 0
        self._apply_placements(export)

    def _apply_placements(self, export: dict) -> None:
        """Write each tracked workload's PageMap-derived routing vector into
        the export, as the reference's bound sim exports it: the
        ``ddr_fraction`` pair on two-tier platforms, the fractions implied
        by the cumulative draw boundaries (the last one open) on others."""
        require(self.pagemap is not None, "tiering-bind",
                "_apply_placements before bind(): the hook has no PageMap")
        n = export["n_tiers"]
        for name, wi in self._region_wi.items():
            fr = self.pagemap.regions[name].tier_fractions()
            vec = [0.0] * n
            if n == 2:
                frac = float(fr[0])
                vec[0], vec[1] = frac, 1.0 - frac
            else:
                cum, acc = [], 0.0
                for f in fr:
                    acc += float(f)
                    cum.append(acc)
                prev = 0.0
                for t in range(n):
                    hi = 1.0 if t == n - 1 else min(cum[t], 1.0)
                    vec[t] = max(0.0, hi - prev)
                    prev = hi
            export["w_tier_frac"][wi] = vec

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
