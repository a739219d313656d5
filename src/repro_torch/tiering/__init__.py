"""repro_torch.tiering — page-granularity hotness tracking and migration
(a copy of ``repro.tiering``'s exports that exist in the port).

* :mod:`.pagemap` — page -> tier, per-page hotness with exponential decay
  and a drifting hot-set access pattern;
* :mod:`.policies` — ``static``, ``hotness_lru`` (TPP-style promotion and
  watermark demotion) and ``miku_coordinated`` (the MIKU ladders' migration
  budgets gate the copies);
* :mod:`.engine` — the MigrationEngine: per-slow-tier FIFO copy queues paid
  for by completed MIGRATE requests;
* :mod:`.hook` — the picklable :class:`TieringSpec` a ``SimJob`` carries,
  and the per-job :class:`TieringHook` bound to the job's exported state.

The per-window pass runs on the batched lane
(:class:`repro_torch.memsim.batched.tiering.VectorTiering`).
"""

from repro_torch.tiering.engine import MigrationEngine, MigrationJob
from repro_torch.tiering.hook import RegionSpec, TieringHook, TieringSpec
from repro_torch.tiering.pagemap import HotSetPattern, PageMap, PageRegion
from repro_torch.tiering.policies import (
    POLICIES,
    HotnessLRUPolicy,
    MikuCoordinatedPolicy,
    PolicyContext,
    StaticPolicy,
    make_policy,
)

__all__ = [
    "HotSetPattern",
    "HotnessLRUPolicy",
    "MigrationEngine",
    "MigrationJob",
    "MikuCoordinatedPolicy",
    "POLICIES",
    "PageMap",
    "PageRegion",
    "PolicyContext",
    "RegionSpec",
    "StaticPolicy",
    "TieringHook",
    "TieringSpec",
    "make_policy",
]
