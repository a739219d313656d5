"""The static part of the simulated testbed: workloads, results, exported state.

A copy of what the batched sweep lane needs from ``repro.core.des``:
:class:`WorkloadSpec`, :func:`validate_workloads`, :class:`WorkloadStats`
(with its latency reads), :class:`SimResult` and
:data:`LATENCY_RESERVOIR`, plus :func:`export_state`, the per-workload
constants the reference's ``TieredMemorySim`` derives in its constructor
and exports for array stacking.

The event-driven DES itself (``TieredMemorySim.run``) is not ported: the
port's sweeps run on the window-lockstep fluid engine
(:mod:`repro_torch.memsim.batched`), which reads only these constants.
Open-loop arrivals and fabric hosts are not ported either.  A tiering
hook binds to the export instead of a live sim.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.device_model import PlatformModel, UnknownTierError
from repro_torch.core.littles_law import OpClass, TierCounters, linear_percentile

_DDR, _CXL = 0, 1
_OPS = tuple(OpClass)

#: Bound on a workload's latency sample (the reference DES's reservoir; the
#: exact lane subsamples its full latency vector to this many).
LATENCY_RESERVOIR = 2048


@dataclasses.dataclass
class WorkloadSpec:
    """One co-running benchmark instance (a group of identical cores).

    ``phases`` overrides ``tier`` with cycled (duration_ns, tier) pairs;
    ``dependent`` marks pointer chasing (MLP 1); ``sync`` the lat-share CAS
    loop; ``wss_mb`` with a finite ``llc_alloc_mb`` gives an LLC hit
    probability of min(1, alloc/wss).  ``ddr_fraction`` and ``placement``
    interleave requests across tiers (mutually exclusive).
    """

    name: str
    op: OpClass
    tier: str
    n_cores: int
    #: Outstanding cachelines per core, prefetcher stream depth included.
    mlp: int = 160
    dependent: bool = False
    sync: bool = False
    wss_mb: float = 32768.0
    llc_alloc_mb: float = 0.0
    phases: Optional[Sequence[Tuple[float, str]]] = None
    miku_managed: bool = True
    ddr_fraction: Optional[float] = None
    placement: Optional[Dict[str, float]] = None

    def effective_mlp(self, granularity: int = 1) -> int:
        """Outstanding simulated requests per core (macro-request units)."""
        if self.dependent or self.sync:
            return 1
        return max(1, self.mlp // granularity)


def validate_workloads(
    platform: PlatformModel, workloads: Sequence[WorkloadSpec]
) -> None:
    """Raise :class:`UnknownTierError` for a tier the platform lacks and
    ``ValueError`` for a malformed placement vector."""
    known = platform.tier_names
    for w in workloads:
        if w.placement is not None and w.ddr_fraction is not None:
            raise ValueError(
                f"workload {w.name!r}: placement and ddr_fraction are "
                "mutually exclusive"
            )
        refs = [w.tier]
        if w.phases:
            refs.extend(t for _, t in w.phases)
        if w.placement is not None:
            refs.extend(w.placement)
        for t in refs:
            if t not in known:
                raise UnknownTierError(t, known)
        if w.placement is not None:
            if any(f < 0.0 for f in w.placement.values()):
                raise ValueError(
                    f"workload {w.name!r}: negative placement fraction"
                )
            total = sum(w.placement.values())
            if abs(total - 1.0) > 1e-6:
                raise ValueError(
                    f"workload {w.name!r}: placement fractions sum to "
                    f"{total}, expected 1.0"
                )


@dataclasses.dataclass
class WorkloadStats:
    completed: int = 0
    bytes: float = 0.0
    latency_sum: float = 0.0
    latency_count: int = 0
    latency_samples: List[float] = dataclasses.field(default_factory=list)
    #: (t_ns, bytes completed in the window) for bandwidth over time.
    timeline: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    #: :class:`repro_torch.obs.histogram.LatencyHistogram` over all completed
    #: requests; None unless the job ran with ``latency_hist=True``.
    latency_hist: Optional[object] = None

    def mean_latency_ns(self) -> float:
        return self.latency_sum / max(1, self.latency_count)

    def percentile_ns(self, q: float) -> float:
        """Sample percentile (linear between order statistics); NaN with no
        samples."""
        if not self.latency_samples:
            return float("nan")
        return linear_percentile(sorted(self.latency_samples), q)

    def bandwidth_gbps(self, sim_ns: float) -> float:
        return self.bytes / sim_ns  # B/ns == GB/s


@dataclasses.dataclass
class SimResult:
    sim_ns: float
    stats: Dict[str, WorkloadStats]
    tier_counters: Dict[str, TierCounters]
    tor_peak: int
    tor_occupancy_integral: float  # entry-ns, all tiers
    tor_inserts: int
    #: Per-window tier-addressed decisions
    #: (:class:`~repro_torch.core.controller.TierDecisions`).
    decisions: list
    per_tier_occupancy_integral: Dict[str, float]
    #: Per-window telemetry records (``window_record_jsonable``'s schema);
    #: empty unless the job ran with ``record_windows=True``.
    window_records: List[dict] = dataclasses.field(default_factory=list)
    #: Per-tier latency histograms (keyed by tier name); None unless the job
    #: ran with ``latency_hist=True``.
    tier_latency_hist: Optional[dict] = None
    #: Tiering summary (pages promoted/demoted, migrated bytes, deferrals,
    #: final fast fractions); None unless the job carried a tiering spec.
    tiering: Optional[dict] = None

    def bandwidth(self, name: str) -> float:
        return self.stats[name].bandwidth_gbps(self.sim_ns)

    @property
    def tor_avg_latency_ns(self) -> float:
        """Occupancy / inserts: the paper's ToR-derived service time."""
        return self.tor_occupancy_integral / max(1, self.tor_inserts)


def _tier_fractions(w: WorkloadSpec, names: Tuple[str, ...]) -> List[float]:
    """A workload's static tier-routing vector, as the reference sim routes
    it: the ``ddr_fraction`` pair, the cumulative placement draw, or the
    one-hot of its (phase-0) tier."""
    n = len(names)
    vec = [0.0] * n
    if w.ddr_fraction is not None:
        vec[_DDR] = w.ddr_fraction
        vec[_CXL] = 1.0 - w.ddr_fraction
    elif w.placement is not None:
        # The sim draws against cumulative boundaries (the last one open);
        # export the fractions those boundaries imply.
        cum, acc = [], 0.0
        for t in names:
            acc += w.placement.get(t, 0.0)
            cum.append(acc)
        prev = 0.0
        for t in range(n):
            hi = 1.0 if t == n - 1 else min(cum[t], 1.0)
            vec[t] = max(0.0, hi - prev)
            prev = hi
    else:
        tier0 = w.phases[0][1] if w.phases else w.tier
        vec[names.index(tier0)] = 1.0
    return vec


def export_state(
    platform: PlatformModel,
    workloads: Sequence[WorkloadSpec],
    granularity: int = 4,
    window_ns: float = 20_000.0,
    tiering=None,
) -> dict:
    """The static per-sim state the batched lane stacks, as plain values.

    Equal to ``repro.core.des.TieredMemorySim(platform, workloads,
    granularity=..., window_ns=..., tiering=...).export_state()``, derived
    from the same per-workload loop of the reference's constructor without
    building the event engine (which is not ported).  A tiering hook
    (:class:`repro_torch.tiering.hook.TieringHook`) appends its migration
    workloads and is bound to the export, which then carries the tracked
    workloads' PageMap-derived routing and the migration workloads gated
    closed, as the reference's bound sim exports them.

    Keys: ``tier_names`` / ``st_slots`` / ``pipe`` (the stations are the
    tiers plus one trailing LLC station); ``tor_capacity`` /
    ``irq_capacity`` in macro-request units; per-workload lists ``w_*``:
    service and byte constants per tier, the LLC routing sentinel
    (``w_phit``: 2.0 sync, [0, 1] CAT hit lottery, -1.0 straight to the
    device), the static tier routing ``w_tier_frac`` and the phase schedule
    ``w_phases`` as (duration_ns, tier index) pairs.
    """
    workloads = list(workloads)
    if tiering is not None:
        workloads += tiering.migration_workloads(platform)
    validate_workloads(platform, workloads)
    tiers = platform.tiers
    names = platform.tier_names
    g = max(1, granularity)
    w_g, w_svc, w_bytes, w_llc_svc, w_phit, w_phases = [], [], [], [], [], []
    for w in workloads:
        ge = 1 if (w.dependent or w.sync) else g
        w_g.append(ge)
        w_svc.append([d.service_ns(w.op) * ge for d in tiers])
        w_bytes.append([float(d.access_bytes * ge) for d in tiers])
        w_llc_svc.append(
            platform.llc_service_ns * 2.0 if w.sync
            else platform.llc_service_ns * ge
        )
        if w.sync:
            w_phit.append(2.0)
        elif w.llc_alloc_mb > 0:
            w_phit.append(min(1.0, w.llc_alloc_mb / max(w.wss_mb, 1e-9)))
        else:
            w_phit.append(-1.0)
        w_phases.append(
            [(dur, names.index(t)) for dur, t in w.phases] if w.phases
            else None
        )
    export = {
        "tier_names": list(names),
        "n_tiers": len(tiers),
        "granularity": g,
        "window_ns": window_ns,
        "st_slots": [d.total_slots for d in tiers] + [platform.llc_slots],
        "pipe": [d.pipeline_ns for d in tiers],
        "tor_capacity": max(1, platform.tor_entries // g),
        "irq_capacity": max(1, platform.irq_entries // g),
        "w_names": [w.name for w in workloads],
        "w_op": [_OPS.index(w.op) for w in workloads],
        "w_g": w_g,
        "w_svc": w_svc,
        "w_bytes": w_bytes,
        "w_llc_svc": w_llc_svc,
        "w_phit": w_phit,
        "w_tier_frac": [_tier_fractions(w, names) for w in workloads],
        "w_effmlp": [w.effective_mlp(g) for w in workloads],
        "w_cores": [w.n_cores for w in workloads],
        "w_managed": [w.miku_managed for w in workloads],
        "w_dependent": [bool(w.dependent) for w in workloads],
        "w_sync": [bool(w.sync) for w in workloads],
        "w_phases": w_phases,
    }
    if tiering is not None:
        tiering.bind(export, platform)
    return export
