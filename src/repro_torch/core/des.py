"""Discrete-event simulation of the cores -> IRQ -> ToR -> {DDR, CXL} pipeline.

A port of ``repro.core.des``: the simulated testbed of the paper's two
platforms, with the structures of its root-cause analysis (§4.2):

  * **Cores** with bounded memory-level parallelism issue requests in a
    closed loop (``dependent`` lat-test workloads at MLP 1);
  * the **IRQ**, a shared finite FIFO staging queue: only its head may
    dispatch, and when full it back-pressures every core;
  * the **ToR**, a finite shared pool of tracking entries held from
    dispatch to data return, so slow-tier requests with 8-10x residency
    monopolise it (the unfair queuing);
  * one **device** station per platform tier (``c`` deterministic servers,
    an unbounded internal queue whose requests hold ToR entries) and an
    optional **LLC** station in front of them (hits still hold entries).

MIKU attaches through :class:`~repro_torch.core.substrate.ControlLoop`:
every ``window_ns`` the loop pulls per-tier counter deltas and applies the
returned per-tier core cap and token rate to slow-tier-bound workloads.

:class:`TieredMemorySim` is the reference's flat-station engine (requests
in parallel arrays recycled through a free-list, heap events packed into
one integer, a latency reservoir on its own RNG) with the same draws in
the same order, so its results equal the reference's bit for bit.  It
carries the reference's routed fabric (a platform's port-bearing links
become hop stations with an entry limit and head-of-line backpressure,
and ``control_scope="edge"`` addresses windows and decisions to control
edges) and its open-loop arrivals (a workload with an ``arrival`` spec
issues from a generated backlog).  With no fabric, an all-transparent
one and no arrival spec, every branch of both is dead and the event chain
is the flat-station one.  ``sanitize=`` threads the runtime sanitizer
(:mod:`repro_torch.analysis.sanitizer`) through the admission and retire
paths and checks its invariants at every window; ``trace=`` samples every
Nth ToR admission into span chains (:mod:`repro_torch.obs.trace`).  Neither
draws a random number, so both leave the results as they are.
:func:`export_state` derives the static state the batched lane stacks
without building the sim.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.controller import TierDecisions
from repro_torch.core.device_model import PlatformModel, UnknownTierError
from repro_torch.core.invariants import InvariantViolation, sanitize_enabled
from repro_torch.core.littles_law import (
    OpClass,
    TierCounters,
    TierWindow,
    linear_percentile,
)
from repro_torch.core.substrate import (
    ControlLoop,
    TierSetWindowedCounters,
    window_record_jsonable,
)
from repro_torch.obs.histogram import LatencyHistogram, merge_all
from repro_torch.obs.metrics import default_registry

# Event kinds.  Heap entries are (time, packed) with packed = (seq <<
# _SEQ_SHIFT) | (kind << _KIND_SHIFT) | arg: seq in the high bits keeps
# strict FIFO order among equal timestamps.
_EV_COMPLETE = 0  # service slot frees; data starts its return flight
_EV_PHASE = 1
_EV_WINDOW = 2
_EV_TOKEN = 3
_EV_RETIRE = 4  # data returned: the ToR entry frees, the core slot recycles
_EV_ARRIVAL = 5  # open-loop arrival: one generated request joins its backlog
_KIND_SHIFT = 32
_SEQ_SHIFT = 36
_ARG_MASK = 0xFFFFFFFF

_DDR, _CXL = 0, 1
_OPS = tuple(OpClass)

#: Bound on a workload's latency reservoir (the exact lane subsamples its
#: full latency vector to this many).
LATENCY_RESERVOIR = 2048


@dataclasses.dataclass
class WorkloadSpec:
    """One co-running benchmark instance (a group of identical cores).

    ``phases`` overrides ``tier`` with cycled (duration_ns, tier) pairs;
    ``dependent`` marks pointer chasing (MLP 1); ``sync`` the lat-share CAS
    loop; ``wss_mb`` with a finite ``llc_alloc_mb`` gives an LLC hit
    probability of min(1, alloc/wss).  ``ddr_fraction`` and ``placement``
    interleave requests across tiers (mutually exclusive).  ``host`` picks
    the fabric host whose routes the requests take (default the topology's
    first host; None on a platform without a fabric).  ``arrival`` (a
    :class:`repro_torch.workload.ArrivalSpec`) makes the workload open-loop:
    its cores issue only while its arrival backlog holds a request, and a
    request's latency runs from its generation.
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
    host: Optional[str] = None
    arrival: Optional[object] = None

    def effective_mlp(self, granularity: int = 1) -> int:
        """Outstanding simulated requests per core (macro-request units)."""
        if self.dependent or self.sync:
            return 1
        return max(1, self.mlp // granularity)


def validate_workloads(
    platform: PlatformModel, workloads: Sequence[WorkloadSpec]
) -> None:
    """Raise :class:`UnknownTierError` for a tier (or fabric host) the
    platform lacks and ``ValueError`` for a malformed placement vector, a
    host on a fabric-less platform or an arrival that is no spec."""
    known = platform.tier_names
    fabric = getattr(platform, "fabric", None)
    for w in workloads:
        if w.host is not None:
            if fabric is None:
                raise ValueError(
                    f"workload {w.name!r}: host {w.host!r} set but the "
                    "platform carries no fabric topology"
                )
            if w.host not in fabric.hosts:
                raise UnknownTierError(
                    w.host, tuple(fabric.hosts), kind="fabric host",
                    known_desc="topology hosts",
                )
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
        if w.arrival is not None and not hasattr(w.arrival, "kind"):
            raise ValueError(
                f"workload {w.name!r}: arrival= expects a "
                "repro.workload.arrivals.ArrivalSpec, got "
                f"{type(w.arrival).__name__}"
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
    #: Per port-bearing link (keyed by link name): stall events, peak entry
    #: occupancy and the entry limit (macro-request units); None unless some
    #: route crosses a port.
    fabric: Optional[dict] = None
    #: Sanitizer summary (windows checked, per-tier admissions and retires,
    #: violations); None unless the sim ran with ``sanitize``.
    sanitizer: Optional[dict] = None
    #: Per open-loop workload: generated, issued, shed and the final backlog
    #: (generated == issued + shed + backlog); None without an arrival spec.
    arrival: Optional[dict] = None
    #: Sampled request traces (``RequestTracer.run_payload``); None unless
    #: the sim ran with ``trace``.
    trace: Optional[dict] = None
    #: Wall-clock phase profile (setup, event loop, window passes); None
    #: unless the scalar job ran with ``profile=True``.
    profile: Optional[dict] = None

    def bandwidth(self, name: str) -> float:
        return self.stats[name].bandwidth_gbps(self.sim_ns)

    def total_bandwidth(self, tier: Optional[str] = None) -> float:
        """Every workload's bandwidth summed (GB/s); ``tier`` is unused, as
        in the reference."""
        return sum(s.bandwidth_gbps(self.sim_ns) for s in self.stats.values())

    @property
    def tor_avg_latency_ns(self) -> float:
        """Occupancy / inserts: the paper's ToR-derived service time."""
        return self.tor_occupancy_integral / max(1, self.tor_inserts)


class TieredMemorySim:
    """The event engine.  Deterministic given a seed.

    A :class:`~repro_torch.core.substrate.ControlLoop` substrate
    (``clock_ns`` / ``counters_delta`` / ``apply``): the loop owns the MIKU
    windowing, and the sim schedules its boundaries as events.  A tiering
    hook (:class:`repro_torch.tiering.hook.TieringHook`, duck-typed)
    contributes its migration workloads up front and runs its per-window
    pass after each window's decision.  ``control_scope="edge"`` addresses
    windows and decisions to control edges (each slow tier's device edge,
    then each port-bearing link, as ``repro_torch.fabric.edge_names``
    orders them) instead of slow tiers.
    """

    def __init__(
        self,
        platform: PlatformModel,
        workloads: Sequence[WorkloadSpec],
        *,
        seed: int = 0,
        granularity: int = 4,
        window_ns: float = 20_000.0,
        controller=None,
        latency_reservoir: int = LATENCY_RESERVOIR,
        record_windows: bool = False,
        tiering=None,
        control_scope: str = "tier",
        sanitize=None,
        latency_hist: bool = False,
        trace=0,
        profiler=None,
    ):
        self.platform = platform
        self.workloads = list(workloads)
        self._tiering = tiering
        if tiering is not None:
            self.workloads.extend(tiering.migration_workloads(platform))
        validate_workloads(platform, self.workloads)
        # Tier code == position in platform.tiers (fast tier first); the LLC
        # is one extra station after the tiers.
        tiers = platform.tiers
        self._tier_names = platform.tier_names
        self._n_tiers = len(tiers)
        self._tier_idx = {t: i for i, t in enumerate(self._tier_names)}
        self._llc = self._n_tiers
        self.rng = random.Random(seed)
        # The latency reservoir draws from its own stream, so sampling never
        # perturbs the simulated system.
        self._res_rng = random.Random((seed << 16) ^ 0x5EED)
        self._res_random = self._res_rng.random
        self._reservoir_k = latency_reservoir
        # One simulated request covers ``granularity`` cachelines (dependent
        # and sync workloads always one).
        self.granularity = max(1, granularity)
        self.window_ns = window_ns
        self.controller = controller
        self._record_windows = record_windows
        self.control = ControlLoop(self, controller, window_ns=window_ns,
                                   record=record_windows)

        self.now = 0.0
        self._seq = 0
        self._heap: List[Tuple[float, int]] = []

        # Stations [tier 0, ..., tier n-1, llc]: slot counts, busy counts and
        # FIFO queues of request ids (queued requests hold ToR entries).
        self._st_slots = [d.total_slots for d in tiers] + [platform.llc_slots]
        self._st_busy = [0] * (self._n_tiers + 1)
        self._st_q: List[deque] = [deque() for _ in range(self._n_tiers + 1)]

        # Shared queues, in macro-request units.
        self.tor_capacity = max(1, platform.tor_entries // self.granularity)
        self.tor_used = 0
        self.tor_peak = 0
        self.irq: deque = deque()
        self.irq_capacity = max(1, platform.irq_entries // self.granularity)

        # Request pool: parallel arrays recycled through a free-list.
        self._r_wl: List[int] = []
        self._r_gi: List[int] = []
        self._r_tier: List[int] = []
        self._r_station: List[int] = []
        self._r_tissue: List[float] = []
        self._r_ttor: List[float] = []
        self._r_service: List[float] = []
        self._r_free: List[int] = []
        # 1 iff the rid is live in the tracer: one append per allocated rid,
        # kept with tracing off too, so the hooks' guard is an index.
        self._r_traced = bytearray()

        # Round-robin arbitration over every (workload, core) pair: the IRQ
        # admits fairly per core, so its inflow mix follows core counts, not
        # completion rates (the paper's collapse).
        self._rr_wi: List[int] = []
        self._rr_core: List[int] = []
        self._rr_ptr = 0
        self._out: List[int] = []  # outstanding per global core index

        n = len(self.workloads)
        g = self.granularity

        # Per-workload constants (indexed by wi).
        self._w_g: List[int] = []
        self._w_svc: List[Tuple[float, ...]] = []
        self._w_bytes: List[Tuple[float, ...]] = []
        self._w_llc_svc: List[float] = []
        self._w_phit: List[float] = []  # 2.0 sync, [0, 1] CAT lottery, -1.0 none
        self._w_frac: List[Optional[float]] = []
        #: Cumulative tier-probability vector of a placement (the last entry
        #: +inf, so the routing scan always ends), or None.
        self._w_cum: List[Optional[Tuple[float, ...]]] = []
        #: Slow tier codes a placement vector puts mass on.
        self._w_placed_slow: List[Tuple[int, ...]] = []
        self._w_managed: List[bool] = []
        self._w_op: List[int] = []
        self._w_effmlp: List[int] = []

        # Phase and throttle state.  ``apply`` writes one (core cap, rate)
        # per tier code; ``_recompute_throttle`` folds it into each
        # workload's effective cap (``_limit``) and rate.
        self._phase_tier: List[int] = []
        self._phase_seq: List[Optional[List[Tuple[float, int]]]] = []
        self._phase_idx: List[int] = [0] * n
        self._tier_cap: List[Optional[int]] = [None] * self._n_tiers
        self._tier_rate: List[float] = [1.0] * self._n_tiers
        self._rate: List[float] = [1.0] * n
        self._tokens: List[float] = [0.0] * n
        self._last_refill: List[float] = [0.0] * n
        self._token_wait: List[bool] = [False] * n
        self._limit: List[Optional[int]] = [None] * n
        self._unthrottled: List[bool] = [True] * n

        for wi, w in enumerate(self.workloads):
            ge = 1 if (w.dependent or w.sync) else g
            self._w_g.append(ge)
            self._w_svc.append(tuple(d.service_ns(w.op) * ge for d in tiers))
            self._w_bytes.append(tuple(float(d.access_bytes * ge) for d in tiers))
            self._w_llc_svc.append(
                platform.llc_service_ns * 2.0 if w.sync
                else platform.llc_service_ns * ge
            )
            if w.sync:
                self._w_phit.append(2.0)
            elif w.llc_alloc_mb > 0:
                self._w_phit.append(min(1.0, w.llc_alloc_mb / max(w.wss_mb, 1e-9)))
            else:
                self._w_phit.append(-1.0)
            if w.placement is not None:
                cum: List[float] = []
                acc = 0.0
                for t in self._tier_names:
                    acc += w.placement.get(t, 0.0)
                    cum.append(acc)
                cum[-1] = float("inf")
                self._w_frac.append(None)
                self._w_cum.append(tuple(cum))
                self._w_placed_slow.append(tuple(
                    i for i, t in enumerate(self._tier_names)
                    if i > 0 and w.placement.get(t, 0.0) > 0.0
                ))
            else:
                self._w_frac.append(w.ddr_fraction)
                self._w_cum.append(None)
                self._w_placed_slow.append(())
            self._w_managed.append(w.miku_managed)
            self._w_op.append(_OPS.index(w.op))
            self._w_effmlp.append(w.effective_mlp(g))
            if w.phases:
                self._phase_seq.append([(dur, self._tier_idx[t]) for dur, t in w.phases])
            else:
                self._phase_seq.append(None)
            tier0 = w.phases[0][1] if w.phases else w.tier
            self._phase_tier.append(self._tier_idx[tier0])
            for core in range(w.n_cores):
                self._rr_wi.append(wi)
                self._rr_core.append(core)
                self._out.append(0)

        # Open-loop arrivals: a workload with an ``arrival`` spec is fed by a
        # generator (its own seeded stream, never ``self.rng``) through
        # _EV_ARRIVAL events into a backlog deque of (t_generated, key)
        # pairs; its cores issue only while the backlog holds a request.
        self._w_open: List[bool] = []
        self._arr_q: List[deque] = []
        self._arr_qlimit: List[Optional[int]] = []
        self._arr_gen = [0] * n
        self._arr_issued = [0] * n
        self._arr_shed = [0] * n
        self._arr_iter: List[Optional[object]] = []
        self._arr_pending: List[Optional[Tuple[float, float]]] = []
        for wi, w in enumerate(self.workloads):
            arr = w.arrival
            self._w_open.append(arr is not None)
            self._arr_q.append(deque())
            if arr is not None:
                from repro_torch.workload.arrivals import arrival_iter

                it = arrival_iter(arr, stream_seed=(seed << 8) ^ wi)
                self._arr_qlimit.append(arr.queue_limit)
                self._arr_iter.append(it)
                self._arr_pending.append(next(it, None))
            else:
                self._arr_qlimit.append(None)
                self._arr_iter.append(None)
                self._arr_pending.append(None)
        self._open_active = any(self._w_open)
        self._arrival_log: List[dict] = []
        self._arr_gen_mark = [0] * n
        self._arr_issued_mark = [0] * n
        self._arr_shed_mark = [0] * n

        # Return-flight latency per tier.
        self._pipe = tuple(d.pipeline_ns for d in tiers)

        # The routed fabric (``platform.fabric``, duck-typed): each
        # port-bearing link is a hop station after the LLC with an entry
        # limit.  A routed request visits its hops in order before its
        # device station, holding its ToR entry throughout, and a full
        # downstream port stalls it in place (see the ``_hop_*`` methods).
        # With no hop on any route ``_fabric_active`` is False and every
        # fabric branch is dead.
        fabric = getattr(platform, "fabric", None)
        links = tuple(fabric.station_links) if fabric is not None else ()
        self._link_names = tuple(l.name for l in links)
        link0 = self._llc + 1  # first hop-station code
        self._link0 = link0
        n_st = link0 + len(links)
        self._st_slots.extend(l.port_slots for l in links)
        self._st_busy.extend(0 for _ in links)
        self._st_q.extend(deque() for _ in links)
        # Per-hop port state by station code (entries below link0 pad):
        # ``_hop_occ`` counts entries held at the port (queued, in service
        # or stall-held); ``_hop_stall`` queues (rid, upstream station)
        # waiters, upstream -1 for a request stalled at admission.
        self._hop_limit = [0] * n_st
        self._hop_occ = [0] * n_st
        self._hop_svc = [0.0] * n_st
        self._hop_stall: List[deque] = [deque() for _ in range(n_st)]
        self._hop_stall_events = [0] * n_st
        self._hop_peak_occ = [0] * n_st
        for i, link in enumerate(links):
            st = link0 + i
            self._hop_limit[st] = max(1, link.queue_entries // self.granularity)
            self._hop_svc[st] = link.service_ns
        # Per-(workload, tier) hop paths from the workload host's routes.
        if fabric is not None:
            link_st = {l.name: link0 + i for i, l in enumerate(links)}
            self._w_hops = [
                tuple(
                    tuple(link_st[l.name]
                          for l in fabric.route(
                              w.host if w.host is not None else fabric.hosts[0],
                              t).hops)
                    for t in self._tier_names
                )
                for w in self.workloads
            ]
        else:
            self._w_hops = [((),) * self._n_tiers for _ in self.workloads]
        self._fabric_active = any(any(per_tier) for per_tier in self._w_hops)
        # Per-request hop state in dicts: only routed requests pay.
        self._hop_path: Dict[int, Tuple[int, ...]] = {}
        self._hop_idx: Dict[int, int] = {}
        self._hop_t: Dict[int, float] = {}  # hop-entry time (link edges)
        self._dev_t: Dict[int, float] = {}  # device-entry time (device edges)
        self._fabric_log: List[dict] = []
        self._n_windows = 0

        # Control scope: "tier" addresses windows and decisions to slow
        # tiers; "edge" to control edges, one device edge per slow tier
        # (named by the tier), then one link edge per port-bearing link.
        # With no links both schedules are one and the scopes bit-identical.
        if control_scope not in ("tier", "edge"):
            raise ValueError(
                f"unknown control_scope {control_scope!r}; "
                "expected 'tier' or 'edge'"
            )
        self._edge_scope = control_scope == "edge"
        self._edge_names = tuple(self._tier_names[1:]) + self._link_names
        self._edge_station = tuple(
            list(range(1, self._n_tiers)) + list(range(link0, link0 + len(links)))
        )
        self._n_edges = len(self._edge_station)
        # Per-link decision state by station code, written by ``apply``
        # under edge scope and folded in by ``_recompute_throttle``.
        self._link_cap: List[Optional[int]] = [None] * n_st
        self._link_rate: List[float] = [1.0] * n_st
        # Edge window accumulators (edge scope): a device edge meters its
        # device-side residency, a link edge its port residency.
        self._e_ins = [0] * self._n_edges
        self._e_occ = [0.0] * self._n_edges
        self._e_cls = [[0] * len(_OPS) for _ in range(self._n_edges)]

        # Accounting: flat per-workload accumulators, materialized into
        # WorkloadStats at the end of the run.
        self.stats: Dict[str, WorkloadStats] = {w.name: WorkloadStats() for w in self.workloads}
        self._stat_completed = [0] * n
        self._stat_bytes = [0.0] * n
        self._stat_latsum = [0.0] * n
        self._stat_latcnt = [0] * n
        self._stat_res: List[List[float]] = [[] for _ in range(n)]

        # Tier counters: flat accumulators, copied into the cumulative
        # counters the control loop reads window deltas from.  Under edge
        # scope the names are [fast tier, *edges] (device edges named by
        # their tier, so with no links they are the tier names).
        cnames = ((self._tier_names[0],) + self._edge_names if self._edge_scope
                  else self._tier_names)
        self._counters = TierSetWindowedCounters(names=cnames)
        self.tier_counters = {t: self._counters.tiers[i] for i, t in enumerate(cnames)}
        self._tc_ins = [0] * self._n_tiers
        self._tc_occ = [0.0] * self._n_tiers
        self._tc_cls = [[0] * len(_OPS) for _ in range(self._n_tiers)]

        # Occupancy integrals as per-request residencies at retire time
        # (sum of residency == integral of occupancy), keyed by the request's
        # tier (LLC hits hold ToR entries and count toward their tier);
        # requests in flight at the horizon are charged at the end of run().
        self.tor_occupancy_integral = 0.0
        self._occ_tier = [0.0] * self._n_tiers
        self.tor_inserts = 0
        #: Requests holding ToR entries per tier, kept only for the
        #: sanitizer (which re-derives conservation from it).
        self._tier_inflight = [0] * self._n_tiers
        self._timeline_bucket_ns = window_ns
        self._timeline_acc = [0.0] * n
        self._timeline_next = self._timeline_bucket_ns

        # ``latency_hist``: every retire latency into one flat list per
        # (workload, tier), bucketed at the end of the run; the workload,
        # tier and per-window histograms are exact merges of these.
        self._prof = profiler
        if latency_hist:
            self._lat_wt: Optional[List[List[List[float]]]] = [
                [[] for _ in range(self._n_tiers)] for _ in self.workloads
            ]
            self._lat_ap: Optional[List[list]] = [
                [lst.append for lst in row] for row in self._lat_wt
            ]
        else:
            self._lat_wt = None
            self._lat_ap = None
        #: (window index, t_ns, per-(workload, tier) sample counts) at each
        #: window boundary.
        self._hist_marks: List[Tuple[int, float, List[List[int]]]] = []

        # ``sanitize``: None reads REPRO_SANITIZE; True or "raise" checks
        # every window and raises, "record" collects the violations into
        # SimResult.sanitizer.  ``trace``: every Nth ToR admission (an int N
        # or a TraceConfig) keyed on ``tor_inserts``, so it draws nothing.
        # Both are imported only when asked for.
        if sanitize is None:
            sanitize = sanitize_enabled()
        if sanitize:
            from repro_torch.analysis.sanitizer import DesSanitizer

            mode = sanitize if isinstance(sanitize, str) else "raise"
            self._san: Optional[DesSanitizer] = DesSanitizer(self._n_tiers, mode=mode)
            self._counters.attach_sanitizer(self._san.check_counter_deltas)
        else:
            self._san = None
        if trace:
            from repro_torch.obs.trace import RequestTracer, TraceConfig

            cfg = trace if isinstance(trace, TraceConfig) else TraceConfig(
                sample_every=int(trace))
            self._tracer: Optional[RequestTracer] = RequestTracer(
                cfg,
                workload_names=[w.name for w in self.workloads],
                station_names=list(self._tier_names) + ["llc"] + list(self._link_names),
                tier_names=list(self._tier_names),
            )
            self._tr_every = cfg.sample_every
        else:
            self._tracer = None
            self._tr_every = 0

        if tiering is not None:
            tiering.bind(self)

    # -- substrate protocol ---------------------------------------------------
    @property
    def clock_ns(self) -> float:
        return self.now

    def export_state(self) -> dict:
        """Static per-sim state as plain values, read-only: what
        :func:`export_state` derives without building the sim (the batched
        lane stacks it), with a bound tiering hook's live routing."""
        n_tiers = self._n_tiers
        fracs: List[List[float]] = []
        for wi, w in enumerate(self.workloads):
            vec = [0.0] * n_tiers
            if self._w_frac[wi] is not None:
                vec[_DDR] = self._w_frac[wi]
                vec[_CXL] = 1.0 - self._w_frac[wi]
            elif self._w_cum[wi] is not None:
                # A bound tiering hook re-resolves the routing into _w_cum.
                vec = cumulative_fractions(self._w_cum[wi])
            else:
                vec[self._phase_tier[wi]] = 1.0
            fracs.append(vec)
        return {
            "tier_names": list(self._tier_names),
            "n_tiers": n_tiers,
            "granularity": self.granularity,
            "window_ns": self.window_ns,
            "st_slots": list(self._st_slots),
            "pipe": list(self._pipe),
            "tor_capacity": self.tor_capacity,
            "irq_capacity": self.irq_capacity,
            "w_names": [w.name for w in self.workloads],
            "w_op": list(self._w_op),
            "w_g": list(self._w_g),
            "w_svc": [list(s) for s in self._w_svc],
            "w_bytes": [list(b) for b in self._w_bytes],
            "w_llc_svc": list(self._w_llc_svc),
            "w_phit": list(self._w_phit),
            "w_tier_frac": fracs,
            "w_effmlp": list(self._w_effmlp),
            "w_cores": [w.n_cores for w in self.workloads],
            "w_managed": list(self._w_managed),
            "w_dependent": [bool(w.dependent) for w in self.workloads],
            "w_sync": [bool(w.sync) for w in self.workloads],
            "w_phases": [list(seq) if seq is not None else None for seq in self._phase_seq],
        }

    def _materialize_counters(self) -> None:
        if self._edge_scope:
            # [fast tier, *edges]: index 0 from the fast tier's
            # accumulators, the rest from the edge accumulators.
            tiers = self._counters.tiers
            fast = tiers[0]
            fast.inserts = self._tc_ins[0]
            fast.occupancy_time = self._tc_occ[0]
            cls0 = self._tc_cls[0]
            for i, op in enumerate(_OPS):
                fast.class_counts[op] = cls0[i]
            for e in range(self._n_edges):
                tc = tiers[1 + e]
                tc.inserts = self._e_ins[e]
                tc.occupancy_time = self._e_occ[e]
                cls = self._e_cls[e]
                for i, op in enumerate(_OPS):
                    tc.class_counts[op] = cls[i]
            return
        for code, tc in enumerate(self._counters.tiers):
            tc.inserts = self._tc_ins[code]
            tc.occupancy_time = self._tc_occ[code]
            cls = self._tc_cls[code]
            for i, op in enumerate(_OPS):
                tc.class_counts[op] = cls[i]

    def counters_delta(self) -> TierWindow:
        self._materialize_counters()
        return self._counters.delta()

    def apply(self, decision) -> None:
        """Throttle slow-tier-bound workloads per the window's decision: a
        :class:`~repro_torch.core.controller.TierDecisions` sets each slow
        tier's core cap and token rate (platform slow-tier order); a plain
        :class:`~repro_torch.core.controller.Decision` broadcasts to every
        slow tier.  Under edge scope the decisions come in edge order: a
        device edge's land on its tier, a link edge's on its port."""
        n = self._n_tiers
        if isinstance(decision, TierDecisions):
            ds = decision.decisions
            if self._edge_scope:
                if len(ds) != self._n_edges:
                    raise ValueError(
                        f"edge-addressed decision has {len(ds)} edge(s); "
                        f"platform has {self._n_edges} control edge(s)"
                    )
                for e, d in enumerate(ds):
                    st = self._edge_station[e]
                    if st < n:
                        self._tier_cap[st] = d.max_concurrency
                        self._tier_rate[st] = d.rate_factor
                    else:
                        self._link_cap[st] = d.max_concurrency
                        self._link_rate[st] = d.rate_factor
            elif len(ds) != n - 1:
                raise ValueError(
                    f"tier-addressed decision has {len(ds)} tier(s); "
                    f"platform has {n - 1} slow tier(s)"
                )
            else:
                for code in range(1, n):
                    d = ds[code - 1]
                    self._tier_cap[code] = d.max_concurrency
                    self._tier_rate[code] = d.rate_factor
        else:
            for code in range(1, n):
                self._tier_cap[code] = decision.max_concurrency
                self._tier_rate[code] = decision.rate_factor
        # Refill and pump after each workload's recompute, not once after
        # the loop: the issue path draws from the sim RNG, and this order of
        # draws is the one the golden traces pin.
        for wi in range(len(self.workloads)):
            if not self._w_managed[wi]:
                continue
            self._recompute_throttle(wi)
            self._fill_irq()
            self._pump()

    @property
    def decisions(self) -> list:
        return self.control.decisions

    # -- throttle cache -------------------------------------------------------
    def _touched_slow(self, wi: int) -> Tuple[int, ...]:
        """Slow tier codes this workload currently sends traffic to (every
        tier after the first is slow)."""
        frac = self._w_frac[wi]
        if frac is not None:
            return (_CXL,) if frac < 1.0 else ()
        if self._w_cum[wi] is not None:
            return self._w_placed_slow[wi]
        t = self._phase_tier[wi]
        return (t,) if t != _DDR else ()

    def _recompute_throttle(self, wi: int) -> None:
        """Fold the per-tier decision state into this workload's effective
        core cap and rate: the most restrictive over the slow tiers it
        touches."""
        codes = self._touched_slow(wi)
        if not codes or not self._w_managed[wi]:
            self._limit[wi] = None
            self._unthrottled[wi] = True
            return
        cap: Optional[int] = None
        rate = 1.0
        for c in codes:
            tc = self._tier_cap[c]
            if tc is not None and (cap is None or tc < cap):
                cap = tc
            tr = self._tier_rate[c]
            if tr < rate:
                rate = tr
        if self._fabric_active:
            # A workload also obeys the link edges on its routes to the slow
            # tiers it touches (left unrestricted under tier scope).
            w_hops = self._w_hops[wi]
            for c in codes:
                for st in w_hops[c]:
                    lc = self._link_cap[st]
                    if lc is not None and (cap is None or lc < cap):
                        cap = lc
                    lr = self._link_rate[st]
                    if lr < rate:
                        rate = lr
        self._limit[wi] = cap
        self._rate[wi] = rate
        self._unthrottled[wi] = rate >= 1.0

    # -- fabric hop stations --------------------------------------------------
    # A routed request admitted to the ToR crosses its hops in route order
    # before its tier's device station, holding its ToR entry throughout.
    # It moves onto a hop only into a free port entry; otherwise it stalls
    # in place: at admission holding only its ToR entry, or mid-route
    # holding its upstream hop's server slot (head-of-line backpressure)
    # until the downstream port frees an entry.

    def _hop_admit(self, rid: int, hops: Tuple[int, ...]) -> None:
        """Route a freshly admitted request onto its first hop, or stall it
        at the ingress port."""
        self._hop_path[rid] = hops
        first = hops[0]
        if self._hop_occ[first] < self._hop_limit[first]:
            self._hop_idx[rid] = 0
            self._hop_enter(rid, first)
        else:
            self._hop_idx[rid] = -1  # not on the fabric yet
            self._hop_stall[first].append((rid, -1))
            self._hop_stall_events[first] += 1
            tr = self._tracer
            if tr is not None and self._r_traced[rid]:
                tr.stall(rid, first, self.now)

    def _hop_enter(self, rid: int, station: int) -> None:
        """Take one port entry at ``station`` and start (or queue for) its
        service: the link's per-cacheline time times the request's size."""
        occ = self._hop_occ[station] + 1
        self._hop_occ[station] = occ
        if occ > self._hop_peak_occ[station]:
            self._hop_peak_occ[station] = occ
        self._hop_t[rid] = self.now
        self._r_station[rid] = station
        service = self._hop_svc[station] * self._w_g[self._r_wl[rid]]
        self._r_service[rid] = service
        tr = self._tracer
        if tr is not None and self._r_traced[rid]:
            tr.station_enter(rid, station, self.now)
        if self._st_busy[station] < self._st_slots[station]:
            self._st_busy[station] += 1
            self._push(self.now + service, _EV_COMPLETE, rid)
        else:
            self._st_q[station].append(rid)

    def _hop_complete(self, rid: int, station: int) -> None:
        """Service done at a hop: go on to the next hop or the device,
        unless the downstream port is full; then stall holding this hop's
        server slot."""
        tr = self._tracer
        if tr is not None and self._r_traced[rid]:
            tr.service_done(rid, station, self.now, self._r_service[rid])
        hops = self._hop_path[rid]
        i = self._hop_idx[rid] + 1
        if i < len(hops):
            nxt = hops[i]
            if self._hop_occ[nxt] >= self._hop_limit[nxt]:
                self._hop_stall[nxt].append((rid, station))
                self._hop_stall_events[nxt] += 1
                if tr is not None and self._r_traced[rid]:
                    tr.stall(rid, nxt, self.now)
                return
            self._hop_leave(rid, station)
            self._hop_idx[rid] = i
            self._hop_enter(rid, nxt)
            return
        # Last hop done: leave the fabric for the tier's device station.
        self._hop_leave(rid, station)
        del self._hop_path[rid], self._hop_idx[rid]
        tier = self._r_tier[rid]
        if self._edge_scope:
            self._dev_t[rid] = self.now
        self._r_station[rid] = tier
        service = self._w_svc[self._r_wl[rid]][tier]
        self._r_service[rid] = service
        if tr is not None and self._r_traced[rid]:
            tr.station_enter(rid, tier, self.now)
        if self._st_busy[tier] < self._st_slots[tier]:
            self._st_busy[tier] += 1
            self._push(self.now + service, _EV_COMPLETE, rid)
        else:
            self._st_q[tier].append(rid)

    def _hop_leave(self, rid: int, station: int) -> None:
        """Free the server slot (starting the next queued request) and the
        port entry at ``station``, and wake stalled waiters into it."""
        q = self._st_q[station]
        if q:
            nxt = q.popleft()
            self._push(self.now + self._r_service[nxt], _EV_COMPLETE, nxt)
        else:
            self._st_busy[station] -= 1
        self._hop_occ[station] -= 1
        if self._edge_scope:
            e = self._n_tiers - 1 + (station - self._link0)
            self._e_ins[e] += 1
            self._e_occ[e] += self.now - self._hop_t[rid]
            self._e_cls[e][self._w_op[self._r_wl[rid]]] += 1
        del self._hop_t[rid]
        if self._hop_stall[station]:
            self._hop_unstall(station)

    def _hop_unstall(self, station: int) -> None:
        """Admit stalled waiters into free entries at ``station``; waking a
        mid-route waiter frees its upstream slot, which may cascade."""
        stall = self._hop_stall[station]
        while stall and self._hop_occ[station] < self._hop_limit[station]:
            rid, upstream = stall.popleft()
            if upstream >= 0:
                self._hop_idx[rid] += 1
                self._hop_leave(rid, upstream)
            else:  # admission stall: its first entry onto the fabric
                self._hop_idx[rid] = 0
            self._hop_enter(rid, station)

    # -- event plumbing -------------------------------------------------------
    def _push(self, t: float, kind: int, arg: int) -> None:
        self._seq += 1
        heapq.heappush(self._heap,
                       (t, (self._seq << _SEQ_SHIFT) | (kind << _KIND_SHIFT) | arg))

    # -- issue path -----------------------------------------------------------
    def _take_token(self, wi: int, cost: float) -> bool:
        """Token bucket in request-cost units, refilled at the rate factor
        (reached only when the workload is rate-throttled)."""
        rate = self._rate[wi]
        dt = self.now - self._last_refill[wi]
        self._tokens[wi] = min(cost * 4.0, self._tokens[wi] + dt * rate)
        self._last_refill[wi] = self.now
        if self._tokens[wi] >= cost:
            self._tokens[wi] -= cost
            return True
        if not self._token_wait[wi]:
            self._token_wait[wi] = True
            wait = (cost - self._tokens[wi]) / max(rate, 1e-6)
            self._push(self.now + wait, _EV_TOKEN, wi)
        return False

    def _fill_irq(self) -> None:
        """Round-robin core arbitration into free IRQ space: every core with
        MLP headroom re-attempts continuously."""
        irq = self.irq
        cap = self.irq_capacity
        if len(irq) >= cap:
            return
        rr_wi, rr_core = self._rr_wi, self._rr_core
        n = len(rr_wi)
        ptr = self._rr_ptr
        out = self._out
        effmlp, limit = self._w_effmlp, self._limit
        frac_of, cur_tier = self._w_frac, self._phase_tier
        cum_of = self._w_cum
        unthrottled, svc = self._unthrottled, self._w_svc
        rnd = self.rng.random
        free = self._r_free
        now = self.now
        open_w, arr_q = self._w_open, self._arr_q
        arr_issued = self._arr_issued
        misses = 0
        while len(irq) < cap and misses < n:
            gi = ptr
            ptr += 1
            if ptr == n:
                ptr = 0
            wi = rr_wi[gi]
            if out[gi] >= effmlp[wi]:
                misses += 1
                continue
            lim = limit[wi]
            if lim is not None and rr_core[gi] >= lim:
                misses += 1
                continue
            # Open-loop gate: issue only from a non-empty backlog; the head's
            # key (a quantile, or -1) routes by placement without a draw.
            if open_w[wi]:
                aq = arr_q[wi]
                if not aq:
                    misses += 1
                    continue
                key = aq[0][1]
            else:
                key = -1.0
            frac = frac_of[wi]
            if frac is None:
                cum = cum_of[wi]
                if cum is None:
                    tier = cur_tier[wi]
                else:  # placement lottery: one draw
                    r = key if key >= 0.0 else rnd()
                    tier = 0
                    while r >= cum[tier]:
                        tier += 1
            else:
                r = key if key >= 0.0 else rnd()
                tier = _DDR if r < frac else _CXL
            if not unthrottled[wi] and not self._take_token(wi, svc[wi][tier]):
                misses += 1
                continue
            if open_w[wi]:
                tissue = arr_q[wi].popleft()[0]
                arr_issued[wi] += 1
            else:
                tissue = now
            if free:
                rid = free.pop()
                self._r_wl[rid] = wi
                self._r_gi[rid] = gi
                self._r_tier[rid] = tier
                self._r_tissue[rid] = tissue
            else:
                rid = len(self._r_wl)
                self._r_wl.append(wi)
                self._r_gi.append(gi)
                self._r_tier.append(tier)
                self._r_station.append(tier)
                self._r_tissue.append(tissue)
                self._r_ttor.append(0.0)
                self._r_service.append(0.0)
                self._r_traced.append(0)
            out[gi] += 1
            irq.append(rid)
            misses = 0
        self._rr_ptr = ptr

    def _refill_issue(self) -> None:
        self._fill_irq()
        self._pump()

    # -- IRQ -> ToR -> station ------------------------------------------------
    def _pump(self) -> None:
        """Admit IRQ heads into the ToR while entries are free (head-of-line
        FIFO), route each to its station (the LLC lottery included) and let
        the cores refill the freed IRQ space.  The issue scan is
        :meth:`_fill_irq`'s, inlined: in steady state every admission frees
        one IRQ slot and one core issues into it, so this is the hottest
        loop."""
        irq = self.irq
        cap = self.tor_capacity
        irq_cap = self.irq_capacity
        now = self.now
        r_wl, r_tier, r_station = self._r_wl, self._r_tier, self._r_station
        r_ttor, r_tissue, r_service = self._r_ttor, self._r_tissue, self._r_service
        r_gi = self._r_gi
        phit, llc_svc, svc = self._w_phit, self._w_llc_svc, self._w_svc
        st_busy, st_slots, st_q = self._st_busy, self._st_slots, self._st_q
        rnd = self.rng.random
        heap = self._heap
        push = heapq.heappush
        rr_wi, rr_core = self._rr_wi, self._rr_core
        n_rr = len(rr_wi)
        out = self._out
        effmlp, limit = self._w_effmlp, self._limit
        frac_of, cur_tier = self._w_frac, self._phase_tier
        cum_of = self._w_cum
        unthrottled = self._unthrottled
        free = self._r_free
        llc = self._llc
        open_w, arr_q = self._w_open, self._arr_q
        arr_issued = self._arr_issued
        fabric_on = self._fabric_active
        w_hops = self._w_hops
        tier_inflight = self._tier_inflight
        san = self._san
        tr_every = self._tr_every
        tracer = self._tracer
        r_traced = self._r_traced
        while irq and self.tor_used < cap:
            rid = irq.popleft()
            self.tor_used += 1
            if self.tor_used > self.tor_peak:
                self.tor_peak = self.tor_used
            self.tor_inserts += 1
            tier = r_tier[rid]
            if san is not None:
                tier_inflight[tier] += 1
                san.adm[tier] += 1
            r_ttor[rid] = now
            # Trace every Nth admission, keyed on the insert count.
            if tr_every and (self.tor_inserts - 1) % tr_every == 0:
                if tracer.admit(rid, r_wl[rid], tier, r_tissue[rid], now):
                    r_traced[rid] = 1
            wi = r_wl[rid]
            p = phit[wi]
            if p == 2.0:  # sync: coherence ops at the LLC
                station = llc
                service = llc_svc[wi]
            elif p >= 0.0 and rnd() < p:
                station = llc
                service = llc_svc[wi]
            else:
                station = tier
                service = svc[wi][tier]
            if fabric_on and station != llc and w_hops[wi][tier]:
                # Routed: cross the fabric's hops before the device.
                self._hop_admit(rid, w_hops[wi][tier])
            else:
                r_station[rid] = station
                r_service[rid] = service
                if tr_every and r_traced[rid]:
                    tracer.station_enter(rid, station, now)
                if st_busy[station] < st_slots[station]:
                    st_busy[station] += 1
                    self._seq += 1
                    push(heap, (now + service,
                                (self._seq << _SEQ_SHIFT) | (_EV_COMPLETE << _KIND_SHIFT) | rid))
                else:
                    st_q[station].append(rid)
            if len(irq) < irq_cap:
                ptr = self._rr_ptr
                misses = 0
                while len(irq) < irq_cap and misses < n_rr:
                    gi = ptr
                    ptr += 1
                    if ptr == n_rr:
                        ptr = 0
                    iwi = rr_wi[gi]
                    if out[gi] >= effmlp[iwi]:
                        misses += 1
                        continue
                    lim = limit[iwi]
                    if lim is not None and rr_core[gi] >= lim:
                        misses += 1
                        continue
                    if open_w[iwi]:
                        aq = arr_q[iwi]
                        if not aq:
                            misses += 1
                            continue
                        key = aq[0][1]
                    else:
                        key = -1.0
                    frac = frac_of[iwi]
                    if frac is None:
                        icum = cum_of[iwi]
                        if icum is None:
                            itier = cur_tier[iwi]
                        else:
                            r = key if key >= 0.0 else rnd()
                            itier = 0
                            while r >= icum[itier]:
                                itier += 1
                    else:
                        r = key if key >= 0.0 else rnd()
                        itier = _DDR if r < frac else _CXL
                    if not unthrottled[iwi] and not self._take_token(iwi, svc[iwi][itier]):
                        misses += 1
                        continue
                    if open_w[iwi]:
                        tissue = arr_q[iwi].popleft()[0]
                        arr_issued[iwi] += 1
                    else:
                        tissue = now
                    if free:
                        nrid = free.pop()
                        r_wl[nrid] = iwi
                        r_gi[nrid] = gi
                        r_tier[nrid] = itier
                        r_tissue[nrid] = tissue
                    else:
                        nrid = len(r_wl)
                        r_wl.append(iwi)
                        r_gi.append(gi)
                        r_tier.append(itier)
                        r_station.append(itier)
                        r_tissue.append(tissue)
                        r_ttor.append(0.0)
                        r_service.append(0.0)
                        r_traced.append(0)
                    out[gi] += 1
                    irq.append(nrid)
                    misses = 0
                self._rr_ptr = ptr

    def _retire(self, rid: int) -> None:
        # run()'s event loop holds an inlined copy of this body for
        # _EV_RETIRE events; keep the two in step.  This method serves the
        # synchronous paths (LLC hits, zero-pipeline devices).
        now = self.now
        self.tor_used -= 1
        tier = self._r_tier[rid]
        if self._san is not None:
            self._tier_inflight[tier] -= 1
            self._san.ret[tier] += 1
        wi = self._r_wl[rid]
        residency = now - self._r_ttor[rid]
        self._occ_tier[tier] += residency
        if self._r_station[rid] != self._llc:
            self._tc_ins[tier] += 1
            self._tc_occ[tier] += residency
            self._tc_cls[tier][self._w_op[wi]] += 1
            if self._edge_scope and tier != _DDR:
                # Device edge: device-side residency only (see run()'s copy).
                dres = now - self._dev_t.pop(rid, self._r_ttor[rid])
                self._e_ins[tier - 1] += 1
                self._e_occ[tier - 1] += dres
                self._e_cls[tier - 1][self._w_op[wi]] += 1
        self._stat_completed[wi] += 1
        nbytes = self._w_bytes[wi][tier]
        self._stat_bytes[wi] += nbytes
        self._timeline_acc[wi] += nbytes
        latency = now - self._r_tissue[rid]
        self._stat_latsum[wi] += latency
        cnt = self._stat_latcnt[wi] + 1
        self._stat_latcnt[wi] = cnt
        # Reservoir sampling (algorithm R) on its own RNG stream.
        res = self._stat_res[wi]
        k = self._reservoir_k
        if len(res) < k:
            res.append(latency)
        else:
            j = int(self._res_random() * cnt)
            if j < k:
                res[j] = latency
        if self._lat_ap is not None:
            self._lat_ap[wi][tier](latency)
        if self._tr_every and self._r_traced[rid]:
            self._tracer.retire(rid, now)
            self._r_traced[rid] = 0
        # The core slot is free: reissue (round-robin with everyone), admit.
        self._out[self._r_gi[rid]] -= 1
        self._r_free.append(rid)
        if len(self.irq) < self.irq_capacity:
            self._fill_irq()
        if self.irq and self.tor_used < self.tor_capacity:
            self._pump()

    # -- open-loop arrivals ---------------------------------------------------
    def _schedule_arrivals(self) -> None:
        """Schedule each open-loop workload's first generated arrival."""
        for wi, pend in enumerate(self._arr_pending):
            if pend is not None:
                self._push(pend[0], _EV_ARRIVAL, wi)

    def _arrival(self, wi: int) -> None:
        """One generated request lands: join the backlog (or shed at the
        queue limit), schedule the next arrival and re-open the issue path."""
        pend = self._arr_pending[wi]
        self._arr_gen[wi] += 1
        q = self._arr_q[wi]
        lim = self._arr_qlimit[wi]
        if lim is not None and len(q) >= lim:
            self._arr_shed[wi] += 1
        else:
            q.append(pend)
        nxt = next(self._arr_iter[wi], None)
        self._arr_pending[wi] = nxt
        if nxt is not None:
            self._push(nxt[0], _EV_ARRIVAL, wi)
        self._fill_irq()
        self._pump()

    # -- phases / windows ------------------------------------------------------
    def _schedule_phases(self) -> None:
        for wi, w in enumerate(self.workloads):
            if w.phases:
                dur, _ = w.phases[0]
                self._push(dur, _EV_PHASE, wi)

    def _phase_flip(self, wi: int) -> None:
        seq = self._phase_seq[wi]
        if seq is None:
            raise InvariantViolation(
                "phase-schedule",
                f"phase-flip event for workload {self.workloads[wi].name!r}, "
                "which has no phase schedule",
                window=self._n_windows + 1,
                context={"workload": wi},
            )
        self._phase_idx[wi] = (self._phase_idx[wi] + 1) % len(seq)
        dur, tier_code = seq[self._phase_idx[wi]]
        self._phase_tier[wi] = tier_code
        self._recompute_throttle(wi)
        self._push(self.now + dur, _EV_PHASE, wi)
        self._refill_issue()

    def _window(self) -> None:
        prof = self._prof
        if prof is not None:
            pt0 = prof.clock()
        # The sanitizer's pass comes first: the boundary is where every
        # conservation identity holds exactly (and where injected faults land).
        if self._san is not None:
            self._san.on_window(self, self._n_windows + 1)
        # The control loop consumes counter deltas, runs the controller and
        # applies its decision; with no controller it keeps the cadence.
        self.control.fire()
        self._n_windows += 1
        if self._lat_wt is not None and self._record_windows:
            # Sample counts per (workload, tier) at the boundary: each
            # window's histogram is built from its exact slice.
            self._hist_marks.append(
                (self._n_windows, self.now, [[len(s) for s in row] for row in self._lat_wt])
            )
        if self._fabric_active and self._record_windows:
            # Each port's state at the boundary (the sim keeps the window
            # index: with no controller the loop records nothing).
            self._fabric_log.append({
                "window": self._n_windows,
                "t_ns": self.now,
                "links": {
                    name: {
                        "queued": len(self._st_q[self._link0 + i]),
                        "in_service": self._st_busy[self._link0 + i],
                        "occupancy": self._hop_occ[self._link0 + i],
                        "stalled": len(self._hop_stall[self._link0 + i]),
                        "stall_events": self._hop_stall_events[self._link0 + i],
                    }
                    for i, name in enumerate(self._link_names)
                },
            })
        if self._open_active and self._record_windows:
            # The window's generated, issued and shed counts and the backlog
            # at its end (queue growth is the open-loop overload signal).
            gen, iss = self._arr_gen, self._arr_issued
            shed = self._arr_shed
            self._arrival_log.append({
                "window": self._n_windows,
                "t_ns": self.now,
                "workloads": {
                    w.name: {
                        "generated": gen[wi] - self._arr_gen_mark[wi],
                        "issued": iss[wi] - self._arr_issued_mark[wi],
                        "shed": shed[wi] - self._arr_shed_mark[wi],
                        "queue_depth": len(self._arr_q[wi]),
                    }
                    for wi, w in enumerate(self.workloads)
                    if self._w_open[wi]
                },
            })
            self._arr_gen_mark = list(gen)
            self._arr_issued_mark = list(iss)
            self._arr_shed_mark = list(shed)
        if self._tiering is not None and self._tiering.on_window(self):
            # The hook changed routing or budgets: re-open the issue path.
            self._fill_irq()
            self._pump()
        while self.now >= self._timeline_next:
            acc = self._timeline_acc
            for wi, w in enumerate(self.workloads):
                self.stats[w.name].timeline.append((self._timeline_next, acc[wi]))
                acc[wi] = 0.0
            self._timeline_next += self._timeline_bucket_ns
        self._push(self.control.next_window_ns, _EV_WINDOW, 0)
        if prof is not None:
            prof.add("window_pass", prof.clock() - pt0)

    # -- run --------------------------------------------------------------------
    def run(self, sim_ns: float) -> SimResult:
        self._schedule_phases()
        self._schedule_arrivals()
        self._push(self.control.next_window_ns, _EV_WINDOW, 0)
        self._fill_irq()
        self._pump()
        heap = self._heap
        pop = heapq.heappop
        push = heapq.heappush
        retire = self._retire
        kshift, amask = _KIND_SHIFT, _ARG_MASK
        ev_complete, ev_retire, ev_phase, ev_window = (
            _EV_COMPLETE, _EV_RETIRE, _EV_PHASE, _EV_WINDOW,
        )
        ev_arrival = _EV_ARRIVAL
        complete_bits = ev_complete << kshift
        retire_bits = ev_retire << kshift
        # Loop-stable bindings for the two inlined hot handlers (these lists
        # are appended to, never rebound).
        r_wl, r_gi, r_tier = self._r_wl, self._r_gi, self._r_tier
        r_station, r_tissue = self._r_station, self._r_tissue
        r_ttor, r_service = self._r_ttor, self._r_service
        st_busy, st_q = self._st_busy, self._st_q
        occ_tier = self._occ_tier
        tc_ins, tc_occ, tc_cls = self._tc_ins, self._tc_occ, self._tc_cls
        w_op, w_bytes = self._w_op, self._w_bytes
        stat_completed, stat_bytes = self._stat_completed, self._stat_bytes
        stat_latsum, stat_latcnt = self._stat_latsum, self._stat_latcnt
        stat_res, timeline_acc = self._stat_res, self._timeline_acc
        out, free = self._out, self._r_free
        irq = self.irq
        irq_cap = self.irq_capacity
        pipe = self._pipe
        res_random = self._res_random
        rk = self._reservoir_k
        tor_cap = self.tor_capacity
        st_slots = self._st_slots
        phit, llc_svc, svc = self._w_phit, self._w_llc_svc, self._w_svc
        rnd = self.rng.random
        rr_wi, rr_core = self._rr_wi, self._rr_core
        n_rr = len(rr_wi)
        effmlp, limit = self._w_effmlp, self._limit
        frac_of, cur_tier = self._w_frac, self._phase_tier
        cum_of = self._w_cum
        unthrottled = self._unthrottled
        llc = self._llc
        lat_ap = self._lat_ap
        open_w, arr_q = self._w_open, self._arr_q
        arr_issued = self._arr_issued
        fabric_on = self._fabric_active
        w_hops = self._w_hops
        edge_on = self._edge_scope
        e_ins, e_occ, e_cls = self._e_ins, self._e_occ, self._e_cls
        dev_t = self._dev_t
        # The sanitizer's and the tracer's hooks cost a compare per admission
        # and retire when off, nothing per event.
        tier_inflight = self._tier_inflight
        san = self._san
        tr_every = self._tr_every
        tracer = self._tracer
        tr_limit = tracer.config.limit if tracer is not None else 0
        r_traced = self._r_traced
        prof = self._prof
        if prof is not None:
            rl0 = prof.clock()
        while heap:
            t, packed = pop(heap)
            if t > sim_ns:
                break
            self.now = t
            kind = (packed >> kshift) & 0xF
            if kind == ev_retire:
                # --- inlined _retire (keep in step with the method) --------
                rid = packed & amask
                tor_used = self.tor_used - 1
                tier = r_tier[rid]
                if san is not None:
                    tier_inflight[tier] -= 1
                    san.ret[tier] += 1
                wi = r_wl[rid]
                residency = t - r_ttor[rid]
                occ_tier[tier] += residency
                if r_station[rid] != llc:
                    tc_ins[tier] += 1
                    tc_occ[tier] += residency
                    tc_cls[tier][w_op[wi]] += 1
                    if edge_on and tier != _DDR:
                        # Device edge: device-side residency only (from
                        # _dev_t after fabric hops, else the whole ToR
                        # residency, which is the same on a hop-free route).
                        e_ins[tier - 1] += 1
                        e_occ[tier - 1] += t - dev_t.pop(rid, r_ttor[rid])
                        e_cls[tier - 1][w_op[wi]] += 1
                stat_completed[wi] += 1
                nbytes = w_bytes[wi][tier]
                stat_bytes[wi] += nbytes
                timeline_acc[wi] += nbytes
                latency = t - r_tissue[rid]
                stat_latsum[wi] += latency
                cnt = stat_latcnt[wi] + 1
                stat_latcnt[wi] = cnt
                res = stat_res[wi]
                if len(res) < rk:
                    res.append(latency)
                else:
                    j = int(res_random() * cnt)
                    if j < rk:
                        res[j] = latency
                if lat_ap is not None:
                    lat_ap[wi][tier](latency)
                if tr_every and r_traced[rid]:
                    tracer.retire(rid, t)
                    r_traced[rid] = 0
                    if not tracer.live and len(tracer.done) >= tr_limit:
                        # The budget is spent and nothing is live: no later
                        # admission can be traced, so drop to the untraced
                        # path (the dropped count is closed-form at the end).
                        tr_every = 0
                out[r_gi[rid]] -= 1
                free.append(rid)
                if len(irq) < irq_cap:
                    self.tor_used = tor_used
                    self._fill_irq()
                # --- inlined _pump (keep in step with the method) ----------
                while irq and tor_used < tor_cap:
                    arid = irq.popleft()
                    tor_used += 1
                    if tor_used > self.tor_peak:
                        self.tor_peak = tor_used
                    self.tor_inserts += 1
                    atier = r_tier[arid]
                    if san is not None:
                        tier_inflight[atier] += 1
                        san.adm[atier] += 1
                    r_ttor[arid] = t
                    if tr_every and (self.tor_inserts - 1) % tr_every == 0:
                        if tracer.admit(arid, r_wl[arid], atier, r_tissue[arid], t):
                            r_traced[arid] = 1
                    awi = r_wl[arid]
                    p = phit[awi]
                    if p == 2.0:
                        station = llc
                        service = llc_svc[awi]
                    elif p >= 0.0 and rnd() < p:
                        station = llc
                        service = llc_svc[awi]
                    else:
                        station = atier
                        service = svc[awi][atier]
                    if fabric_on and station != llc and w_hops[awi][atier]:
                        self._hop_admit(arid, w_hops[awi][atier])
                    else:
                        r_station[arid] = station
                        r_service[arid] = service
                        if tr_every and r_traced[arid]:
                            tracer.station_enter(arid, station, t)
                        if st_busy[station] < st_slots[station]:
                            st_busy[station] += 1
                            seq = self._seq + 1
                            self._seq = seq
                            push(heap, (t + service, (seq << _SEQ_SHIFT) | complete_bits | arid))
                        else:
                            st_q[station].append(arid)
                    if len(irq) < irq_cap:
                        ptr = self._rr_ptr
                        misses = 0
                        while len(irq) < irq_cap and misses < n_rr:
                            gi = ptr
                            ptr += 1
                            if ptr == n_rr:
                                ptr = 0
                            iwi = rr_wi[gi]
                            if out[gi] >= effmlp[iwi]:
                                misses += 1
                                continue
                            lim = limit[iwi]
                            if lim is not None and rr_core[gi] >= lim:
                                misses += 1
                                continue
                            if open_w[iwi]:
                                aq = arr_q[iwi]
                                if not aq:
                                    misses += 1
                                    continue
                                key = aq[0][1]
                            else:
                                key = -1.0
                            frac = frac_of[iwi]
                            if frac is None:
                                icum = cum_of[iwi]
                                if icum is None:
                                    itier = cur_tier[iwi]
                                else:
                                    r = key if key >= 0.0 else rnd()
                                    itier = 0
                                    while r >= icum[itier]:
                                        itier += 1
                            else:
                                r = key if key >= 0.0 else rnd()
                                itier = _DDR if r < frac else _CXL
                            if not unthrottled[iwi] and not self._take_token(
                                iwi, svc[iwi][itier]
                            ):
                                misses += 1
                                continue
                            if open_w[iwi]:
                                tissue = arr_q[iwi].popleft()[0]
                                arr_issued[iwi] += 1
                            else:
                                tissue = t
                            if free:
                                nrid = free.pop()
                                r_wl[nrid] = iwi
                                r_gi[nrid] = gi
                                r_tier[nrid] = itier
                                r_tissue[nrid] = tissue
                            else:
                                nrid = len(r_wl)
                                r_wl.append(iwi)
                                r_gi.append(gi)
                                r_tier.append(itier)
                                r_station.append(itier)
                                r_tissue.append(tissue)
                                r_ttor.append(0.0)
                                r_service.append(0.0)
                                r_traced.append(0)
                            out[gi] += 1
                            irq.append(nrid)
                            misses = 0
                        self._rr_ptr = ptr
                self.tor_used = tor_used
            elif kind == ev_complete:
                # --- inlined _complete: free the server, start the next
                # queued request, start the return flight ------------------
                rid = packed & amask
                station = r_station[rid]
                if station > llc:
                    # A hop's service is done: go on along the route, or
                    # stall holding this hop's server under backpressure.
                    self._hop_complete(rid, station)
                    continue
                if tr_every and r_traced[rid]:
                    tracer.service_done(rid, station, t, r_service[rid])
                q = st_q[station]
                if q:
                    nxt = q.popleft()
                    seq = self._seq + 1
                    self._seq = seq
                    push(heap, (t + r_service[nxt], (seq << _SEQ_SHIFT) | complete_bits | nxt))
                else:
                    st_busy[station] -= 1
                if station == llc:
                    retire(rid)  # no return flight from the LLC
                else:
                    pipeline = pipe[r_tier[rid]]
                    if pipeline > 0.0:
                        seq = self._seq + 1
                        self._seq = seq
                        push(heap, (t + pipeline, (seq << _SEQ_SHIFT) | retire_bits | rid))
                    else:
                        retire(rid)
            elif kind == ev_arrival:
                self._arrival(packed & amask)
            elif kind == ev_phase:
                self._phase_flip(packed & amask)
            elif kind == ev_window:
                self._window()
            else:  # _EV_TOKEN
                self._token_wait[packed & amask] = False
                self._refill_issue()
        if prof is not None:
            prof.add("event_loop", prof.clock() - rl0)
        self.now = sim_ns
        # Charge partial residency for requests still holding ToR entries at
        # the horizon (allocated, not free, not staged in the IRQ).
        dead = set(free)
        dead.update(irq)
        for rid in range(len(r_wl)):
            if rid not in dead:
                occ_tier[r_tier[rid]] += sim_ns - r_ttor[rid]
        self.tor_occupancy_integral = sum(occ_tier)
        if san is not None:
            san.check_final(self)
        self._materialize_counters()
        for wi, w in enumerate(self.workloads):
            st = self.stats[w.name]
            st.completed = self._stat_completed[wi]
            st.bytes = self._stat_bytes[wi]
            st.latency_sum = self._stat_latsum[wi]
            st.latency_count = self._stat_latcnt[wi]
            st.latency_samples = self._stat_res[wi]
        tier_hists = None
        if self._lat_wt is not None:
            sub = [[LatencyHistogram.from_samples(lst) for lst in row] for row in self._lat_wt]
            for wi, w in enumerate(self.workloads):
                self.stats[w.name].latency_hist = merge_all(sub[wi])
            tier_hists = {name: merge_all(row[i] for row in sub)
                          for i, name in enumerate(self._tier_names)}
        reg = default_registry()
        reg.counter("des.runs").inc()
        reg.counter("des.requests").inc(float(sum(self._stat_completed)))
        reg.counter("des.tor_inserts").inc(float(self.tor_inserts))
        reg.counter("des.windows").inc(float(self._n_windows))
        if tracer is not None:
            reg.counter("des.traced_requests").inc(float(len(tracer.done)))
            # The sampler hits the (k * every + 1)th inserts, and each hit is
            # done, live or dropped (the loop stops admitting at the limit).
            every = tracer.config.sample_every
            sampled = (self.tor_inserts - 1) // every + 1 if self.tor_inserts else 0
            tracer.dropped = sampled - len(tracer.done) - len(tracer.live)
        return SimResult(
            sim_ns=sim_ns,
            stats=self.stats,
            tier_counters=self.tier_counters,
            tor_peak=self.tor_peak,
            tor_occupancy_integral=self.tor_occupancy_integral,
            tor_inserts=self.tor_inserts,
            decisions=self.control.decisions,
            per_tier_occupancy_integral={t: self._occ_tier[i]
                                         for i, t in enumerate(self._tier_names)},
            window_records=self._window_records(),
            tiering=self._tiering.summary() if self._tiering is not None else None,
            fabric=(
                {
                    name: {
                        "stall_events": self._hop_stall_events[self._link0 + i],
                        "peak_occupancy": self._hop_peak_occ[self._link0 + i],
                        "entry_limit": self._hop_limit[self._link0 + i],
                    }
                    for i, name in enumerate(self._link_names)
                }
                if self._fabric_active else None
            ),
            sanitizer=self._san.summary(self) if self._san is not None else None,
            arrival=(
                {
                    w.name: {
                        "generated": self._arr_gen[wi],
                        "issued": self._arr_issued[wi],
                        "shed": self._arr_shed[wi],
                        "backlog": len(self._arr_q[wi]),
                    }
                    for wi, w in enumerate(self.workloads)
                    if self._w_open[wi]
                }
                if self._open_active else None
            ),
            tier_latency_hist=tier_hists,
            trace=tracer.run_payload() if tracer is not None else None,
            profile=prof.snapshot() if prof is not None else None,
        )

    def _window_records(self) -> List[dict]:
        if not self._record_windows:
            return []
        records = [window_record_jsonable(r) for r in self.control.records]
        if self._hist_marks:
            # Window w's histogram from the exact slice of latencies that
            # retired in it (their merge is the whole run's histogram);
            # windows the control loop did not record get a base record.
            by_idx = {r["window"]: r for r in records}
            n_tiers = self._n_tiers
            prev = [[0] * n_tiers for _ in self.workloads]
            for widx, t_ns, lens in self._hist_marks:
                rec = by_idx.get(widx)
                if rec is None:
                    rec = {"window": widx, "t_ns": t_ns}
                    by_idx[widx] = rec
                    records.append(rec)
                rec["latency_hist"] = {
                    w.name: merge_all(
                        LatencyHistogram.from_samples(
                            self._lat_wt[wi][t][prev[wi][t]:lens[wi][t]]
                        )
                        for t in range(n_tiers)
                    ).to_jsonable()
                    for wi, w in enumerate(self.workloads)
                }
                prev = lens
            records.sort(key=lambda r: r["window"])
        # The open-loop and fabric logs, merged in by window index (a base
        # record for a window the control loop did not record).
        for log, key, field in ((self._arrival_log, "arrival", "workloads"),
                                (self._fabric_log, "fabric", "links")):
            if not log:
                continue
            by_idx = {r["window"]: r for r in records}
            for entry in log:
                rec = by_idx.get(entry["window"])
                if rec is None:
                    rec = {"window": entry["window"], "t_ns": entry["t_ns"]}
                    by_idx[entry["window"]] = rec
                    records.append(rec)
                rec[key] = entry[field]
            records.sort(key=lambda r: r["window"])
        if self._tiering is None:
            return records
        # The tiering hook's per-window counters, merged in by window index
        # (with no controller the hook's log alone carries the trace).
        by_index = {r["window"]: r for r in records}
        merged: List[dict] = []
        for entry in self._tiering.window_log:
            rec = by_index.pop(entry["window"], None)
            if rec is None:
                rec = {"window": entry["window"], "t_ns": entry["t_ns"]}
            rec["tiering"] = {k: v for k, v in entry.items() if k not in ("window", "t_ns")}
            merged.append(rec)
        merged.extend(by_index.values())  # windows the hook never saw
        merged.sort(key=lambda r: r["window"])
        return merged


# -- convenience runners -------------------------------------------------------


def run_bw_test(
    platform: PlatformModel,
    *,
    op: OpClass,
    tier: str,
    n_threads: int,
    sim_ns: float = 150_000.0,
    mlp: int = 160,
    seed: int = 0,
) -> SimResult:
    """One bw-test group of ``n_threads`` cores on ``tier`` (paper Fig. 3)."""
    wl = WorkloadSpec(name=f"bw-{tier}-{op.value}", op=op, tier=tier, n_cores=n_threads,
                      mlp=mlp)
    return TieredMemorySim(platform, [wl], seed=seed).run(sim_ns)


def run_lat_test(
    platform: PlatformModel,
    *,
    op: OpClass,
    tier: str,
    n_threads: int = 1,
    sim_ns: float = 300_000.0,
    seed: int = 0,
) -> SimResult:
    """Dependent (pointer-chasing) accesses on ``tier`` (paper Fig. 4)."""
    wl = WorkloadSpec(name=f"lat-{tier}-{op.value}", op=op, tier=tier, n_cores=n_threads,
                      dependent=True)
    return TieredMemorySim(platform, [wl], seed=seed, granularity=1).run(sim_ns)


def run_corun(
    platform: PlatformModel,
    *,
    op: OpClass,
    n_threads: int = 16,
    sim_ns: float = 200_000.0,
    controller=None,
    mlp: int = 160,
    seed: int = 0,
    window_ns: float = 10_000.0,
) -> SimResult:
    """Two co-running bw-tests, one on DDR and one on CXL (paper Fig. 5/10)."""
    wls = [
        WorkloadSpec(name="ddr", op=op, tier="ddr", n_cores=n_threads, mlp=mlp,
                     miku_managed=False),
        WorkloadSpec(name="cxl", op=op, tier="cxl", n_cores=n_threads, mlp=mlp),
    ]
    sim = TieredMemorySim(platform, wls, seed=seed, controller=controller,
                          window_ns=window_ns)
    return sim.run(sim_ns)


def cumulative_fractions(cum: Sequence[float]) -> List[float]:
    """The per-tier fractions that a routing vector's cumulative draw
    boundaries imply, the last boundary open (as the sim draws)."""
    out, prev = [], 0.0
    for t in range(len(cum)):
        hi = 1.0 if t == len(cum) - 1 else min(float(cum[t]), 1.0)
        out.append(max(0.0, hi - prev))
        prev = hi
    return out


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
        cum, acc = [], 0.0
        for t in names:
            acc += w.placement.get(t, 0.0)
            cum.append(acc)
        vec = cumulative_fractions(cum)
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

    Equal to ``TieredMemorySim(platform, workloads, granularity=...,
    window_ns=..., tiering=...).export_state()`` (and to the reference
    sim's), derived from the same per-workload loop of the constructor
    without building the sim's request pool and queues.  A tiering hook
    (:class:`repro_torch.tiering.hook.TieringHook`) appends its migration
    workloads and is bound to the export (``bind_export``), which then
    carries the tracked workloads' PageMap-derived routing and the
    migration workloads gated closed, as a bound sim exports them.

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
        tiering.bind_export(export, platform)
    return export
