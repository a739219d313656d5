"""The runtime simulation sanitizer (a port of ``repro.analysis.sanitizer``).

:class:`DesSanitizer` threads through
:class:`repro_torch.core.des.TieredMemorySim` (``sanitize=True`` or
``REPRO_SANITIZE=1``) and re-derives, every control window and at the
horizon, the bookkeeping identities the DES's fast path keeps implicitly:

========================  ==================================================
check id                  invariant
========================  ==================================================
``event-order``           no pending event lies before the engine clock
``free-list``             no request id is freed twice, and no freed id is
                          staged in the IRQ
``conservation``          requests are conserved globally
                          (``tor_inserts == retired + tor_used``) and per
                          tier (``admitted == retired + in-flight``)
``issue-accounting``      outstanding requests per core sum to the live
                          request-pool entries and stay within each MLP
``entry-limit``           ToR, IRQ and every fabric port within their limits
``station-occupancy``     ``0 <= busy <= slots`` per station; on a hop
                          station ``occupancy == queued + in_service``
``counter-monotone``      cumulative per-tier counters never decrease
``counter-delta``         window deltas handed to the control loop are
                          non-negative (the TierSetWindowedCounters hook)
``arrival-conservation``  open-loop requests: ``generated == issued + shed
                          + backlog`` per workload
``token-bucket``          throttle token buckets never go negative
``migrate-debt``          the MigrationEngine's completion credit never goes
                          negative
``stall-cycle``           no frozen cycle in the hop stations' backpressure
                          graph (the DES's deadlock detector)
``link-conservation``     TransferQueue links conserve transfers and bytes
                          (:class:`QueueSanitizer`)
========================  ==================================================

A violation raises :class:`~repro_torch.core.invariants.InvariantViolation`
(mode ``"raise"``) or is collected into ``SimResult.sanitizer`` (mode
``"record"``).  :meth:`DesSanitizer.add_mutation` corrupts the state at a
chosen window, for fault-injection tests that assert the one check meant
to see it fires.  The checks read the DES's own fields by name, so the
sanitizer costs nothing when it is off.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.invariants import InvariantViolation


class DesSanitizer:
    """Per-sim invariant checker; one instance per TieredMemorySim run."""

    def __init__(self, n_tiers: int, mode: str = "raise") -> None:
        if mode not in ("raise", "record"):
            raise ValueError(
                f"unknown sanitizer mode {mode!r}; expected 'raise' or "
                "'record'"
            )
        self.mode = mode
        self.n_tiers = n_tiers
        #: Per-tier ToR admissions / retires, maintained by the DES's
        #: admission and retire paths (guarded increments on the hot path).
        self.adm = [0] * n_tiers
        self.ret = [0] * n_tiers
        self.violations: List[InvariantViolation] = []
        self.windows_checked = 0
        self._tc_ins_mark: Optional[List[int]] = None
        self._tc_occ_mark: Optional[List[float]] = None
        self._mutations: Dict[int, List[Callable[[Any], None]]] = {}

    # -- violation plumbing ------------------------------------------------
    def violate(
        self,
        check: str,
        message: str,
        *,
        window: Optional[int] = None,
        station: Optional[Any] = None,
        **context: Any,
    ) -> None:
        err = InvariantViolation(
            check, message, window=window, station=station, context=context
        )
        if self.mode == "raise":
            raise err
        self.violations.append(err)

    # -- fault-injection hooks ---------------------------------------------
    def add_mutation(self, window: int, fn: Callable[[Any], None]) -> None:
        """Run ``fn(sim)`` right before window ``window``'s checks — the
        seeded corruption hook the fault-injection tests drive."""
        self._mutations.setdefault(window, []).append(fn)

    # -- per-window pass ----------------------------------------------------
    def on_window(self, sim: Any, window: int) -> None:
        """Run every state check at a window boundary (after applying any
        fault-injection mutations registered for this window)."""
        for fn in self._mutations.pop(window, ()):
            fn(sim)
        self._check_state(sim, window)
        self.windows_checked += 1

    def check_final(self, sim: Any) -> None:
        """The same state checks at the simulation horizon."""
        self._check_state(sim, sim._n_windows + 1)

    def _check_state(self, sim: Any, window: int) -> None:
        self._check_event_order(sim, window)
        self._check_free_list(sim, window)
        self._check_conservation(sim, window)
        self._check_issue_accounting(sim, window)
        self._check_entry_limits(sim, window)
        self._check_station_occupancy(sim, window)
        self._check_counter_monotone(sim, window)
        self._check_arrival_conservation(sim, window)
        self._check_token_buckets(sim, window)
        self._check_migrate_debt(sim, window)
        self._check_stall_cycles(sim, window)

    # -- individual checks ---------------------------------------------------
    def _check_event_order(self, sim: Any, window: int) -> None:
        """Every pending event lies at or after the engine clock.  Events
        are only ever scheduled with non-negative delays, so a pending
        event in the past is a corrupted heap — checked here (not per pop)
        so the un-sanitized run loop pays nothing for it."""
        now = sim.now
        for t, _packed in sim._heap:
            if t < now:
                self.violate(
                    "event-order",
                    f"pending event scheduled at t={t}, before the "
                    f"current sim time t={now} — an event was scheduled "
                    "in the past",
                    window=window,
                    t=t,
                    now=now,
                )
                return

    def _check_free_list(self, sim: Any, window: int) -> None:
        free = sim._r_free
        if len(set(free)) != len(free):
            seen: set = set()
            dup = next(r for r in free if r in seen or seen.add(r))
            self.violate(
                "free-list",
                f"request id {dup} appears twice on the free-list "
                "(double-free)",
                window=window,
                rid=dup,
            )
        staged = set(free) & set(sim.irq)
        if staged:
            self.violate(
                "free-list",
                f"request id(s) {sorted(staged)} are simultaneously freed "
                "and staged in the IRQ",
                window=window,
                rids=sorted(staged),
            )

    def _check_conservation(self, sim: Any, window: int) -> None:
        retired = sum(self.ret)
        if sim.tor_inserts != retired + sim.tor_used:
            self.violate(
                "conservation",
                f"ToR admissions ({sim.tor_inserts}) != retired "
                f"({retired}) + in-flight ({sim.tor_used})",
                window=window,
                tor_inserts=sim.tor_inserts,
                retired=retired,
                tor_used=sim.tor_used,
            )
        if retired != sum(sim._stat_completed):
            self.violate(
                "conservation",
                f"per-tier retire count ({retired}) != per-workload "
                f"completed count ({sum(sim._stat_completed)})",
                window=window,
            )
        for t in range(self.n_tiers):
            inflight = sim._tier_inflight[t]
            if self.adm[t] != self.ret[t] + inflight:
                self.violate(
                    "conservation",
                    f"tier {sim._tier_names[t]!r}: admitted "
                    f"({self.adm[t]}) != retired ({self.ret[t]}) + "
                    f"in-flight ({inflight})",
                    window=window,
                    station=sim._tier_names[t],
                )
        if sum(sim._tier_inflight) != sim.tor_used:
            self.violate(
                "conservation",
                f"per-tier in-flight sum ({sum(sim._tier_inflight)}) != "
                f"ToR occupancy ({sim.tor_used})",
                window=window,
            )

    def _check_issue_accounting(self, sim: Any, window: int) -> None:
        live = len(sim._r_wl) - len(sim._r_free)
        if sum(sim._out) != live:
            self.violate(
                "issue-accounting",
                f"outstanding-per-core sum ({sum(sim._out)}) != live "
                f"request-pool entries ({live})",
                window=window,
                pool=len(sim._r_wl),
                free=len(sim._r_free),
            )
        for gi, out in enumerate(sim._out):
            cap = sim._w_effmlp[sim._rr_wi[gi]]
            if out < 0 or out > cap:
                self.violate(
                    "issue-accounting",
                    f"core {gi} holds {out} outstanding requests "
                    f"(MLP bound {cap})",
                    window=window,
                    core=gi,
                )

    def _check_entry_limits(self, sim: Any, window: int) -> None:
        if sim.tor_used > sim.tor_capacity:
            self.violate(
                "entry-limit",
                f"ToR occupancy {sim.tor_used} exceeds capacity "
                f"{sim.tor_capacity}",
                window=window,
                station="tor",
            )
        if len(sim.irq) > sim.irq_capacity:
            self.violate(
                "entry-limit",
                f"IRQ occupancy {len(sim.irq)} exceeds capacity "
                f"{sim.irq_capacity}",
                window=window,
                station="irq",
            )
        link0 = sim._link0
        for i, name in enumerate(sim._link_names):
            st = link0 + i
            if sim._hop_occ[st] > sim._hop_limit[st]:
                self.violate(
                    "entry-limit",
                    f"port {name!r} holds {sim._hop_occ[st]} entries "
                    f"(limit {sim._hop_limit[st]})",
                    window=window,
                    station=name,
                )

    def _check_station_occupancy(self, sim: Any, window: int) -> None:
        link0 = sim._link0
        for st, busy in enumerate(sim._st_busy):
            if busy < 0 or busy > sim._st_slots[st]:
                self.violate(
                    "station-occupancy",
                    f"station {st} has {busy} busy servers "
                    f"(slots {sim._st_slots[st]})",
                    window=window,
                    station=self._station_name(sim, st),
                )
            if st >= link0:
                expect = len(sim._st_q[st]) + busy
                if sim._hop_occ[st] != expect:
                    self.violate(
                        "station-occupancy",
                        f"port entry count {sim._hop_occ[st]} != queued "
                        f"({len(sim._st_q[st])}) + in-service ({busy})",
                        window=window,
                        station=self._station_name(sim, st),
                    )

    def _check_counter_monotone(self, sim: Any, window: int) -> None:
        ins, occ = sim._tc_ins, sim._tc_occ
        if self._tc_ins_mark is not None:
            for t in range(self.n_tiers):
                if ins[t] < self._tc_ins_mark[t]:
                    self.violate(
                        "counter-monotone",
                        f"tier {sim._tier_names[t]!r} insert counter went "
                        f"backwards ({self._tc_ins_mark[t]} -> {ins[t]})",
                        window=window,
                        station=sim._tier_names[t],
                    )
                if occ[t] < self._tc_occ_mark[t]:  # type: ignore[index]
                    self.violate(
                        "counter-monotone",
                        f"tier {sim._tier_names[t]!r} occupancy counter "
                        "went backwards",
                        window=window,
                        station=sim._tier_names[t],
                    )
        self._tc_ins_mark = list(ins)
        self._tc_occ_mark = list(occ)

    def _check_arrival_conservation(self, sim: Any, window: int) -> None:
        """Open-loop arrivals are conserved per workload: every generated
        request was issued into the pipeline, shed at the queue limit, or
        still waits in the backlog — exactly one of the three."""
        for wi, is_open in enumerate(getattr(sim, "_w_open", ())):
            if not is_open:
                continue
            gen = sim._arr_gen[wi]
            issued = sim._arr_issued[wi]
            shed = sim._arr_shed[wi]
            backlog = len(sim._arr_q[wi])
            if gen != issued + shed + backlog:
                self.violate(
                    "arrival-conservation",
                    f"workload {sim.workloads[wi].name!r}: generated "
                    f"({gen}) != issued ({issued}) + shed ({shed}) + "
                    f"backlog ({backlog})",
                    window=window,
                    workload=sim.workloads[wi].name,
                    generated=gen,
                    issued=issued,
                    shed=shed,
                    backlog=backlog,
                )

    def _check_token_buckets(self, sim: Any, window: int) -> None:
        for wi, tokens in enumerate(sim._tokens):
            if tokens < 0.0:
                self.violate(
                    "token-bucket",
                    f"workload {sim.workloads[wi].name!r} token bucket is "
                    f"negative ({tokens})",
                    window=window,
                    workload=sim.workloads[wi].name,
                )

    def _check_migrate_debt(self, sim: Any, window: int) -> None:
        hook = sim._tiering
        engine = getattr(hook, "engine", None) if hook is not None else None
        credit = getattr(engine, "_credit", None)
        if credit is None:
            return
        for code, value in credit.items():
            if value < 0:
                self.violate(
                    "migrate-debt",
                    f"MIGRATE completion credit on tier code {code} is "
                    f"negative ({value})",
                    window=window,
                    station=sim._tier_names[code],
                )

    def _check_stall_cycles(self, sim: Any, window: int) -> None:
        """Deadlock detector over the hop-station backpressure graph.

        A stalled entry ``(rid, upstream)`` at station ``s`` means a
        request *holding a server slot at* ``upstream`` waits for an entry
        at ``s`` — edge ``upstream -> s``.  A station is *frozen* when every
        busy server is such a stall-holder and nothing is queued behind
        them (no completion event can ever free an entry).  A cycle through
        frozen stations can never drain: flag it.
        """
        link0 = sim._link0
        if link0 >= len(sim._st_busy):
            return
        edges: Dict[int, List[int]] = {}
        holders: Dict[int, int] = {}
        for s in range(link0, len(sim._st_busy)):
            for _rid, upstream in sim._hop_stall[s]:
                if upstream >= 0:
                    edges.setdefault(upstream, []).append(s)
                    holders[upstream] = holders.get(upstream, 0) + 1
        if not edges:
            return
        frozen = {
            u for u, n in holders.items()
            if sim._st_busy[u] > 0
            and n >= sim._st_busy[u]
            and not sim._st_q[u]
        }
        # Three-color DFS restricted to frozen stations.
        color: Dict[int, int] = {}

        def visit(u: int, path: List[int]) -> Optional[List[int]]:
            color[u] = 1
            path.append(u)
            for v in edges.get(u, ()):
                if v not in frozen:
                    continue
                if color.get(v) == 1:
                    return path[path.index(v):] + [v]
                if color.get(v, 0) == 0:
                    cyc = visit(v, path)
                    if cyc is not None:
                        return cyc
            color[u] = 2
            path.pop()
            return None

        for u in sorted(frozen):
            if color.get(u, 0) == 0:
                cyc = visit(u, [])
                if cyc is not None:
                    names = [self._station_name(sim, s) for s in cyc]
                    self.violate(
                        "stall-cycle",
                        "head-of-line backpressure cycle with no eligible "
                        f"completer: {' -> '.join(map(str, names))}",
                        window=window,
                        station=names[0],
                        cycle=names,
                    )
                    return

    # -- control-plane hooks -------------------------------------------------
    def check_counter_deltas(self, names: Tuple[str, ...], deltas) -> None:
        """TierSetWindowedCounters delta hook: window deltas handed to the
        decision law must be non-negative."""
        for name, tc in zip(names, deltas):
            if tc.inserts < 0 or tc.occupancy_time < 0:
                self.violate(
                    "counter-delta",
                    f"negative window delta for {name!r}: "
                    f"inserts={tc.inserts}, "
                    f"occupancy_time={tc.occupancy_time}",
                    station=name,
                )

    # -- result surface --------------------------------------------------------
    def summary(self, sim: Any) -> dict:
        """JSON-safe summary for ``SimResult.sanitizer``."""
        return {
            "mode": self.mode,
            "windows_checked": self.windows_checked,
            "admitted": list(self.adm),
            "retired": list(self.ret),
            "violations": [v.to_dict() for v in self.violations],
        }

    @staticmethod
    def _station_name(sim: Any, st: int) -> Any:
        if st < sim._n_tiers:
            return sim._tier_names[st]
        if st == sim._llc:
            return "llc"
        i = st - sim._link0
        if 0 <= i < len(sim._link_names):
            return sim._link_names[i]
        return st


class QueueSanitizer:
    """Transfer/byte conservation for :class:`repro_torch.core.offload.
    TransferQueue`: per link, submissions equal completions plus in-flight
    transfers — counted and in bytes — after every ``advance``."""

    def __init__(self, mode: str = "raise") -> None:
        self.mode = mode
        self.submitted: Dict[str, int] = {}
        self.completed: Dict[str, int] = {}
        self.bytes_submitted: Dict[str, float] = {}
        self.bytes_completed: Dict[str, float] = {}
        self.violations: List[InvariantViolation] = []

    def on_submit(self, tier: str, nbytes: float) -> None:
        self.submitted[tier] = self.submitted.get(tier, 0) + 1
        self.bytes_submitted[tier] = (
            self.bytes_submitted.get(tier, 0.0) + nbytes
        )

    def on_complete(self, tier: str, nbytes: float) -> None:
        self.completed[tier] = self.completed.get(tier, 0) + 1
        self.bytes_completed[tier] = (
            self.bytes_completed.get(tier, 0.0) + nbytes
        )

    def check(self, queue: Any) -> None:
        inflight_n: Dict[str, int] = {}
        inflight_b: Dict[str, float] = {}
        for f in queue._inflight:
            inflight_n[f.tier] = inflight_n.get(f.tier, 0) + 1
            inflight_b[f.tier] = inflight_b.get(f.tier, 0.0) + f.nbytes
        for tier in self.submitted:
            sub = self.submitted[tier]
            done = self.completed.get(tier, 0)
            inf = inflight_n.get(tier, 0)
            if sub != done + inf:
                self._violate(
                    "link-conservation",
                    f"link {tier!r}: submitted ({sub}) != completed "
                    f"({done}) + in-flight ({inf})",
                    station=tier,
                )
            bsub = self.bytes_submitted[tier]
            bdone = self.bytes_completed.get(tier, 0.0)
            binf = inflight_b.get(tier, 0.0)
            if abs(bsub - (bdone + binf)) > 1e-6 * max(1.0, bsub):
                self._violate(
                    "link-conservation",
                    f"link {tier!r}: {bsub} bytes submitted != {bdone} "
                    f"completed + {binf} in-flight",
                    station=tier,
                )

    def check_counter_deltas(self, names, deltas) -> None:
        """TierSetWindowedCounters hook (same contract as
        :meth:`DesSanitizer.check_counter_deltas`)."""
        for name, tc in zip(names, deltas):
            if tc.inserts < 0 or tc.occupancy_time < 0:
                self._violate(
                    "counter-delta",
                    f"negative window delta for link {name!r}: "
                    f"inserts={tc.inserts}, "
                    f"occupancy_time={tc.occupancy_time}",
                    station=name,
                )

    def summary(self) -> dict:
        """JSON-safe summary mirroring :meth:`DesSanitizer.summary`."""
        return {
            "mode": self.mode,
            "submitted": dict(self.submitted),
            "completed": dict(self.completed),
            "violations": [v.to_dict() for v in self.violations],
        }

    def _violate(self, check: str, message: str, **kw: Any) -> None:
        err = InvariantViolation(check, message, **kw)
        if self.mode == "raise":
            raise err
        self.violations.append(err)
