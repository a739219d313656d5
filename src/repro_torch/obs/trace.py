"""Sampled request-lifecycle tracing with Chrome trace-event export (a port
of ``repro.obs.trace``).

The DES samples every Nth ToR admission **deterministically** — the
sampler is keyed on the running ``tor_inserts`` counter, so it draws no
random numbers and the tracing-off simulation stays bit-identical to
every pinned golden.  A traced request accumulates raw transition
events (station enter / service done / backpressure stall) while live;
at retire the chain is *finalized* into a span list that contiguously
partitions ``[t_tor, t_retire]``:

``irq_wait`` ``[t_issue, t_tor]`` (IRQ staging, outside the ToR), then
``<station>:queue`` / ``<station>:service`` pairs per hop port and for
the final device (or LLC), with ``<station>:stall`` spans wherever the
request was held by a full downstream port, and a closing
``flight:<tier>`` span for the pipelined return flight.  Because the
spans partition the interval, queue wait + service + stalls + flight
exactly equals the ToR residency — the conservation law the property
tests pin.

:func:`to_chrome` converts finalized records into Chrome trace-event
JSON (``"X"`` complete events, microsecond timestamps) loadable in
Perfetto / ``chrome://tracing``: one *process* per workload, one
*thread* per traced request, so unfair queuing and backpressure
cascades are directly visible as widened queue/stall spans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

__all__ = ["TraceConfig", "RequestTracer", "TransferTracer", "to_chrome"]

# Raw event kinds accumulated while a request is live.
_ENTER = 0  # entered a station (hop port or device/LLC): service may queue
_DONE = 1  # station service completed (carries the service time)
_STALL = 2  # held by a full downstream port (ends at the next _ENTER)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Sampling policy for the request tracer.

    ``sample_every``: trace the 1st, (N+1)th, (2N+1)th ... ToR admission.
    ``limit``: hard cap on traced requests per sim (bounds memory and
    export size); admissions past the cap are counted as dropped.
    """

    sample_every: int = 64
    limit: int = 512

    def __post_init__(self) -> None:
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if self.limit < 1:
            raise ValueError("limit must be >= 1")


class RequestTracer:
    """Span-chain recorder for sampled DES requests.

    The DES owns the sampling decision (it has ``tor_inserts`` in a
    local); this class only stores events for rids it was told to admit.
    ``live`` maps rid -> mutable record while the request is in flight;
    ``done`` holds finalized span records.  Rid recycling is safe: a rid
    is only in ``live`` between admit and retire, and the DES re-checks
    membership before every hook call.
    """

    __slots__ = ("config", "live", "done", "dropped", "_wl_names", "_st_names", "_tier_names")

    def __init__(
        self,
        config: TraceConfig,
        workload_names: Sequence[str],
        station_names: Sequence[str],
        tier_names: Sequence[str],
    ) -> None:
        self.config = config
        self.live: Dict[int, list] = {}
        self.done: List[dict] = []
        self.dropped = 0
        self._wl_names = list(workload_names)
        self._st_names = list(station_names)
        self._tier_names = list(tier_names)

    # -- hooks (called by the DES, guarded by membership in ``live``) --
    def admit(self, rid: int, wi: int, tier: int, t_issue: float, now: float) -> bool:
        """Start tracing ``rid``; False when the limit already dropped it."""
        if len(self.done) + len(self.live) >= self.config.limit:
            self.dropped += 1
            return False
        # [wi, tier, t_issue, t_tor, events]
        self.live[rid] = [wi, tier, t_issue, now, []]
        return True

    def station_enter(self, rid: int, station: int, now: float) -> None:
        rec = self.live.get(rid)
        if rec is not None:
            rec[4].append((_ENTER, station, now, 0.0))

    def service_done(self, rid: int, station: int, now: float, service: float) -> None:
        rec = self.live.get(rid)
        if rec is not None:
            rec[4].append((_DONE, station, now, service))

    def stall(self, rid: int, station: int, now: float) -> None:
        rec = self.live.get(rid)
        if rec is not None:
            rec[4].append((_STALL, station, now, 0.0))

    def retire(self, rid: int, now: float) -> None:
        rec = self.live.pop(rid, None)
        if rec is not None:
            self.done.append(self._finalize(rec, now))

    # -- finalization --------------------------------------------------
    def _finalize(self, rec: list, t_retire: float) -> dict:
        wi, tier, t_issue, t_tor, events = rec
        names = self._st_names
        spans: List[dict] = []
        if t_tor > t_issue:
            spans.append(
                {
                    "name": "irq_wait",
                    "station": "irq",
                    "kind": "irq",
                    "t0": t_issue,
                    "t1": t_tor,
                }
            )
        enter_t = t_tor
        stall_of: Optional[int] = None
        last_done = t_tor
        for kind, st, t, svc in events:
            stname = names[st] if 0 <= st < len(names) else f"st{st}"
            if kind == _ENTER:
                if stall_of is not None:
                    # stall span runs from the upstream done (== stall
                    # event time) to this enter.
                    sname = names[stall_of] if 0 <= stall_of < len(names) else f"st{stall_of}"
                    if t > enter_t:
                        spans.append(
                            {
                                "name": f"{sname}:stall",
                                "station": sname,
                                "kind": "stall",
                                "t0": enter_t,
                                "t1": t,
                            }
                        )
                    stall_of = None
                enter_t = t
            elif kind == _DONE:
                start = t - svc
                if start < enter_t:
                    start = enter_t  # float slack: (enter + svc) - svc != enter
                if start > enter_t:
                    spans.append(
                        {
                            "name": f"{stname}:queue",
                            "station": stname,
                            "kind": "queue",
                            "t0": enter_t,
                            "t1": start,
                        }
                    )
                spans.append(
                    {
                        "name": f"{stname}:service",
                        "station": stname,
                        "kind": "service",
                        "t0": start,
                        "t1": t,
                    }
                )
                enter_t = t
                last_done = t
            else:  # _STALL — span materialises at the next _ENTER
                stall_of = st
                enter_t = t
        tname = (
            self._tier_names[tier] if 0 <= tier < len(self._tier_names) else f"t{tier}"
        )
        if t_retire > last_done:
            spans.append(
                {
                    "name": f"flight:{tname}",
                    "station": tname,
                    "kind": "flight",
                    "t0": last_done,
                    "t1": t_retire,
                }
            )
        wl = self._wl_names[wi] if 0 <= wi < len(self._wl_names) else f"w{wi}"
        return {
            "workload": wl,
            "tier": tname,
            "t_issue": t_issue,
            "t_tor": t_tor,
            "t_retire": t_retire,
            "spans": spans,
        }

    # -- export --------------------------------------------------------
    def run_payload(self) -> dict:
        """The ``SimResult.trace`` payload (in-flight traces are dropped)."""
        return {
            "sample_every": self.config.sample_every,
            "limit": self.config.limit,
            "n_traced": len(self.done),
            "n_in_flight": len(self.live),
            "n_dropped": self.dropped,
            "requests": list(self.done),
        }


class TransferTracer:
    """Chunk-level span sampler for the serving ``TransferQueue``.

    Each sampled migration chunk yields a record shaped like a DES
    request record (so :func:`to_chrome` renders both): queue span
    ``[enqueue, service_start]`` and service span
    ``[service_start, done]`` on the ``offload:<tier>`` track.
    """

    __slots__ = ("every", "limit", "count", "records")

    def __init__(self, sample_every: int = 64, limit: int = 512) -> None:
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.every = sample_every
        self.limit = limit
        self.count = 0
        self.records: List[dict] = []

    def on_chunk(self, tier: str, enq: float, done: float, service: float) -> None:
        self.count += 1
        if (self.count - 1) % self.every != 0 or len(self.records) >= self.limit:
            return
        start = done - service
        if start < enq:
            start = enq
        spans = []
        if start > enq:
            spans.append(
                {
                    "name": f"offload:{tier}:queue",
                    "station": tier,
                    "kind": "queue",
                    "t0": enq,
                    "t1": start,
                }
            )
        spans.append(
            {
                "name": f"offload:{tier}:service",
                "station": tier,
                "kind": "service",
                "t0": start,
                "t1": done,
            }
        )
        self.records.append(
            {
                "workload": f"offload:{tier}",
                "tier": tier,
                "t_issue": enq,
                "t_tor": enq,
                "t_retire": done,
                "spans": spans,
            }
        )


def to_chrome(records: Sequence[dict]) -> dict:
    """Finalized span records -> Chrome trace-event JSON.

    One trace *process* per workload (named via ``process_name``
    metadata), one *thread* per traced request.  Timestamps are emitted
    in microseconds (trace-event convention); ``displayTimeUnit: ns``
    keeps Perfetto's cursor readout in nanoseconds.
    """
    pids: Dict[str, int] = {}
    events: List[dict] = []
    for i, rec in enumerate(records):
        wl = rec["workload"]
        pid = pids.setdefault(wl, len(pids) + 1)
        tid = i + 1
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": f"req{i} [{rec['tier']}]"},
            }
        )
        for sp in rec["spans"]:
            events.append(
                {
                    "name": sp["name"],
                    "cat": sp["kind"],
                    "ph": "X",
                    "ts": sp["t0"] / 1000.0,
                    "dur": (sp["t1"] - sp["t0"]) / 1000.0,
                    "pid": pid,
                    "tid": tid,
                    "args": {"station": sp["station"], "tier": rec["tier"]},
                }
            )
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": wl},
        }
        for wl, pid in sorted(pids.items(), key=lambda kv: kv[1])
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ns"}
