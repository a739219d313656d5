"""Host-offload runtime: real tier transfers and the simulated transfer clock.

* :class:`HostOffloader` — real copies between device memory and pinned
  host memory.  Device-ward copies run ``non_blocking`` on a side CUDA
  stream into caller-owned destination tensors and are fenced by an event
  that the compute stream waits on (no host synchronisation).  CUDA events
  around each batch of copies give the measured host-link rate.
* :class:`TransferQueue` — the timing model of the shared transfer path, a
  copy of ``repro.core.offload.TransferQueue``: a simulated clock charging
  each transfer its tier service time, per-tier counters for MIKU, each
  slow link's in-flight cap and byte-rate as MIKU's decision, and the
  optional link-conservation sanitizer and chunk tracer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.controller import Decision, MikuController, TierDecisions
from repro_torch.core.invariants import sanitize_enabled
from repro_torch.core.littles_law import OpClass, TierCounters, TierWindow
from repro_torch.core.substrate import ControlLoop, TierSetWindowedCounters
from repro_torch.core.tiers import HBM_TIER, HOST_TIER, TierSpec, host_offload_supported
from repro_torch.obs.metrics import default_registry


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _map2(tree: Any, other: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map2(v, other[k], fn) for k, v in tree.items()}
    return fn(tree, other)


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class HostOffloader:
    """Real transfers between the device tier and the host tier.

    On a CUDA device the host copies are pinned and device-ward copies are
    asynchronous on a side stream; :meth:`block` makes the current stream
    wait for them.  On the CPU there is no pinned memory: copies are plain
    and synchronous (the control path is still exercised).
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.supported = host_offload_supported(device)
        self._stream = torch.cuda.Stream(device) if self.supported else None
        self._done: Optional[torch.cuda.Event] = None
        self._timings: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        #: Bytes really copied device-ward so far.
        self.bytes_to_device = 0

    def to_host(self, tree: Any) -> Any:
        """Copy a tree of tensors to (pinned) host memory."""
        def one(t: torch.Tensor) -> torch.Tensor:
            host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                               pin_memory=self.supported)
            return host.copy_(t)

        return _map(tree, one)

    def to_device(self, tree: Any, out: Any = None) -> Any:
        """Copy a host tree device-ward, into ``out`` when given (a
        persistent staging set of the same structure).  Asynchronous on
        CUDA: call :meth:`block` before reading the result."""
        if out is None:
            out = _map(tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                   device=self.device))
        self.bytes_to_device += sum(t.numel() * t.element_size()
                                    for t in _leaves(tree))
        if not self.supported:
            return _map2(out, tree, lambda dst, src: dst.copy_(src))
        # The staging set may still be read by work queued on the compute
        # stream (the previous step): overwrite it only after that work.
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            _map2(out, tree, lambda dst, src: dst.copy_(src, non_blocking=True))
            end.record()
        self._done = end
        self._timings.append((start, end))
        return out

    def block(self) -> None:
        """Fence: the current stream waits for the last device-ward copy."""
        if self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)

    def copy_seconds(self) -> float:
        """Device time spent in device-ward copies so far (waits for them)."""
        total = 0.0
        for start, end in self._timings:
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total


class UnknownTierError(ValueError):
    """A lookup named a transfer link the queue lacks; the message lists
    every known name."""

    def __init__(self, tier: str, known: Tuple[str, ...]):
        super().__init__(
            f"unknown transfer link {tier!r}; this queue's links are "
            f"{', '.join(known)}"
        )
        self.tier = tier
        self.known = tuple(known)


@dataclasses.dataclass
class _InFlight:
    nbytes: int
    op: OpClass
    tier: str
    t_enqueue: float
    t_complete: float


class TransferQueue:
    """Simulated shared transfer path with MIKU instrumentation + control.

    ``submit_slow_stream`` charges a transfer; the engine moves the clock
    with ``advance``.  Fast-tier traffic is reported via ``account_fast`` so
    the controller sees the same two-tier picture as the x86 platforms.
    """

    def __init__(
        self,
        fast: TierSpec = HBM_TIER,
        slow: TierSpec = HOST_TIER,
        controller: Optional[MikuController] = None,
        window_ns: float = 1_000_000.0,
        extra_slow: Sequence[TierSpec] = (),
        sanitize=None,
        trace: int = 0,
    ):
        self.fast = fast
        self.slow = slow
        # Slow links by label: the pinned-host path is "slow", an extra
        # tier goes by its TierSpec name.
        self.slow_tiers: Dict[str, TierSpec] = {"slow": slow}
        for spec in extra_slow:
            if spec.name in self.slow_tiers or spec.name == "fast":
                raise ValueError(f"duplicate slow tier label {spec.name!r}")
            self.slow_tiers[spec.name] = spec
        self.controller = controller
        self.now = 0.0
        self._counters = TierSetWindowedCounters(names=("fast", *self.slow_tiers))
        self.counters: Dict[str, TierCounters] = dict(
            zip(self._counters.names, self._counters.tiers)
        )
        self._inflight: List[_InFlight] = []
        self._decision = Decision(
            max_concurrency=None, rate_factor=1.0, phase=None  # type: ignore[arg-type]
        )
        self.control = ControlLoop(self, controller, window_ns=window_ns, record=False)
        # ``sanitize``: per-link transfer and byte conservation after every
        # ``advance`` (None reads REPRO_SANITIZE); ``trace``: every Nth
        # chunk's enqueue -> service -> complete spans.
        if sanitize is None:
            sanitize = sanitize_enabled()
        if sanitize:
            from repro_torch.analysis.sanitizer import QueueSanitizer

            mode = sanitize if isinstance(sanitize, str) else "raise"
            self._san: Optional[QueueSanitizer] = QueueSanitizer(mode=mode)
            self._counters.attach_sanitizer(self._san.check_counter_deltas)
        else:
            self._san = None
        if trace:
            from repro_torch.obs.trace import TransferTracer

            self._tracer: Optional[TransferTracer] = TransferTracer(sample_every=int(trace))
        else:
            self._tracer = None
        reg = default_registry()
        self._m_transfers = reg.counter("offload.transfers")
        self._m_bytes = reg.counter("offload.bytes")

    # -- substrate protocol -------------------------------------------------
    @property
    def clock_ns(self) -> float:
        return self.now

    def counters_delta(self) -> TierWindow:
        return self._counters.delta()

    def apply(self, decision) -> None:
        self._decision = decision

    def _check_tier(self, tier: str) -> None:
        if tier not in self.slow_tiers:
            raise UnknownTierError(tier, ("fast", *self.slow_tiers))

    def decision_for(self, tier: str = "slow") -> Decision:
        """The decision governing one slow link."""
        self._check_tier(tier)
        d = self._decision
        if isinstance(d, TierDecisions) and tier in d.tiers:
            return d.for_tier(tier)
        return d

    @property
    def window_ns(self) -> float:
        return self.control.window_ns

    @property
    def decisions(self) -> List[Decision]:
        return self.control.decisions

    @property
    def decision(self) -> Decision:
        return self._decision

    @property
    def trace_records(self) -> List[dict]:
        """The sampled chunks' span records (empty without ``trace``)."""
        return [] if self._tracer is None else self._tracer.records

    # -- instrumentation ----------------------------------------------------
    def account_fast(self, nbytes: int, duration_ns: float, op: OpClass) -> None:
        self.counters["fast"].record(op, duration_ns)
        del nbytes

    def _service_ns(self, nbytes: int, tier: TierSpec, op: OpClass) -> float:
        t = nbytes / tier.bandwidth_gbps  # B / (B/ns)
        if op is not OpClass.LOAD:
            t *= 2.0 if op is OpClass.NT_STORE else 1.5
        return t

    # -- submission / progress ------------------------------------------------
    def slow_inflight(self, tier: str = "slow") -> int:
        """One slow link's transfers holding descriptors now."""
        self._check_tier(tier)
        return sum(
            1 for f in self._inflight
            if f.tier == tier and f.t_enqueue <= self.now
        )

    def submit_slow(self, nbytes: int, op: OpClass = OpClass.LOAD) -> float:
        """Submit one transfer of ``nbytes`` over the default slow link."""
        return self.submit_slow_stream(int(nbytes), 1, op)

    def submit_slow_stream(
        self,
        total_bytes: int,
        n_chunks: int,
        op: OpClass = OpClass.LOAD,
        tier: str = "slow",
    ) -> float:
        """Submit one logical stream as ``n_chunks`` transfers over one
        bandwidth-bound slow link; returns the stream's completion time.

        The link serializes chunks, so a MIKU in-flight cap bounds how many
        descriptors the stream holds (chunk i enqueues when chunk i-cap
        completes) without slowing it; rate_factor < 1 stretches per-chunk
        service."""
        self._check_tier(tier)
        spec = self.slow_tiers[tier]
        decision = self.decision_for(tier)
        cap = decision.max_concurrency
        rate = max(decision.rate_factor, 1e-3)
        chunk = max(1, int(total_bytes) // max(1, n_chunks))
        service = self._service_ns(chunk, spec, op) / rate
        link_free = max(
            [f.t_complete for f in self._inflight if f.tier == tier],
            default=self.now,
        )
        done = max(self.now, link_free)
        dones: List[float] = []
        san = self._san
        tr = self._tracer
        for i in range(n_chunks):
            done = done + service
            if cap is None or i < cap:
                enq = self.now
            else:
                enq = dones[i - cap]
            self._inflight.append(_InFlight(chunk, op, tier, enq, done))
            if san is not None:
                san.on_submit(tier, chunk)
            if tr is not None:
                tr.on_chunk(tier, enq, done, service)
            dones.append(done)
        self._m_transfers.inc(float(n_chunks))
        self._m_bytes.inc(float(chunk * n_chunks))
        return done

    def slow_backlog(self, tier: Optional[str] = None) -> int:
        """In-flight slow transfers beyond a link's parallel slots, summed
        over every slow link when ``tier`` is None."""
        if tier is not None:
            self._check_tier(tier)
        tiers = self.slow_tiers if tier is None else (tier,)
        return sum(
            max(0, self.slow_inflight(t) - self.slow_tiers[t].parallelism)
            for t in tiers
        )

    def fast_penalty(self, pool: int = 56, c: float = 0.45) -> float:
        """Service-time multiplier for fast-tier steps while slow-tier
        backlog occupies shared descriptors (full racing ~70%, Fig. 12)."""
        return 1.0 + c * min(1.0, self.slow_backlog() / pool)

    def advance(self, dt_ns: float) -> None:
        """Move the simulated clock; retire completed transfers; fire MIKU
        windows (via the control loop) on schedule, in time order."""
        target = self.now + dt_ns
        while True:
            next_evt = min(
                [f.t_complete for f in self._inflight if f.t_complete <= target],
                default=None,
            )
            nw = self.control.next_window_ns
            boundary = nw if nw <= target else None
            if next_evt is None and boundary is None:
                break
            if boundary is not None and (next_evt is None or boundary <= next_evt):
                self.now = boundary
                self.control.fire()
            else:
                self.now = next_evt  # type: ignore[assignment]
                done = [f for f in self._inflight if f.t_complete <= self.now]
                self._inflight = [
                    f for f in self._inflight if f.t_complete > self.now
                ]
                for f in done:
                    self.counters[f.tier].record(f.op, f.t_complete - f.t_enqueue)
                    if self._san is not None:
                        self._san.on_complete(f.tier, f.nbytes)
        self.now = target
        if self._san is not None:
            self._san.check(self)

    def idle_advance(
        self, dt_ns: float, until: float, max_steps: int,
        on_run: Optional[Callable[[float, int, int], None]] = None,
    ) -> int:
        """Take ``advance(dt_ns)`` steps while ``now < until``, at most
        ``max_steps``; returns the number taken.  The result is exactly
        that of the same number of ``advance`` calls: a step with no
        completion and no window boundary inside it only moves the clock,
        and that case skips the event scan (and the sanitizer's check,
        which would see what it saw last).

        ``on_run(t_first, n, backlog)`` receives the steps as runs of ``n``
        over which :meth:`slow_backlog` after each step stays the same: the
        clock after the run's first step and that backlog.  It changes only where a transfer completes or a capped
        chunk's enqueue time passes."""
        inf = math.inf
        steps = 0
        next_evt = min((f.t_complete for f in self._inflight), default=inf)
        next_enq = self._next_enqueue() if on_run is not None else inf
        backlog = self.slow_backlog() if on_run is not None else 0
        run_t0, run_n = 0.0, 0
        while steps < max_steps and self.now < until:
            target = self.now + dt_ns
            if target >= next_evt or target >= self.control.next_window_ns:
                self.advance(dt_ns)
                next_evt = min((f.t_complete for f in self._inflight), default=inf)
                moved = True
            else:
                self.now = target
                moved = target >= next_enq
            steps += 1
            if on_run is None:
                continue
            if moved:
                next_enq = self._next_enqueue()
                b = self.slow_backlog()
                if b != backlog and run_n:
                    on_run(run_t0, run_n, backlog)
                    run_n = 0
                backlog = b
            if run_n == 0:
                run_t0 = self.now
            run_n += 1
        if run_n:
            on_run(run_t0, run_n, backlog)
        return steps

    def _next_enqueue(self) -> float:
        """The earliest enqueue time still ahead of the clock."""
        return min((f.t_enqueue for f in self._inflight if f.t_enqueue > self.now),
                   default=math.inf)
