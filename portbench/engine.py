"""Real-clock stamps at the engine's call boundaries.

:class:`TimedEngine` is a ``ServingEngine`` of the port that records, on the
host clock (``time.perf_counter``), each request's submission, its first
token (stamped when ``admit`` has read it back to the host, just before the
slot takes the prefill's state), each later token (when ``decode_once`` has
read the step's tokens back), and the spans of ``admit``, ``decode_once``
and ``step_params``.  A host-placed engine's ``step_params`` issues the
copy of every weight device-ward on a side stream and returns; the step's
kernels wait for the copy on the device, so the step's wall holds the
copy's device time.  That time, read from the offloader's CUDA events once
the step has read its result back, is kept apart (``staged``, and each
staging span runs from the copy's issue for that long) so that the
engine's and the model step's metrics leave it to the host tier's.  A
finished request's client submits its next request at once: a closed
loop.  The engine reports itself finished when the
:class:`Recorder` closes the window, so ``TieredServingCluster.run`` returns
on the harness's clock.  While a device trace is taken the spans are also
``record_function`` ranges (``engine.prefill``, ``engine.decode``,
``host.h2d``), so idle gaps can be named by what the host was doing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.engine import Request, ServingEngine

clock = time.perf_counter
#: Ticks a traced run profiles after its window, at the least and the most.
PROFILE_TICKS = 3
MAX_PROFILE_TICKS = 64


@dataclasses.dataclass
class Track:
    """One request as the benchmark sees it."""

    engine: int
    client: int
    req: Request
    t_submit: Optional[float]  # None: submitted during set-up
    stamps: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class Span:
    """One call of ``admit`` (whatever it admitted), or one weight copy of
    ``step_params``: from its issue for its device time."""

    engine: int
    t0: float
    t1: float


@dataclasses.dataclass(frozen=True)
class DecodeRec:
    engine: int
    t0: float
    t1: float
    active: Tuple[int, ...]  # cache lengths of the active slots before the step
    lengths: Tuple[int, ...]  # every slot's cache length before the step
    profiled: bool
    staged: float = 0.0  # device time of the step's weight copy (host engines)


@dataclasses.dataclass(frozen=True)
class PrefillRec:
    engine: int
    t0: float
    t1: float
    plen: int
    profiled: bool
    staged: float = 0.0  # device time of the prefill's weight copy (host engines)


class Recorder:
    """The window, the stamps and the spans of one run.

    ``open(seconds)`` starts the window; it closes at ``deadline``, or,
    with a ``profiler`` (an object with ``start()`` and ``stop()``), once
    :data:`PROFILE_TICKS` ticks after the deadline have been profiled with at
    least one prefill and two decode steps among them (at most
    :data:`MAX_PROFILE_TICKS`)."""

    def __init__(self, *, profiler=None):
        self.tracks: Dict[int, Track] = {}
        self.admits: List[Span] = []
        #: Every ``step_params`` of a host engine, by the call it served.
        self.stagings: Dict[str, List[Span]] = {"prefill": [], "decode": []}
        self.decodes: List[DecodeRec] = []
        self.prefills: List[PrefillRec] = []
        self.tick_starts: List[float] = []
        self._rid = itertools.count()
        self.t_open: Optional[float] = None
        self.deadline = float("inf")
        self.profiler = profiler
        self.profiling = False
        self._profiled_ticks = 0
        self._profiled_prefills = 0
        self._profiled_decodes = 0
        self.closed = False

    # -- window ------------------------------------------------------------
    def open(self, seconds: float) -> float:
        self.t_open = clock()
        self.deadline = self.t_open + seconds
        return self.t_open

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_open is not None and self.t_open <= t <= self.deadline

    def check_closed(self) -> bool:
        if self.closed:
            return True
        if self.t_open is None or clock() < self.deadline:
            return False
        if self.profiler is None:
            self.closed = True
        elif self.profiling and (
                self._profiled_ticks >= MAX_PROFILE_TICKS
                or (self._profiled_ticks >= PROFILE_TICKS and self._profiled_prefills >= 1
                    and self._profiled_decodes >= 2)):
            self.profiler.stop()
            self.profiling = False
            self.closed = True
        return self.closed

    def tick(self) -> None:
        """A cluster tick starts (the first engine's ``admit``)."""
        t = clock()
        self.tick_starts.append(t)
        if self.profiler is None or self.t_open is None or t < self.deadline:
            return
        if not self.profiling:
            self.profiler.start()
            self.profiling = True
        self._profiled_ticks += 1

    def submitting(self) -> bool:
        """Clients keep the loop closed until the window closes (through
        the profiled ticks of a traced run)."""
        return not self.closed

    def range(self, name: str):
        if self.profiling:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # -- records -----------------------------------------------------------
    def track(self, req: Request, engine: int, client: int, t_submit: Optional[float]) -> None:
        self.tracks[req.rid] = Track(engine, client, req, t_submit)

    def new_rid(self) -> int:
        return next(self._rid)

    def decode(self, rec: DecodeRec) -> None:
        self.decodes.append(rec)
        if rec.profiled:
            self._profiled_decodes += 1

    def prefill(self, rec: PrefillRec) -> None:
        self.prefills.append(rec)
        if rec.profiled:
            self._profiled_prefills += 1


class TimedEngine(ServingEngine):
    """A ``ServingEngine`` whose calls are stamped and whose clients close
    the loop (see the module docstring)."""

    def __init__(self, cfg, params, *, index: int, rec: Recorder,
                 next_request: Callable[[int], object]):
        super().__init__(cfg, params)
        self.index = index
        self.rec = rec
        self.next_request = next_request
        #: Host mirror of ``state.length``: set by a prefill, +1 a step.
        self.lengths = [0] * cfg.max_slots
        self._firsts: List[Tuple[float, float]] = []  # (first token, staged seconds)
        #: Weight copies issued and not yet read: (issue time, event pairs).
        self._copies: List[Tuple[float, list]] = []

    def submit_spec(self, spec, t_submit: Optional[float]) -> None:
        req = Request(rid=self.rec.new_rid(), prompt=spec.prompt,
                      max_new_tokens=spec.max_new_tokens)
        self.rec.track(req, self.index, spec.client, t_submit)
        self.submit(req)

    @property
    def finished(self) -> bool:
        return self.rec.check_closed() or super().finished

    def step_params(self):
        if self.offloader is None:
            return super().step_params()
        timings = self.offloader._timings  # one (start, end) event pair a copy
        n0 = len(timings)
        t0 = clock()
        with self.rec.range("host.h2d"):
            out = super().step_params()
        self._copies.append((t0, timings[n0:]))
        return out

    def _staged(self, phase: str) -> float:
        """Device seconds of the weight copies issued since the last call,
        each kept as a staging span of ``phase``.  Called once the step has
        read its result back, which waited for the copies: their events
        have ended."""
        total = 0.0
        for t0, pairs in self._copies:
            seconds = 0.0
            for start, end in pairs:
                end.synchronize()
                seconds += start.elapsed_time(end) / 1e3
            self.rec.stagings[phase].append(Span(self.index, t0, t0 + seconds))
            total += seconds
        self._copies = []
        return total

    def _insert_state(self, slot, state1, plen):
        self._firsts.append((clock(), self._staged("prefill")))
        self.lengths[slot] = plen
        super()._insert_state(slot, state1, plen)

    def admit(self, now_ns):
        if self.index == 0:
            self.rec.tick()
        self._firsts = []
        profiled = self.rec.profiling
        t0 = clock()
        with self.rec.range("engine.prefill"):
            out = super().admit(now_ns)
        t1 = clock()
        prev = t0
        for (req, _), (t, staged) in zip(out, self._firsts):
            self.rec.prefill(PrefillRec(self.index, prev, t, len(req.prompt), profiled, staged))
            self.rec.tracks[req.rid].stamps.append(t)
            prev = t
        self.rec.admits.append(Span(self.index, t0, t1))
        return out

    def decode_once(self, now_ns):
        if self.n_active == 0:
            return 0
        slots = [i for i, r in enumerate(self.slot_req) if r is not None]
        reqs = [self.slot_req[i] for i in slots]
        active = tuple(self.lengths[i] for i in slots)
        lengths = tuple(self.lengths)
        n_done = len(self.done)
        profiled = self.rec.profiling
        t0 = clock()
        with self.rec.range("engine.decode"):
            n = super().decode_once(now_ns)
        t1 = clock()
        self.lengths = [x + 1 for x in self.lengths]
        staged = self._staged("decode")
        self.rec.decode(DecodeRec(self.index, t0, t1, active, lengths, profiled, staged))
        for req in reqs:
            self.rec.tracks[req.rid].stamps.append(t1)
        if self.rec.submitting():
            for req in self.done[n_done:]:
                client = self.rec.tracks[req.rid].client
                self.submit_spec(self.next_request(client), t1)
        return n
