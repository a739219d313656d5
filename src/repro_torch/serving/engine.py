"""Batched LLM serving engine with tiered placement and MIKU admission
control — port of ``repro/serving/engine.py`` (the paper's §6 case study).

* :class:`ServingEngine` — one model instance: continuous batching over a
  fixed slot array, real prefill/decode steps, per-slot lengths.  Its
  *placement* decides where weights live: ``device`` (device memory, the
  DDR analogue) or ``host`` (pinned host memory over the host link, the
  CXL analogue).  A host-placed instance on a CUDA device copies its
  weights into one persistent device staging set before every step.
* :class:`TieredServingCluster` — engines sharing one transfer path
  (:class:`~repro_torch.core.offload.TransferQueue`).  Device steps charge
  fast-tier bytes; host steps submit their weight/KV stream as slow-link
  transfers, which a MIKU controller throttles.  An engine given a KV
  PageMap keeps its region's hot KV share on the device path.  Its
  ``timeline`` holds one record a tick, as the reference's does; ``trace=N``
  samples every Nth transfer chunk's spans (``queue.trace_records``).

The cluster's clock is the simulated queue clock with the reference's tier
constants (so its ``tokens_per_s`` is simulated, not measured on the card);
the tokens are real.

Both also record real-clock spans into the process-default
:func:`~repro_torch.obs.metrics.default_profiler` (each a child of the span
open around it): ``serving.tick`` (one working tick of ``run``), in it
``serving.admit`` (an engine's ``admit``) with a ``serving.prefill`` a
request (``.state``: the prompt's upload and the batch-1 state; ``.dispatch``;
``.readback``; ``.insert``),
``serving.account`` (an engine's step accounting on the queue),
``serving.decode`` (``decode_once``: ``.dispatch``, ``.readback``,
``.retire``; its arg ``graph`` says whether the step replayed the engine's
CUDA graph) and ``serving.advance`` (the queue's event scan and the MIKU
windows it fires); ``serving.h2d``, a host-placed engine's issue of its
weight copy, inside the prefill or decode step it serves (the copy runs on
a side stream and the step's stream only waits on it on the device:
``HostOffloader.copy_seconds()`` measures the copy itself); top-level
``serving.idle_advance`` (ticks that only move the clock) and
``serving.queued`` (a request from ``submit`` to its prefill).  A span ends
when its call returns on the host: none waits for the device.  The counters
``serving.tokens`` and ``serving.requests`` of the default registry count
as tokens are produced and requests finish; ``serving.decode.graph_captures``
and ``serving.decode.graph_replays`` count the decode step's graphs.  A
model with the dropless MoE (a mixed stack's ``E`` layers) also reads its
step's MoE counts back with the step's tokens: ``serving.decode`` and
``serving.prefill`` carry ``moe_requests`` (requests routed to the experts
this device holds), ``moe_experts`` (held experts touched) and
``moe_choices`` (tokens x top_k x MoE layers), each summed over the MoE
layers, and the counters ``serving.moe.requests``,
``serving.moe.experts_touched`` and ``serving.moe.choices`` add them up.

An engine on a CUDA device records its decode step, with the greedy
sampler, as one CUDA graph right after its first step, which runs eagerly
and builds the kernels, and replays that graph at every later step: the
same launches on the same buffers, without the host issuing them one by
one.  The step keeps its state, lengths and tokens in fixed buffers, which
``admit`` writes in place.  The step stays eager where no graph can hold
it: on the CPU, and where a leaf of the weights or the state is a DTensor
(its dispatch runs Python for every operator).  A sampler other than greedy
draws eagerly from the graph's logits after each replay.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections.abc import Sequence
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.controller import MikuController
from repro_torch.core.littles_law import OpClass
from repro_torch.core.offload import HostOffloader, TransferQueue
from repro_torch.core.tiers import HBM_TIER, host_offload_supported
from repro_torch.kernels import _nvcc
from repro_torch.models.transformer import DecodeState, ModelConfig, TransformerLM
from repro_torch.obs.metrics import default_profiler, default_registry
from repro_torch.pytree import tree_leaves
from repro_torch.serving import sampler as sampler_lib


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_ns: float = 0.0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    name: str
    model: ModelConfig
    max_slots: int = 8
    max_len: int = 1024
    placement: str = "device"  # "device" | "host" (weights+KV tier)
    sampler: str = "greedy"
    #: fraction of weight bytes streamed per decode step (1.0 = memory-bound)
    weight_stream_fraction: float = 1.0
    #: host-tier transfer chunks per decode step (None => 2 x n_layers)
    stream_chunks: Optional[int] = None


def param_bytes(params: Any) -> int:
    """Bytes of a parameter tree (drives the simulated clock)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


class ServingEngine:
    """One model instance with continuous batching.  The device is that of
    ``params``.

    ``kv_pagemap`` (optional) hands the KV stream's placement to the tiering
    subsystem: a :class:`repro_torch.tiering.PageMap` with a region named
    after this engine.  Instead of the all-or-nothing ``placement`` split,
    each decode step's KV bytes divide between the device path and the host
    link by the region's live access-weighted tier fractions
    (:meth:`kv_tier_bytes`), and the engine feeds the region one access
    sample per decoded token.
    """

    def __init__(self, cfg: EngineConfig, params: Any, *,
                 generator: Optional[torch.Generator] = None,
                 kv_pagemap: Any = None):
        if cfg.model.n_encoder_layers:
            # The reference's engine cannot serve one either: its prefill
            # passes no frames and its slots never receive the cross K/V.
            raise ValueError(f"{cfg.model.name}: the serving engine takes text prompts; an "
                             "encoder-decoder model needs frames for every request")
        self.cfg = cfg
        self.kv_pagemap = kv_pagemap
        self.model = TransformerLM(cfg.model)
        self.device = params["embed"].device
        self.generator = generator
        if generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.param_bytes = param_bytes(params)
        cfgm = cfg.model
        # K and V, 2 bytes each, per attention layer (the reference's
        # constant); a model without attention keeps no KV cache.
        self.kv_bytes_per_token = (2 * cfgm.n_kv_heads * cfgm.head_dim * cfgm.n_attn_layers * 2
                                   if cfgm.uses_attention else 0)
        self._place_state(params)
        self.state = self.model.init_decode_state(cfg.max_slots, cfg.max_len, self.device)
        self.slot_req: List[Optional[Request]] = [None] * cfg.max_slots
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._tokens = torch.zeros(cfg.max_slots, dtype=torch.int32, device=self.device)
        self._active = np.zeros((cfg.max_slots,), bool)
        #: decode steps taken (each runs every layer once)
        self.decode_steps = 0
        #: the last decode step's logits [max_slots, vocab]
        self.logits: Optional[torch.Tensor] = None
        #: the decode step's CUDA graph, once recorded
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        #: the kernel launches one replay makes, by counter
        self._graph_launches: List[Tuple[_nvcc.LaunchCounter, int]] = []
        #: ``submit`` times on the profiler's clock, by ``id`` of the request
        self._submitted: Dict[int, float] = {}
        reg = default_registry()
        self._m_tokens = reg.counter("serving.tokens")
        self._m_requests = reg.counter("serving.requests")
        self._m_captures = reg.counter("serving.decode.graph_captures")
        self._m_replays = reg.counter("serving.decode.graph_replays")
        #: MoE choices a token makes over the layers (0: no dropless MoE)
        self._moe_choices = cfgm.top_k * cfgm.kind_layers("E")
        if self._moe_choices:
            self._m_moe = [reg.counter(f"serving.moe.{n}")
                           for n in ("requests", "experts_touched", "choices")]

    def _place_state(self, params: Any) -> None:
        self.offloader: Optional[HostOffloader] = None
        self.params = params
        if self.cfg.placement == "host" and host_offload_supported(self.device):
            self.offloader = HostOffloader(self.device)
            self.params = self.offloader.to_host(params)
            # One device staging set, allocated once and refilled every step.
            self._staging = self.offloader.to_device(self.params)

    def step_params(self) -> Any:
        """Working copy of the weights for one step.  Host-resident
        instances fetch them device-ward: the host-link stream the transfer
        queue charges."""
        if self.offloader is None:
            return self.params
        with default_profiler().phase("serving.h2d", engine=self.cfg.name):
            self.offloader.to_device(self.params, out=self._staging)
            self.offloader.block()
        return self._staging

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        self._submitted[id(req)] = default_profiler().clock()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _insert_state(self, slot: int, state1: DecodeState, plen: int) -> None:
        """Copy a batch-1 prefill's KV prefix and SSM states into ``slot``."""
        for cache, new in ((self.state.kv, state1.kv), (self.state.ssm, state1.ssm)):
            if cache is not None:
                for name in cache:
                    cache[name][:, slot] = new[name][:, 0]
        self.state.length[slot] = plen

    def admit(self, now_ns: float) -> List[Tuple[Request, int]]:
        """Prefill queued requests into free slots.  Returns admissions
        (request, prompt_bytes_touched)."""
        admitted = []
        prof = default_profiler()
        with prof.phase("serving.admit", engine=self.cfg.name) as span:
            for slot in self._free_slots():
                if not self.queue:
                    break
                req = self.queue.pop(0)
                t_submit = self._submitted.pop(id(req), None)
                plen = len(req.prompt)
                with prof.phase("serving.prefill", rid=req.rid, prompt=plen) as pre:
                    if t_submit is not None:
                        prof.record("serving.queued", t_submit, pre.t0, rid=req.rid,
                                    engine=self.cfg.name)
                    with prof.phase("serving.prefill.state"):
                        tokens = torch.tensor([req.prompt], dtype=torch.int64,
                                              device=self.device)
                        state1 = self.model.init_decode_state(1, self.cfg.max_len, self.device)
                    params = self.step_params()
                    with prof.phase("serving.prefill.dispatch"):
                        logits, state1 = self.model.prefill(params, tokens, state1)
                        sampled = self._sample(logits)
                    with prof.phase("serving.prefill.readback"):
                        first = int(sampled[0])
                        if self._moe_choices:
                            self._moe_args(pre.args, state1.moe, plen)
                    req.output.append(first)
                    req.t_first_token = now_ns
                    with prof.phase("serving.prefill.insert"):
                        self._insert_state(slot, state1, plen)
                        self._tokens[slot] = first
                        self.slot_req[slot] = req
                        self._active[slot] = True
                self._m_tokens.inc()
                admitted.append((req, plen * self.kv_bytes_per_token))
            span.args["admitted"] = len(admitted)
        return admitted

    def _moe_args(self, args: Dict[str, Any], counts: torch.Tensor, tokens: int) -> None:
        """A step's MoE counts, read back, as its span's args and into the
        counters."""
        requests, experts = counts.tolist()
        choices = tokens * self._moe_choices
        args.update(moe_requests=requests, moe_experts=experts, moe_choices=choices)
        for counter, n in zip(self._m_moe, (requests, experts, choices)):
            counter.inc(n)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.sampler == "greedy":
            return sampler_lib.greedy(logits)
        return sampler_lib.temperature(logits, self.generator)

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    def step_bytes(self) -> Tuple[int, int]:
        """(weight_bytes, kv_bytes) one decode step streams."""
        wb = int(self.param_bytes * self.cfg.weight_stream_fraction)
        lengths = self.state.length.tolist()
        kvb = sum(lengths[i] * self.kv_bytes_per_token
                  for i in range(self.cfg.max_slots) if self._active[i])
        return wb, kvb

    def kv_tier_bytes(self, kv_bytes: int) -> Tuple[int, int]:
        """Split one step's KV stream into (fast_bytes, slow_bytes): by the
        static placement without a PageMap region for this engine, else by
        the region's access-weighted fast fraction (the fast share stays on
        the device, only the rest crosses the host link)."""
        if self.kv_pagemap is None or self.cfg.name not in getattr(
                self.kv_pagemap, "regions", {}):
            if self.cfg.placement == "host":
                return 0, kv_bytes
            return kv_bytes, 0
        self.kv_pagemap.record_window(self.cfg.name, float(self.n_active))
        fast = self.kv_pagemap.fast_fraction(self.cfg.name)
        fast_bytes = int(kv_bytes * fast)
        return fast_bytes, kv_bytes - fast_bytes

    def _step(self, params: Any) -> torch.Tensor:
        """The decode step as the engine issues it, eager or recorded:
        ``decode_step`` with its new lengths, and under the greedy sampler
        its new tokens, copied into the engine's fixed buffers; returns the
        logits."""
        logits, state = self.model.decode_step(params, self.state, self._tokens)
        self.state.length.copy_(state.length)
        if self.cfg.sampler == "greedy":
            self._tokens.copy_(sampler_lib.greedy(logits))
        return logits

    def _graphable(self, params: Any) -> bool:
        """Whether a CUDA graph can hold the decode step: every tensor it
        reads on a CUDA device, and none a DTensor."""
        if self.device.type != "cuda":
            return False
        return not any(isinstance(t, DTensor)
                       for t in tree_leaves(params) + tree_leaves(self.state))

    def _capture(self, params: Any) -> None:
        """Record the decode step as one CUDA graph; the recording runs
        nothing.  The launch counters read as before it, and each replay
        adds what the recording counted.  ``logits`` becomes the graph's
        output buffer, holding the last step's logits."""
        counted = [(c, c.count) for c in _nvcc.COUNTERS]
        graph = torch.cuda.CUDAGraph()
        # Recorded on a side stream, as ``torch.cuda.graph`` records, but
        # without its collection and cache flush, which would drop the
        # allocator's warm blocks in the middle of serving.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                logits = self._step(params)
            finally:
                graph.capture_end()
                self._graph_launches = [(c, c.count - n) for c, n in counted if c.count != n]
                for c, n in counted:
                    c.count = n
        logits.copy_(self.logits)
        self._graph, self.logits = graph, logits
        self._m_captures.inc()

    def _replay(self) -> None:
        self._graph.replay()
        for c, n in self._graph_launches:
            c.count += n
        self._m_replays.inc()

    def decode_once(self, now_ns: float) -> int:
        """One real decode step for all active slots.  Returns #tokens."""
        active = self.n_active
        if active == 0:
            return 0
        prof = default_profiler()
        graph = self._graph is not None
        with prof.phase("serving.decode", engine=self.cfg.name, placement=self.cfg.placement,
                        active=active, graph=graph) as span:
            params = self.step_params()
            with prof.phase("serving.decode.dispatch"):
                if graph:
                    self._replay()
                else:
                    self.logits = self._step(params)
                if self.cfg.sampler != "greedy":
                    self._tokens.copy_(self._sample(self.logits))
                if not graph and self._graphable(params):
                    self._capture(params)
                self.decode_steps += 1
            with prof.phase("serving.decode.readback"):
                nxt = self._tokens.tolist()
                lengths = self.state.length.tolist()
                if self._moe_choices:
                    self._moe_args(span.args, self.state.moe, self.cfg.max_slots)
            with prof.phase("serving.decode.retire"):
                produced = finished = 0
                for slot, req in enumerate(self.slot_req):
                    if req is None:
                        continue
                    req.output.append(nxt[slot])
                    produced += 1
                    done = len(req.output) >= req.max_new_tokens
                    overflow = lengths[slot] >= self.cfg.max_len - 1
                    if done or overflow:
                        req.t_done = now_ns
                        self.done.append(req)
                        self.slot_req[slot] = None
                        self._active[slot] = False
                        finished += 1
        self._m_tokens.inc(produced)
        self._m_requests.inc(finished)
        return produced

    @property
    def finished(self) -> bool:
        return not self.queue and self.n_active == 0


class Timeline(Sequence):
    """The cluster's per-tick records, ``{"t_ns", "slow_backlog",
    "tok_<engine>": ...}`` after each tick, as the reference's list holds
    them.  A stretch of ticks that only move the clock by one step, with the
    backlog and token counts unchanged, is kept as one run and expanded on
    read by the clock's own additions: a host engine's stream spans about a
    million such ticks at full width."""

    def __init__(self) -> None:
        #: (t_first, dt, n, backlog, ((engine, tokens), ...))
        self._runs: List[Tuple[float, float, int, int, tuple]] = []
        self._len = 0

    def add_run(self, t_first: float, dt: float, n: int, backlog: int,
                tokens: Dict[str, int]) -> None:
        """``n`` ticks from the clock ``t_first``, each ``dt`` later."""
        self._runs.append((t_first, dt, n, backlog, tuple(tokens.items())))
        self._len += n

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator[Dict[str, float]]:
        for run in self._runs:
            yield from self._expand(run)

    @staticmethod
    def _expand(run) -> Iterator[Dict[str, float]]:
        t, dt, n, backlog, tokens = run
        toks = {f"tok_{k}": float(v) for k, v in tokens}
        for i in range(n):
            if i:
                t = t + dt
            yield {"t_ns": t, "slow_backlog": float(backlog), **toks}

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self)[i]
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError("timeline index out of range")
        for run in self._runs:
            if i < run[2]:
                return next(itertools.islice(self._expand(run), i, None))
            i -= run[2]

    def __eq__(self, other) -> bool:
        if isinstance(other, Timeline) and self._runs == other._runs:
            return True
        if not isinstance(other, (Timeline, list, tuple)):
            return NotImplemented
        return len(other) == self._len and all(a == b for a, b in zip(self, other))


class TieredServingCluster:
    """Co-located engines sharing one chip's transfer path + MIKU control.

    ``run`` drives all engines until completion: each simulated tick every
    admissible engine takes one decode step; host-placed engines first get
    their weight/KV stream admitted by the transfer queue, whose in-flight
    cap and rate are MIKU's decision.  Step durations come from the tier
    bandwidth model (decode is bandwidth-bound, paper §6).
    """

    def __init__(
        self,
        engines: List[ServingEngine],
        *,
        controller: Optional[MikuController] = None,
        window_ns: float = 2e6,
        hbm_bw: float = HBM_TIER.bandwidth_gbps,  # B/ns per chip
        trace: int = 0,
    ):
        self.engines = engines
        self.queue = TransferQueue(controller=controller, window_ns=window_ns, trace=trace)
        self.control = self.queue.control
        self.hbm_bw = hbm_bw
        self.timeline = Timeline()
        self._host_busy_until: Dict[str, float] = {e.cfg.name: 0.0 for e in engines}

    def _idle_until(self) -> float:
        """While the clock is below the returned time, a tick does nothing
        but advance it: no engine can admit, every active engine is a
        host engine waiting for its stream.  ``-inf`` when a tick has work."""
        until = math.inf
        for eng in self.engines:
            if eng.queue and eng._free_slots():
                return -math.inf
            if eng.n_active == 0:
                continue
            if eng.cfg.placement != "host":
                return -math.inf
            until = min(until, self._host_busy_until[eng.cfg.name])
        return until

    def run(self, max_ticks: int = 10_000) -> Dict[str, Dict[str, float]]:
        q = self.queue
        prof = default_profiler()
        # MIKU windows fired, read as deltas around the queue's calls
        windows = default_registry().counter("control.windows")
        tick = 0
        produced: Dict[str, int] = {e.cfg.name: 0 for e in self.engines}
        started: Dict[str, Optional[float]] = {e.cfg.name: None for e in self.engines}
        finished_at: Dict[str, float] = {e.cfg.name: 0.0 for e in self.engines}
        while tick < max_ticks and not all(e.finished for e in self.engines):
            until = self._idle_until()
            if q.now < until:
                # Host engines wait on their streams: run the no-op ticks
                # in one call, with the same clock arithmetic.
                w0 = windows.value
                with prof.phase("serving.idle_advance") as span:
                    n = q.idle_advance(
                        1e3, until, max_ticks - tick,
                        on_run=lambda t0, n, b: self.timeline.add_run(t0, 1e3, n, b, produced))
                    span.args["ticks"] = n
                    span.args["windows"] = int(windows.value - w0)
                tick += n
                continue
            tick += 1
            with prof.phase("serving.tick", tick=tick):
                fast_time = 0.0
                for eng in self.engines:
                    eng.admit(q.now)
                    if eng.n_active == 0:
                        continue
                    name = eng.cfg.name
                    if started[name] is None:
                        started[name] = q.now
                    if eng.cfg.placement == "host":
                        # One decode step = one weight/KV stream over the
                        # slow link, submitted as per-layer chunks; a MIKU
                        # cap bounds the descriptors it holds at no
                        # throughput cost.
                        if q.now < self._host_busy_until[name]:
                            continue
                        with prof.phase("serving.account", engine=name) as span:
                            wb, kvb = eng.step_bytes()
                            n_chunks = eng.cfg.stream_chunks or 2 * eng.cfg.model.n_layers
                            # A KV PageMap keeps the hot share of the KV
                            # stream on the device path, costed as a device
                            # engine's bytes (fast_penalty included); only
                            # the rest crosses the link, and the step
                            # completes when both paths have.
                            kv_fast, kv_slow = eng.kv_tier_bytes(kvb)
                            fast_dur = 0.0
                            if kv_fast:
                                fast_dur = kv_fast / self.hbm_bw * q.fast_penalty()
                                q.account_fast(kv_fast, fast_dur, OpClass.LOAD)
                                fast_time += fast_dur
                            done_t = q.submit_slow_stream(wb + kv_slow, n_chunks,
                                                          OpClass.LOAD, tier="slow")
                            done_t = max(done_t, q.now + fast_dur)
                            self._host_busy_until[name] = done_t
                            span.args["chunks"] = n_chunks
                        n = eng.decode_once(done_t)
                        finished_at[name] = done_t
                    else:
                        with prof.phase("serving.account", engine=name, chunks=0):
                            wb, kvb = eng.step_bytes()
                            dur = (wb + kvb) / self.hbm_bw * q.fast_penalty()
                            q.account_fast(wb + kvb, dur, OpClass.LOAD)
                            fast_time += dur
                        n = eng.decode_once(q.now + dur)
                        finished_at[name] = q.now + dur
                    produced[name] += n
                # Engines on device memory run back to back; host engines
                # progress via queue completions.
                dt = max(fast_time, 1e3)
                w0 = windows.value
                with prof.phase("serving.advance") as span:
                    q.advance(dt)
                    span.args["windows"] = int(windows.value - w0)
                self.timeline.add_run(q.now, dt, 1, q.slow_backlog(), produced)
        out: Dict[str, Dict[str, float]] = {}
        for eng in self.engines:
            name = eng.cfg.name
            toks = sum(len(r.output) for r in eng.done)
            t0 = started[name] or 0.0
            span = max(finished_at[name] - t0, 1.0)
            out[name] = {
                "tokens": float(toks),
                "wall_ns": span,
                "tokens_per_s": toks / span * 1e9,
                "requests": float(len(eng.done)),
            }
        return out
