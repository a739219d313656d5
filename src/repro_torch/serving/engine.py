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
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections.abc import Sequence
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.controller import MikuController
from repro_torch.core.littles_law import OpClass
from repro_torch.core.offload import HostOffloader, TransferQueue
from repro_torch.core.tiers import HBM_TIER, host_offload_supported
from repro_torch.models.transformer import DecodeState, ModelConfig, TransformerLM
from repro_torch.obs.metrics import default_registry
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
        # K and V, 2 bytes each, per layer (the reference's constant); a
        # model without attention keeps no KV cache.
        self.kv_bytes_per_token = (2 * cfgm.n_kv_heads * cfgm.head_dim * cfgm.n_layers * 2
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
        self.offloader.to_device(self.params, out=self._staging)
        self.offloader.block()
        return self._staging

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
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
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            plen = len(req.prompt)
            tokens = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
            state1 = self.model.init_decode_state(1, self.cfg.max_len, self.device)
            logits, state1 = self.model.prefill(self.step_params(), tokens, state1)
            first = int(self._sample(logits)[0])
            req.output.append(first)
            req.t_first_token = now_ns
            self._insert_state(slot, state1, plen)
            self._tokens[slot] = first
            self.slot_req[slot] = req
            self._active[slot] = True
            admitted.append((req, plen * self.kv_bytes_per_token))
        return admitted

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

    def decode_once(self, now_ns: float) -> int:
        """One real decode step for all active slots.  Returns #tokens."""
        if self.n_active == 0:
            return 0
        logits, self.state = self.model.decode_step(self.step_params(), self.state,
                                                    self._tokens)
        self.decode_steps += 1
        self._tokens = self._sample(logits)
        nxt = self._tokens.tolist()
        lengths = self.state.length.tolist()
        produced = 0
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
        tick = 0
        produced: Dict[str, int] = {e.cfg.name: 0 for e in self.engines}
        started: Dict[str, Optional[float]] = {e.cfg.name: None for e in self.engines}
        finished_at: Dict[str, float] = {e.cfg.name: 0.0 for e in self.engines}
        while tick < max_ticks and not all(e.finished for e in self.engines):
            until = self._idle_until()
            if q.now < until:
                # Host engines wait on their streams: run the no-op ticks
                # in one call, with the same clock arithmetic.
                tick += q.idle_advance(
                    1e3, until, max_ticks - tick,
                    on_run=lambda t0, n, b: self.timeline.add_run(t0, 1e3, n, b, produced))
                continue
            tick += 1
            fast_time = 0.0
            for eng in self.engines:
                eng.admit(q.now)
                if eng.n_active == 0:
                    continue
                name = eng.cfg.name
                if started[name] is None:
                    started[name] = q.now
                if eng.cfg.placement == "host":
                    # One decode step = one weight/KV stream over the slow
                    # link, submitted as per-layer chunks; a MIKU cap bounds
                    # the descriptors it holds at no throughput cost.
                    if q.now < self._host_busy_until[name]:
                        continue
                    wb, kvb = eng.step_bytes()
                    n_chunks = eng.cfg.stream_chunks or 2 * eng.cfg.model.n_layers
                    # A KV PageMap keeps the hot share of the KV stream on
                    # the device path, costed as a device engine's bytes
                    # (fast_penalty included); only the rest crosses the
                    # link, and the step completes when both paths have.
                    kv_fast, kv_slow = eng.kv_tier_bytes(kvb)
                    fast_dur = 0.0
                    if kv_fast:
                        fast_dur = kv_fast / self.hbm_bw * q.fast_penalty()
                        q.account_fast(kv_fast, fast_dur, OpClass.LOAD)
                        fast_time += fast_dur
                    done_t = q.submit_slow_stream(wb + kv_slow, n_chunks, OpClass.LOAD,
                                                  tier="slow")
                    done_t = max(done_t, q.now + fast_dur)
                    self._host_busy_until[name] = done_t
                    n = eng.decode_once(done_t)
                    finished_at[name] = done_t
                else:
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
            q.advance(dt)
            self.timeline.add_run(q.now, dt, 1, q.slow_backlog(), produced)
        out: Dict[str, Dict[str, float]] = {}
        reg = default_registry()
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
            reg.counter("serving.tokens").inc(float(toks))
            reg.counter("serving.requests").inc(float(len(eng.done)))
        return out
