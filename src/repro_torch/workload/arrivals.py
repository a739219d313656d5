"""Deterministic arrival-process generators for open-loop workloads (a copy
of ``repro.workload.arrivals``: the same draws in the same order, so every
stream equals the reference's bit for bit).

An :class:`ArrivalSpec` names one process and its parameters; `
:func:`arrival_iter` turns it into an iterator of ``(t_ns, key)`` pairs
with strictly non-decreasing times.  ``key`` is the request's *key
quantile* in ``[0, 1)`` for keyed processes (0.0 is the hottest key —
rank mass under a Zipf(s) law), or ``-1.0`` for unkeyed ones; the DES
routes keyed requests by quantile against the workload's placement
vector (hot keys land on the fast tier) instead of drawing from the
simulation RNG.

Determinism contract (held by tests/test_torch_arrivals.py against the
reference's streams): every generator draws only from a :class:`random.Random` seeded
from ``(stream_seed, spec.seed, kind)`` — no wall-clock, no module-level
``random``, no numpy global state — so the same spec and seeds always
produce the identical arrival stream, and enabling an arrival process
can never perturb the simulation's own random stream.

Process catalog (rates are mean offered rates in requests per ns; one
request is one simulated macro-request):

``poisson``
    Homogeneous Poisson: i.i.d. exponential gaps at ``rate``.
``zipf``
    Poisson times; each arrival carries a key drawn Zipf(``s``) over
    ``n_keys`` ranks, encoded as the rank quantile ``rank / n_keys``.
``bursty``
    On/off periodic: all arrivals land in the first ``duty`` fraction of
    each ``period_ns`` window, as a Poisson stream at ``rate / duty``
    during the burst — the time average is exactly ``rate``.
``diurnal``
    Non-homogeneous Poisson, rate ``rate * (1 + amplitude *
    sin(2*pi*t/period_ns))`` via thinning (exact).
``flash_crowd``
    Piecewise-constant rate: ``rate`` until ``t_step_ns``, ``rate *
    surge`` for ``surge_ns`` (forever when 0), then ``rate`` again;
    exponential gaps restarted at each boundary (exact by
    memorylessness).
``trace``
    Bit-faithful replay of a trace file: one arrival per line,
    ``t_ns[,key]``, ``#`` comments and blank lines skipped; times must
    be non-decreasing.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Iterator, List, Optional, Tuple

__all__ = ["ArrivalSpec", "arrival_iter", "arrival_times", "KINDS"]

KINDS = ("poisson", "zipf", "bursty", "diurnal", "flash_crowd", "trace")

#: Per-kind salt folded into the generator seed so two processes of
#: different kinds never share a stream even with equal seeds.
_KIND_SALT = {k: i * 0x9E3779B1 for i, k in enumerate(KINDS)}


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One open-loop arrival process (picklable, validated at creation)."""

    kind: str
    #: Mean offered rate in requests/ns (macro-requests; unused for trace).
    rate: float = 0.0
    #: Generator stream selector, composed with the simulation seed — two
    #: workloads with equal specs in one sim still get distinct streams.
    seed: int = 0
    # zipf
    s: float = 1.1
    n_keys: int = 1024
    # bursty / diurnal share the period
    period_ns: float = 20_000.0
    duty: float = 0.5
    # diurnal
    amplitude: float = 0.5
    # flash_crowd
    t_step_ns: float = 50_000.0
    surge: float = 4.0
    surge_ns: float = 0.0  # 0.0 = the surge never ends
    # trace replay
    path: Optional[str] = None
    #: Backlog bound: arrivals beyond this queue depth are shed (counted,
    #: never silently dropped).  None = unbounded queue growth.
    queue_limit: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; expected one of "
                f"{', '.join(KINDS)}"
            )
        if self.kind == "trace":
            if not self.path:
                raise ValueError("trace arrivals need path=")
        elif not self.rate > 0.0:
            raise ValueError(
                f"{self.kind} arrivals need rate > 0 (requests/ns), "
                f"got {self.rate}"
            )
        if self.kind == "zipf":
            if self.s <= 0.0:
                raise ValueError(f"zipf skew s must be > 0, got {self.s}")
            if self.n_keys < 1:
                raise ValueError(f"zipf needs n_keys >= 1, got {self.n_keys}")
        if self.kind in ("bursty", "diurnal") and self.period_ns <= 0.0:
            raise ValueError(f"period_ns must be > 0, got {self.period_ns}")
        if self.kind == "bursty" and not (0.0 < self.duty <= 1.0):
            raise ValueError(f"duty must be in (0, 1], got {self.duty}")
        if self.kind == "diurnal" and not (0.0 <= self.amplitude < 1.0):
            raise ValueError(
                f"amplitude must be in [0, 1), got {self.amplitude}"
            )
        if self.kind == "flash_crowd":
            if self.t_step_ns < 0.0:
                raise ValueError("t_step_ns must be >= 0")
            if self.surge <= 0.0:
                raise ValueError(f"surge must be > 0, got {self.surge}")
            if self.surge_ns < 0.0:
                raise ValueError("surge_ns must be >= 0")
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1 (or None), got {self.queue_limit}"
            )


def _rng(spec: ArrivalSpec, stream_seed: int) -> random.Random:
    """Dedicated per-(spec, stream) RNG — never the simulation's."""
    mixed = (
        (stream_seed & 0xFFFFFFFF) * 0x85EBCA77
        ^ (spec.seed & 0xFFFFFFFF) * 0xC2B2AE35
        ^ _KIND_SALT[spec.kind]
    ) & 0xFFFFFFFFFFFFFFFF
    return random.Random(mixed)


def _poisson(spec: ArrivalSpec, stream_seed: int) -> Iterator[
        Tuple[float, float]]:
    rng = _rng(spec, stream_seed)
    expo = rng.expovariate
    rate = spec.rate
    t = 0.0
    while True:
        t += expo(rate)
        yield (t, -1.0)


def _zipf_cum(s: float, n_keys: int) -> List[float]:
    """Cumulative normalized Zipf(s) rank weights (rank 0 hottest)."""
    acc = 0.0
    cum: List[float] = []
    for r in range(n_keys):
        acc += 1.0 / (r + 1) ** s
        cum.append(acc)
    return [c / acc for c in cum]


def _zipf(spec: ArrivalSpec, stream_seed: int) -> Iterator[
        Tuple[float, float]]:
    rng = _rng(spec, stream_seed)
    expo, unif = rng.expovariate, rng.random
    rate = spec.rate
    cum = _zipf_cum(spec.s, spec.n_keys)
    n_keys = spec.n_keys
    t = 0.0
    while True:
        t += expo(rate)
        rank = bisect.bisect_right(cum, unif())
        yield (t, min(rank, n_keys - 1) / n_keys)


def _bursty(spec: ArrivalSpec, stream_seed: int) -> Iterator[
        Tuple[float, float]]:
    # Homogeneous Poisson on the *active* timeline at rate/duty, mapped
    # onto the first duty*period of each period — duty-cycle conservation
    # by construction, time-average rate exactly spec.rate.
    rng = _rng(spec, stream_seed)
    expo = rng.expovariate
    burst_rate = spec.rate / spec.duty
    on_ns = spec.duty * spec.period_ns
    period = spec.period_ns
    a = 0.0  # active-time clock
    while True:
        a += expo(burst_rate)
        k, frac = divmod(a, on_ns)
        yield (k * period + frac, -1.0)


def _diurnal(spec: ArrivalSpec, stream_seed: int) -> Iterator[
        Tuple[float, float]]:
    # Thinning (Lewis-Shedler): candidates at the envelope rate
    # rate*(1+amplitude), accepted with probability rate(t)/envelope.
    rng = _rng(spec, stream_seed)
    expo, unif = rng.expovariate, rng.random
    rate, amp = spec.rate, spec.amplitude
    envelope = rate * (1.0 + amp)
    omega = 2.0 * math.pi / spec.period_ns
    t = 0.0
    while True:
        t += expo(envelope)
        lam = rate * (1.0 + amp * math.sin(omega * t))
        if unif() * envelope < lam:
            yield (t, -1.0)


def _flash_crowd(spec: ArrivalSpec, stream_seed: int) -> Iterator[
        Tuple[float, float]]:
    rng = _rng(spec, stream_seed)
    expo = rng.expovariate
    base = spec.rate
    hi = spec.rate * spec.surge
    t0 = spec.t_step_ns
    t1 = math.inf if spec.surge_ns == 0.0 else t0 + spec.surge_ns
    t = 0.0
    while True:
        # Piecewise-constant rate; restarting the exponential at each
        # boundary is exact (memorylessness).
        rate = hi if t0 <= t < t1 else base
        nxt = t + expo(rate)
        boundary = t0 if t < t0 else (t1 if t < t1 else math.inf)
        if nxt >= boundary:
            t = boundary
            continue
        t = nxt
        yield (t, -1.0)


def _trace(spec: ArrivalSpec, stream_seed: int) -> Iterator[
        Tuple[float, float]]:
    del stream_seed  # replay draws nothing
    prev = -math.inf
    with open(spec.path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            text = line.strip()
            if not text or text.startswith("#"):
                continue
            parts = text.split(",")
            try:
                t = float(parts[0])
                key = float(parts[1]) if len(parts) > 1 else -1.0
            except (ValueError, IndexError):
                raise ValueError(
                    f"{spec.path}:{lineno}: expected 't_ns[,key]', "
                    f"got {text!r}"
                ) from None
            if t < prev:
                raise ValueError(
                    f"{spec.path}:{lineno}: arrival times must be "
                    f"non-decreasing ({t} after {prev})"
                )
            prev = t
            yield (t, key)


_GENERATORS = {
    "poisson": _poisson,
    "zipf": _zipf,
    "bursty": _bursty,
    "diurnal": _diurnal,
    "flash_crowd": _flash_crowd,
    "trace": _trace,
}


def arrival_iter(
    spec: ArrivalSpec, stream_seed: int = 0
) -> Iterator[Tuple[float, float]]:
    """The (t_ns, key) arrival stream for ``spec``.

    ``stream_seed`` is the host's stream selector (the DES passes a value
    derived from the simulation seed and the workload index); the same
    ``(spec, stream_seed)`` always yields the identical stream.
    """
    return _GENERATORS[spec.kind](spec, stream_seed)


def arrival_times(
    spec: ArrivalSpec,
    *,
    stream_seed: int = 0,
    horizon_ns: Optional[float] = None,
    limit: Optional[int] = None,
) -> List[Tuple[float, float]]:
    """Materialize the stream up to a horizon and/or a count (test aid)."""
    if horizon_ns is None and limit is None:
        raise ValueError("arrival_times needs horizon_ns and/or limit")
    out: List[Tuple[float, float]] = []
    for t, key in arrival_iter(spec, stream_seed):
        if horizon_ns is not None and t > horizon_ns:
            break
        out.append((t, key))
        if limit is not None and len(out) >= limit:
            break
    return out
