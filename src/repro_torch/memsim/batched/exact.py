"""Closed-form exact path for single-workload cells (bw-test / lat-test).

A copy of ``repro.memsim.batched.exact``.  A single-workload, single-tier,
controller-free cell is a deterministic closed network: every DES event
time is a float-accumulated chain (``t += service``, ``retire = t +
pipeline``) and completions come in fixed-size cohorts.  Two regimes
reproduce the scalar event loop's counts and times exactly, replaying its
binary-float accumulation in the same operation order:

* **no-queue** (outstanding <= device slots): every request cycles
  issue -> service -> pipeline -> reissue with period ``(t + S) + P``; all
  ``O`` requests share one chain.
* **saturated** (population >= slots x (2 + ceil(P/S))): the device never
  idles; completions are cohorts of ``c`` on the ``t += S`` chain, retires
  ``P`` later, and each retire admits exactly one queued request.

Everything in between goes to the fluid engine.  Bandwidth, completed
counts and timeline buckets are bit-identical to the reference; occupancy
and latency integrals agree to float-summation order.  This is host
bookkeeping in numpy float64: no device work.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.des import LATENCY_RESERVOIR, SimResult, WorkloadStats
from repro_torch.core.invariants import require
from repro_torch.core.littles_law import OpClass, TierCounters
from repro_torch.memsim.batched.stacking import CellPlan
from repro_torch.obs.histogram import LatencyHistogram

_OPS = tuple(OpClass)


def _single_tier(export: dict) -> Optional[int]:
    """The one tier a single-workload cell routes to, or None."""
    frac = export["w_tier_frac"][0]
    hot = [t for t, f in enumerate(frac) if f > 0.0]
    if len(hot) != 1 or abs(frac[hot[0]] - 1.0) > 0.0:
        return None
    return hot[0]


def exact_regime(plan: CellPlan) -> Optional[str]:
    """"noqueue" / "saturated" when the closed form applies, else None."""
    e = plan.export
    if plan.units or len(e["w_names"]) != 1:
        return None
    if e["w_phit"][0] != -1.0 or e["w_phases"][0] is not None:
        return None
    tier = _single_tier(e)
    if tier is None:
        return None
    c = e["st_slots"][tier]
    if c < 1:
        return None
    svc = e["w_svc"][0][tier]
    pipe = e["pipe"][tier]
    O = e["w_cores"][0] * e["w_effmlp"][0]
    N = min(O, e["tor_capacity"])
    # The no-queue cycle needs every outstanding request admitted at once:
    # the device slots and the ToR pool must both cover O.
    if O <= c and O <= e["tor_capacity"]:
        return "noqueue"
    if N >= c * (2 + math.ceil(pipe / max(svc, 1e-12))):
        return "saturated"
    return None


def _chain(sim_ns: float, svc: float, pipe: float,
           per_cycle: bool) -> Tuple[List[float], List[float]]:
    """Replay the DES's float-accumulated event chain: (completion, retire)
    times with retire <= ``sim_ns``.  ``per_cycle`` is the no-queue cycle
    (``t = (t + S) + P``), else the saturated cohort chain (``t += S``,
    retire ``t + P``)."""
    comps: List[float] = []
    rets: List[float] = []
    t = 0.0
    while True:
        t = t + svc
        r = t + pipe if pipe > 0.0 else t
        if r > sim_ns:
            break
        comps.append(t)
        rets.append(r)
        if per_cycle:
            t = r
    return comps, rets


def _timeline(retires: np.ndarray, weights: np.ndarray, sim_ns: float,
              window_ns: float) -> List[Tuple[float, float]]:
    """The DES's window-flushed bandwidth buckets.  A retire exactly at a
    window boundary lands in the next bucket (the window event pops first
    on ties)."""
    bounds: List[float] = []
    t = window_ns
    while t <= sim_ns:  # the DES's accumulated schedule, t += window_ns
        bounds.append(t)
        t += window_ns
    n_flush = len(bounds)
    if n_flush == 0:
        return []
    boundaries = np.asarray(bounds)
    idx = np.searchsorted(boundaries, retires, side="right")
    sums = np.zeros(n_flush)
    valid = idx < n_flush
    np.add.at(sums, idx[valid], weights[valid])
    return [(float(b), float(sums[i])) for i, b in enumerate(boundaries)]


def run_exact(plan: CellPlan) -> SimResult:
    """Run one eligible cell in closed form; see the module docstring."""
    e = plan.export
    regime = exact_regime(plan)
    require(regime is not None, "exact-regime",
            "run_exact called on a cell outside both closed-form regimes; "
            "the lane must route such cells to the fluid engine")
    tier = _single_tier(e)
    sim_ns = float(plan.job.sim_ns)
    window_ns = float(e["window_ns"])
    svc = e["w_svc"][0][tier]
    pipe = e["pipe"][tier]
    nbytes = e["w_bytes"][0][tier]
    c = e["st_slots"][tier]
    O = e["w_cores"][0] * e["w_effmlp"][0]
    N = min(O, e["tor_capacity"])
    op = _OPS[e["w_op"][0]]

    if regime == "noqueue":
        _, rets = _chain(sim_ns, svc, pipe, per_cycle=True)
        K = len(rets)
        completed = O * K
        r = np.asarray(rets)
        issue = np.concatenate(([0.0], r[:-1]))
        res = r - issue  # residency == latency (admission == issue)
        occ = float((O * res).sum())
        last = r[-1] if K else 0.0
        occ_total = occ + O * (sim_ns - last)
        lat_sum = occ
        latencies = np.repeat(res, O)
        tl_ret, tl_w = r, np.full(K, O * nbytes)
        tor_inserts = O + completed
        tor_peak = O
    else:  # saturated
        _, rets = _chain(sim_ns, svc, pipe, per_cycle=False)
        K = len(rets)
        completed = c * K
        r = np.asarray(rets)
        # Admission order: the first N at t=0, then one per retire.
        n_adm = N + completed
        a = np.zeros(n_adm)
        if completed:
            a[N:] = np.repeat(r, c)[: n_adm - N]
        j = np.arange(n_adm)
        cohort = j // c  # service cohort; retires at r[cohort]
        retired = cohort < K
        res = r[cohort[retired]] - a[retired]
        occ = float(res.sum())
        occ_total = occ + float((sim_ns - a[~retired]).sum())
        # Issue (IRQ-entry) times: with O > N the IRQ stages L requests, so
        # admission j was issued when admission j-L freed its IRQ slot.
        L = min(O - N, e["irq_capacity"]) if O > N else 0
        tissue = np.zeros(n_adm)
        if L:
            tissue[N + L:] = a[N: n_adm - L]
        else:
            tissue[N:] = a[N:]
        lat = r[cohort[retired]] - tissue[retired]
        lat_sum = float(lat.sum())
        latencies = lat
        tl_ret, tl_w = r, np.full(K, c * nbytes)
        tor_inserts = N + completed
        tor_peak = N

    st = WorkloadStats()
    st.completed = completed
    st.bytes = float(completed) * nbytes
    st.latency_sum = lat_sum
    st.latency_count = completed
    if completed <= LATENCY_RESERVOIR:
        st.latency_samples = [float(x) for x in latencies]
    else:
        # An evenly spaced subsample stands in for the DES's reservoir
        # (percentiles, not bandwidth, depend on it).
        pick = np.linspace(0, len(latencies) - 1, LATENCY_RESERVOIR)
        st.latency_samples = [float(latencies[int(i)]) for i in pick]
    st.timeline = _timeline(tl_ret, tl_w, sim_ns, window_ns)

    names = e["tier_names"]
    tier_hists = None
    if plan.job.latency_hist:
        # The full latency vector, bucketed directly.
        hist = LatencyHistogram.from_samples(latencies)
        st.latency_hist = hist
        tier_hists = {names[t]: (hist if t == tier else LatencyHistogram())
                      for t in range(e["n_tiers"])}
    tcs = {}
    for t in range(e["n_tiers"]):
        tc = TierCounters()
        if t == tier:
            tc.inserts = completed
            tc.occupancy_time = occ
            tc.class_counts = {o: (completed if o is op else 0) for o in _OPS}
        tcs[names[t]] = tc
    return SimResult(
        sim_ns=sim_ns,
        stats={e["w_names"][0]: st},
        tier_counters=tcs,
        tor_peak=tor_peak,
        tor_occupancy_integral=occ_total,
        tor_inserts=tor_inserts,
        decisions=[],
        per_tier_occupancy_integral={
            names[t]: (occ_total if t == tier else 0.0) for t in range(e["n_tiers"])
        },
        tier_latency_hist=tier_hists,
    )
