"""Lane entry points: screen a job list, stack it, run it on one device.

A port of ``repro.memsim.batched.lane``.  Cells stack into window-lockstep
fluid groups, one group per (window cadence, ladder rung table) pair, each
chunked into blocks of at most ``block`` cells.  The reference falls jobs
it cannot stack back to the scalar DES; the port has no scalar DES yet, so
:func:`run_sweep_batched` raises ``NotImplementedError`` for them instead,
naming each job and its reason.  Not ported yet: the exact closed form for
single-workload cells (``memsim/batched/exact.py``), vector tiering,
per-window telemetry, latency histograms and the merged law.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.des import SimResult
from repro_torch.device import resolve_device
from repro_torch.memsim.batched.stacking import BatchGroup, CellPlan, plan_cell

#: (plans aligned with the job list — None where the job cannot run here,
#:  [(job_index, reason), ...] for those jobs)
Partition = Tuple[List[Optional[CellPlan]], List[Tuple[int, str]]]

_DEFAULT_BLOCK = 1024


def can_batch(job) -> Optional[str]:
    """Static screen: why the port's batched lane cannot run ``job``, or
    None when it can."""
    if job.miku and job.miku_law != "pertier":
        return f"miku_law={job.miku_law!r} (only the per-tier law is ported)"
    if job.record_windows:
        return "record_windows (per-window telemetry is not ported)"
    if job.latency_hist:
        return "latency_hist (fluid latency histograms are not ported)"
    return None


def exact_regime(plan: CellPlan) -> Optional[str]:
    """"noqueue" / "saturated" where the reference runs the cell on its
    exact closed form (``repro/memsim/batched/exact.py``), else None."""
    e = plan.export
    if plan.units or len(e["w_names"]) != 1:
        return None
    if e["w_phit"][0] != -1.0 or e["w_phases"][0] is not None:
        return None
    frac = e["w_tier_frac"][0]
    hot = [t for t, f in enumerate(frac) if f > 0.0]
    if len(hot) != 1 or abs(frac[hot[0]] - 1.0) > 0.0:
        return None
    tier = hot[0]
    c = e["st_slots"][tier]
    if c < 1:
        return None
    svc = e["w_svc"][0][tier]
    pipe = e["pipe"][tier]
    O = e["w_cores"][0] * e["w_effmlp"][0]
    if O <= c and O <= e["tor_capacity"]:
        return "noqueue"
    if min(O, e["tor_capacity"]) >= c * (2 + math.ceil(pipe / max(svc, 1e-12))):
        return "saturated"
    return None


def partition_jobs(jobs: Sequence) -> Partition:
    """Split ``jobs`` into cell plans and the jobs the port cannot run."""
    plans: List[Optional[CellPlan]] = []
    refused: List[Tuple[int, str]] = []
    for i, job in enumerate(jobs):
        reason = can_batch(job)
        if reason is None:
            plan = plan_cell(job)
            regime = exact_regime(plan)
            if regime is None:
                plans.append(plan)
                continue
            reason = (f"single-workload {regime} cell (the exact lane, "
                      "memsim/batched/exact.py, is not ported)")
        plans.append(None)
        refused.append((i, reason))
    return plans, refused


def run_sweep_batched(
    jobs: Sequence,
    device=None,
    block: int = _DEFAULT_BLOCK,
) -> List[SimResult]:
    """Run ``jobs`` through the fluid lane on ``device`` (the card unless
    ``"cpu"``), results in job order.  Groups by window cadence and ladder
    rung table, chunked at ``block`` cells; raises ``NotImplementedError``
    for jobs the port cannot run yet."""
    from repro_torch.memsim.batched import fluid as fluid_mod

    dev = resolve_device(device)
    jobs = list(jobs)
    plans, refused = partition_jobs(jobs)
    if refused:
        raise NotImplementedError(
            "the port's batched lane cannot run these jobs yet (no scalar "
            "fallback is ported): "
            + "; ".join(f"job {i}: {r}" for i, r in refused)
        )
    by_key: dict = {}
    for i, plan in enumerate(plans):
        levels = tuple(plan.units[0].config.levels) if plan.units else ()
        key = (float(plan.export["window_ns"]), levels)
        by_key.setdefault(key, []).append((i, plan))
    results: List[Optional[SimResult]] = [None] * len(jobs)
    block = max(1, int(block))
    for _, cells in sorted(by_key.items()):
        for lo in range(0, len(cells), block):
            group = BatchGroup(cells[lo:lo + block])
            ladder = fluid_mod.build_ladder(group, dev)
            for idx, res in zip(group.indices,
                                fluid_mod.run_fluid(group, ladder, dev)):
                results[idx] = res
    return results  # type: ignore[return-value]
