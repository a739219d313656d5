"""Lane entry points: screen a job list, stack it, run it on one device.

A port of ``repro.memsim.batched.lane``.  Single-workload cells in one of
the two closed-form regimes take the exact lane
(:mod:`~repro_torch.memsim.batched.exact`, host numpy); the rest stack
into window-lockstep fluid groups, one group per (window cadence, ladder
rung table) pair, each chunked into blocks of at most ``block`` cells.
The per-tier and merged MIKU laws, per-window telemetry
(``record_windows``) and vector tiering (a job's ``tiering`` spec, stacked
per group by :func:`~repro_torch.memsim.batched.tiering.build_tiering`)
run here.  The reference falls jobs it cannot stack back to the scalar DES;
the port has no scalar DES yet, so :func:`run_sweep_batched` raises
``NotImplementedError`` for them instead, naming each job and its reason:
the per-edge law (it needs the fabric); and stacking a group raises it for
a tiering policy outside ``static``, ``hotness_lru`` and
``miku_coordinated``, naming the policy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core.des import SimResult
from repro_torch.device import resolve_device
from repro_torch.memsim.batched import exact
from repro_torch.memsim.batched.stacking import BatchGroup, CellPlan, plan_cell
from repro_torch.memsim.batched.tiering import build_tiering

#: (plans aligned with the job list — None where the job cannot run here,
#:  [(job_index, reason), ...] for those jobs)
Partition = Tuple[List[Optional[CellPlan]], List[Tuple[int, str]]]

_DEFAULT_BLOCK = 1024


def can_batch(job) -> Optional[str]:
    """Static screen: why the port's batched lane cannot run ``job``, or
    None when it can."""
    if job.miku and job.miku_law == "peredge":
        return "miku_law='peredge' (the per-edge law needs the fabric, not ported)"
    return None


def partition_jobs(jobs: Sequence) -> Partition:
    """Split ``jobs`` into cell plans and the jobs the port cannot run."""
    plans: List[Optional[CellPlan]] = []
    refused: List[Tuple[int, str]] = []
    for i, job in enumerate(jobs):
        reason = can_batch(job)
        if reason is None:
            plans.append(plan_cell(job))
            continue
        plans.append(None)
        refused.append((i, reason))
    return plans, refused


def run_sweep_batched(
    jobs: Sequence,
    device=None,
    block: int = _DEFAULT_BLOCK,
) -> List[SimResult]:
    """Run ``jobs`` through the batched lane, results in job order: exact
    cells in closed form on the host, the rest through the fluid engine on
    ``device`` (the card unless ``"cpu"``), grouped by window cadence and
    ladder rung table and chunked at ``block`` cells.  Raises
    ``NotImplementedError`` for jobs the port cannot run yet."""
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
    results: List[Optional[SimResult]] = [None] * len(jobs)
    by_key: dict = {}
    for i, plan in enumerate(plans):
        if exact.exact_regime(plan) is not None:
            results[i] = exact.run_exact(plan)
            continue
        levels = tuple(plan.units[0].config.levels) if plan.units else ()
        key = (float(plan.export["window_ns"]), levels)
        by_key.setdefault(key, []).append((i, plan))
    block = max(1, int(block))
    for _, cells in sorted(by_key.items()):
        for lo in range(0, len(cells), block):
            group = BatchGroup(cells[lo:lo + block])
            ladder = fluid_mod.build_ladder(group, dev)
            tiering = build_tiering(group)
            for idx, res in zip(group.indices,
                                fluid_mod.run_fluid(group, ladder, dev, tiering)):
                results[idx] = res
    return results  # type: ignore[return-value]
