"""Lane entry points: partition a job list, run it batched, fall back scalar.

A port of ``repro.memsim.batched.lane``.  Single-workload cells in one of
the two closed-form regimes take the exact lane
(:mod:`~repro_torch.memsim.batched.exact`, host numpy); the rest stack
into window-lockstep fluid groups on one device, one group per (window
cadence, ladder rung table) pair, each chunked into blocks of at most
``block`` cells.  The per-tier and merged MIKU laws, per-window telemetry
(``record_windows``) and vector tiering (a job's ``tiering`` spec, stacked
per group by :func:`~repro_torch.memsim.batched.tiering.build_tiering`)
run here.

Fallbacks are the exception: a job whose plan or stack is inexpressible
(a tiering policy the vector twin cannot run, a cell whose units mix rung
tables) reruns on the scalar DES (``run_sweep(lane="scalar")``).  A group
that fails to stack is re-stacked cell by cell, so one such cell never
drags its group-mates along, and every fallback is recorded as an
``(index, reason)`` pair.  Four kinds of job fall back by name at the
static screen (:func:`can_batch`), as in the reference:
``"fabric_topology"`` (a platform whose routes cross ports, or the
per-edge law), ``"sanitize"`` (the runtime sanitizer), ``"arrival"`` (an
open-loop workload) and ``"trace"`` (sampled request spans).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.des import SimResult
from repro_torch.core.invariants import require, sanitize_enabled
from repro_torch.device import resolve_device
from repro_torch.memsim.batched import exact
from repro_torch.memsim.batched.stacking import BatchGroup, CellPlan, plan_cell
from repro_torch.memsim.batched.tiering import build_tiering

#: (plans aligned with the job list — None where the job falls back,
#:  [(job_index, reason), ...] for the fallbacks)
Partition = Tuple[List[Optional[CellPlan]], List[Tuple[int, str]]]

#: Cells per stacked fluid group: chunking caps the stacked arrays' memory
#: (cells x workloads x stations, and cells x regions x pages with tiering).
_DEFAULT_BLOCK = 1024


def batch_block() -> int:
    """The configured chunk size (``REPRO_BATCH_BLOCK``, default 1024)."""
    try:
        return max(1, int(os.environ.get("REPRO_BATCH_BLOCK", _DEFAULT_BLOCK)))
    except ValueError:
        return _DEFAULT_BLOCK


def can_batch(job) -> Optional[str]:
    """Static screen: why the batched lane cannot run ``job``, or None
    when it can.

    A platform whose topology puts a port-bearing link on some route needs
    the scalar DES's hop stations and backpressure, and so does the
    per-edge law built for such routes, even on a hopless platform: both
    give ``"fabric_topology"``.  An all-transparent topology (``A-direct``)
    has no hops and batches normally.  A sanitized job gives ``"sanitize"``:
    the lane has no event stream or queue state to check (``sanitize=None``
    reads ``REPRO_SANITIZE``; an explicit False opts back in).  An open-loop
    workload gives ``"arrival"``: its backlog and shedding have no fluid
    counterpart.  A traced job gives ``"trace"``: span chains are events.
    The reasons are checked in this order."""
    fabric = getattr(job.platform, "fabric", None)
    if fabric is not None and fabric.has_hops:
        return "fabric_topology"
    if job.miku and job.miku_law == "peredge":
        return "fabric_topology"
    san = job.sanitize
    if san is None:
        san = sanitize_enabled()
    if san:
        return "sanitize"
    if any(w.arrival is not None for w in job.workloads):
        return "arrival"
    if job.trace:
        return "trace"
    return None


def partition_jobs(jobs: Sequence) -> Partition:
    """Split ``jobs`` into batchable cell plans and scalar fallbacks (a
    plan that raises ``ValueError`` falls back with its message)."""
    plans: List[Optional[CellPlan]] = []
    fallbacks: List[Tuple[int, str]] = []
    for i, job in enumerate(jobs):
        reason = can_batch(job)
        if reason is None:
            try:
                plans.append(plan_cell(job))
                continue
            except ValueError as ex:
                reason = str(ex)
        plans.append(None)
        fallbacks.append((i, reason))
    return plans, fallbacks


def run_sweep_batched(
    jobs: Sequence,
    device=None,
    block: Optional[int] = None,
    partition: Optional[Partition] = None,
    processes: Optional[int] = None,
) -> List[SimResult]:
    """Run ``jobs`` through the batched lane, results in job order: exact
    cells in closed form on the host, the rest through the fluid engine on
    ``device`` (the card unless ``"cpu"``), grouped by window cadence and
    ladder rung table and chunked at ``block`` cells (None reads
    :func:`batch_block`).  Fallback jobs run on
    the scalar lane (over ``processes`` workers when that says so), and a
    group's stacking failures are appended to ``partition``'s fallback list,
    so a caller holding it sees every fallback."""
    from repro_torch.memsim.batched import fluid as fluid_mod
    from repro_torch.memsim.sweep import run_sweep

    dev = resolve_device(device)
    jobs = list(jobs)
    plans, fallbacks = partition if partition is not None else partition_jobs(jobs)
    results: List[Optional[SimResult]] = [None] * len(jobs)
    by_key: dict = {}
    for i, plan in enumerate(plans):
        if plan is None:
            continue
        if exact.exact_regime(plan) is not None:
            results[i] = exact.run_exact(plan)
            continue
        levels = tuple(plan.units[0].config.levels) if plan.units else ()
        key = (float(plan.export["window_ns"]), levels)
        by_key.setdefault(key, []).append((i, plan))

    def stack(cells):
        # Stacking (the arrays, the vector ladder and tiering) is the part
        # that may refuse a group; the net stays that narrow, so a failure
        # running the fluid engine surfaces instead of rerunning scalar.
        group = BatchGroup(cells)
        return group, fluid_mod.build_ladder(group, dev), build_tiering(group)

    scalar_idxs: List[int] = []
    block = batch_block() if block is None else max(1, int(block))
    for _, cells in sorted(by_key.items()):
        for lo in range(0, len(cells), block):
            chunk = cells[lo:lo + block]
            try:
                stacks = [stack(chunk)]
            except ValueError:
                stacks = []
                for cell in chunk:
                    try:
                        stacks.append(stack([cell]))
                    except ValueError as ex:
                        scalar_idxs.append(cell[0])
                        fallbacks.append((cell[0], f"group stacking failed: {ex}"))
            for group, ladder, tiering in stacks:
                for idx, res in zip(group.indices,
                                    fluid_mod.run_fluid(group, ladder, dev, tiering)):
                    results[idx] = res
    scalar_idxs.extend(i for i, plan in enumerate(plans) if plan is None)
    if scalar_idxs:
        for idx, res in zip(scalar_idxs, run_sweep([jobs[i] for i in scalar_idxs],
                                                   lane="scalar", processes=processes)):
            results[idx] = res
    require(
        all(r is not None for r in results),
        "lane-total",
        "batched lane dropped jobs: every job must land a result via the "
        "exact, fluid, or scalar-fallback path",
        missing=[i for i, r in enumerate(results) if r is None],
    )
    return results  # type: ignore[return-value]
