"""Sweep entry point: many independent simulated-testbed cells.

A copy of ``repro.memsim.sweep``: :class:`SimJob` is the picklable
description of one cell and :func:`run_sweep` runs a batch on one of two
lanes.  ``lane="batched"`` (the port's default) stacks the grid into the
window-lockstep lane of :mod:`repro_torch.memsim.batched` on a device;
``lane="scalar"`` runs one event-driven DES
(:class:`~repro_torch.core.des.TieredMemorySim`) per job on the host,
serially or over a process pool, with results in job order and equal to
the reference's scalar lane bit for bit.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence

from repro_torch.core.des import SimResult, TieredMemorySim, WorkloadSpec, validate_workloads
from repro_torch.core.device_model import PlatformModel
from repro_torch.obs.metrics import PhaseProfiler, default_registry


@dataclasses.dataclass
class SimJob:
    """One independent simulation cell (picklable)."""

    platform: PlatformModel
    workloads: List[WorkloadSpec]
    sim_ns: float
    #: The scalar DES's seed; the batched lane is deterministic and reads none.
    seed: int = 0
    granularity: int = 4
    window_ns: float = 10_000.0
    #: Build a platform-calibrated MIKU controller for the cell.
    miku: bool = False
    miku_overrides: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Which decision law ``miku=True`` builds: "pertier" (one ladder per
    #: slow tier, the default), "merged" (one ladder over the folded slow
    #: tiers, its decision broadcast) or "peredge".  Both lanes refuse
    #: "peredge": it needs the fabric, not ported (ROADMAP A.4.2).
    miku_law: str = "pertier"
    #: Per-window telemetry records (``SimResult.window_records``) and
    #: latency histograms.
    record_windows: bool = False
    latency_hist: bool = False
    #: Optional :class:`repro_torch.tiering.TieringSpec`: each run builds a
    #: fresh hook from it (pages, migration engine, policy).
    tiering: Optional[object] = None
    #: Record a wall-clock phase profile (setup, event loop, window passes)
    #: into ``SimResult.profile`` (scalar lane only).
    profile: bool = False

    def __post_init__(self):
        validate_workloads(self.platform, self.workloads)
        if self.miku_law not in ("pertier", "merged", "peredge"):
            raise ValueError(
                f"unknown miku_law {self.miku_law!r}; "
                "expected 'pertier', 'merged' or 'peredge'"
            )


PEREDGE_REFUSAL = ("miku_law='peredge' needs the fabric, which is not ported "
                   "(ROADMAP A.4.2)")


def run_job(job: SimJob) -> SimResult:
    """Run one job on the scalar DES (the pool's worker entry point)."""
    controller = None
    if job.miku:
        if job.miku_law == "peredge":
            raise NotImplementedError(PEREDGE_REFUSAL)
        from repro_torch.memsim.calibration import default_miku, merged_miku

        build = merged_miku if job.miku_law == "merged" else default_miku
        controller = build(job.platform, job.granularity, **job.miku_overrides)
    prof = None
    if job.profile:
        prof = PhaseProfiler()
        t0 = prof.clock()
    sim = TieredMemorySim(
        job.platform,
        job.workloads,
        seed=job.seed,
        granularity=job.granularity,
        controller=controller,
        window_ns=job.window_ns,
        record_windows=job.record_windows,
        tiering=job.tiering.build() if job.tiering is not None else None,
        latency_hist=job.latency_hist,
        profiler=prof,
    )
    if prof is not None:
        prof.add("setup", prof.clock() - t0)
    return sim.run(job.sim_ns)


def run_sweep(
    jobs: Sequence[SimJob],
    lane: str = "batched",
    device=None,
    processes: Optional[int] = None,
) -> List[SimResult]:
    """Run ``jobs``, results in job order.

    ``lane="batched"`` runs them on ``device`` (the card unless ``"cpu"``);
    the few jobs it cannot stack fall back to the scalar lane.
    ``lane="scalar"`` runs one DES per job on the host (``device`` unused):
    serially when ``processes`` is None or at most 1, else over a pool of
    that many worker processes.  The pool starts its workers with
    ``spawn``, never ``fork``: a forked child of a process that has touched
    CUDA is unsafe.
    """
    if lane not in ("scalar", "batched"):
        raise ValueError(f"unknown sweep lane {lane!r}; expected 'scalar' or 'batched'")
    jobs = list(jobs)
    reg = default_registry()
    reg.counter("sweep.jobs").inc(float(len(jobs)))
    reg.counter(f"sweep.lane.{lane}").inc(float(len(jobs)))
    if lane == "batched":
        from repro_torch.memsim.batched.lane import run_sweep_batched

        return run_sweep_batched(jobs, device=device, processes=processes)
    if processes is None or processes <= 1 or len(jobs) <= 1:
        return [run_job(j) for j in jobs]
    workers = min(processes, len(jobs), os.cpu_count() or 1)
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(run_job, jobs))
