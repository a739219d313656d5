"""Stack SimJobs into the batched lane's array form (a copy of
``repro.memsim.batched.stacking``).

One :class:`CellPlan` per job: the job's exported static state
(:func:`repro_torch.core.des.export_state`; with a tiering spec, the
migration workloads and the bound :class:`~repro_torch.tiering.TieringHook`
included) plus its calibrated MIKU units,
built through :func:`repro_torch.memsim.calibration.default_miku` (one unit
per slow tier) or :func:`~repro_torch.memsim.calibration.merged_miku` (one
merged unit) so the ladder is calibrated exactly as a scalar controller
would be.
:class:`BatchGroup` holds the padded float64 ``(cells, workloads,
stations)`` arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.des import export_state
from repro_torch.memsim.sweep import PEREDGE_REFUSAL, SimJob


@dataclasses.dataclass
class CellPlan:
    """One job, ready for stacking: exported state + MIKU units."""

    job: SimJob
    export: dict
    #: Per-slow-tier SlowTierMiku units (empty = no controller).  For a
    #: merged-law cell this is the single merged ladder, and ``merged``
    #: says that its decision broadcasts to every slow tier.
    units: list
    merged: bool = False
    #: The job's bound :class:`~repro_torch.tiering.hook.TieringHook` (None
    #: without a tiering spec): the PageMap, engine and policy state that
    #: :class:`~repro_torch.memsim.batched.tiering.VectorTiering` stacks.
    tiering: object = None


def plan_cell(job: SimJob) -> CellPlan:
    """Export the job's static state and build its controller units; a job
    with a tiering spec builds and binds its hook here, so the export
    carries the migration workloads (gated closed) and the initial
    PageMap-derived routing."""
    if job.miku and job.miku_law not in ("pertier", "merged"):
        raise NotImplementedError(PEREDGE_REFUSAL)
    hook = job.tiering.build() if job.tiering is not None else None
    export = export_state(job.platform, job.workloads,
                          granularity=job.granularity,
                          window_ns=job.window_ns, tiering=hook)
    units: list = []
    merged = False
    if job.miku:
        from repro_torch.memsim.calibration import default_miku, merged_miku

        if job.miku_law == "merged":
            law = merged_miku(job.platform, job.granularity, **job.miku_overrides).law
            law._ensure_units(1, ["slow"])
            units = [law.units[0]]
            merged = True
        else:
            n_slow = export["n_tiers"] - 1
            ctl = default_miku(job.platform, job.granularity, **job.miku_overrides)
            ctl._ensure_units(n_slow, export["tier_names"][1:])
            units = list(ctl.units[:n_slow])
    return CellPlan(job=job, export=export, units=units, merged=merged, tiering=hook)


class BatchGroup:
    """Padded array form of one window-cadence group of cells.

    Stations are the union layout ``[tier 0 .. max_tiers-1, llc]``; cells
    with fewer tiers carry zero-capacity padding.  Workload slots beyond a
    cell's count are inactive (zero cores).
    """

    def __init__(self, cells: Sequence[Tuple[int, CellPlan]]):
        self.indices = [i for i, _ in cells]
        self.plans = [p for _, p in cells]
        C = len(self.plans)
        exps = [p.export for p in self.plans]
        self.window_ns = float(exps[0]["window_ns"])
        T = max(e["n_tiers"] for e in exps)
        W = max(len(e["w_names"]) for e in exps)
        S = T + 1  # + LLC station
        self.n_tiers, self.n_wl, self.n_st = T, W, S
        self.llc = T

        self.n_tiers_cell = np.array([e["n_tiers"] for e in exps])
        self.sim_ns = np.array([p.job.sim_ns for p in self.plans])
        self.tor_cap = np.array([e["tor_capacity"] for e in exps], float)
        self.irq_cap = np.array([e["irq_capacity"] for e in exps], float)
        self.slots = np.zeros((C, S))  # 0 = padding station
        self.pipe = np.zeros((C, S))
        self.active_w = np.zeros((C, W), bool)
        self.svc = np.ones((C, W, S))
        self.bytes_t = np.zeros((C, W, T))
        self.p_llc = np.full((C, W), -1.0)
        self.tier_frac = np.zeros((C, W, T))
        self.effmlp = np.zeros((C, W))
        self.cores = np.zeros((C, W))
        self.managed = np.zeros((C, W), bool)
        self.op = np.zeros((C, W), int)
        self.phases: List[List[Optional[list]]] = []

        for ci, e in enumerate(exps):
            nt = e["n_tiers"]
            self.slots[ci, :nt] = e["st_slots"][:nt]
            self.slots[ci, self.llc] = e["st_slots"][nt]
            self.pipe[ci, :nt] = e["pipe"]
            nw = len(e["w_names"])
            self.active_w[ci, :nw] = True
            for wi in range(nw):
                self.svc[ci, wi, :nt] = e["w_svc"][wi]
                self.svc[ci, wi, self.llc] = e["w_llc_svc"][wi]
                self.bytes_t[ci, wi, :nt] = e["w_bytes"][wi]
                self.p_llc[ci, wi] = e["w_phit"][wi]
                self.tier_frac[ci, wi, :nt] = e["w_tier_frac"][wi]
                self.effmlp[ci, wi] = e["w_effmlp"][wi]
                self.cores[ci, wi] = e["w_cores"][wi]
                self.managed[ci, wi] = e["w_managed"][wi]
                self.op[ci, wi] = e["w_op"][wi]
            self.phases.append(
                [e["w_phases"][wi] if wi < nw else None for wi in range(W)]
            )

    def window_fracs(self, t0: np.ndarray, t1: np.ndarray,
                     base: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-window tier-routing fractions ``(C, W, T)``: ``base`` (default
        the static :attr:`tier_frac`; the fluid engine passes its live
        routing, which tiering re-resolves every window), with phased
        workloads replaced by the time-weighted tier occupancy of their
        (cycled) phase schedule over ``[t0, t1)``."""
        out = (self.tier_frac if base is None else base).copy()
        for ci, row in enumerate(self.phases):
            for wi, seq in enumerate(row):
                if seq is None:
                    continue
                dur = float(t1[ci] - t0[ci])
                if dur <= 0:
                    continue
                out[ci, wi, :] = 0.0
                period = sum(d for d, _ in seq)
                pos = float(t0[ci]) % period
                left = dur
                k = 0
                acc = 0.0
                for k, (d, _) in enumerate(seq):  # the current phase
                    if pos < acc + d:
                        break
                    acc += d
                offset = pos - acc
                while left > 1e-9:
                    d, tier = seq[k % len(seq)]
                    span = min(left, d - offset)
                    out[ci, wi, tier] += span / dur
                    left -= span
                    offset = 0.0
                    k += 1
        return out
