"""Sweep entry point: many independent simulated-testbed cells.

A copy of ``repro.memsim.sweep``'s :class:`SimJob` (the fields the batched
lane reads, with their validation) and :func:`run_sweep`.  The port runs
sweeps on the batched lane only: the scalar event-driven DES is not ported
yet (ROADMAP queue A, "the scalar DES lane").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.des import SimResult, WorkloadSpec, validate_workloads
from repro_torch.core.device_model import PlatformModel


@dataclasses.dataclass
class SimJob:
    """One independent simulation cell."""

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
    #: tiers, its decision broadcast) or "peredge".  The batched lane
    #: refuses "peredge" (it needs the fabric, not ported).
    miku_law: str = "pertier"
    #: Per-window telemetry records (``SimResult.window_records``) and
    #: analytic latency histograms.
    record_windows: bool = False
    latency_hist: bool = False
    #: Optional :class:`repro_torch.tiering.TieringSpec`: the lane builds a
    #: fresh hook from it per job (pages, migration engine, policy).
    tiering: Optional[object] = None

    def __post_init__(self):
        validate_workloads(self.platform, self.workloads)
        if self.miku_law not in ("pertier", "merged", "peredge"):
            raise ValueError(
                f"unknown miku_law {self.miku_law!r}; "
                "expected 'pertier', 'merged' or 'peredge'"
            )


def run_sweep(
    jobs: Sequence[SimJob],
    lane: str = "batched",
    device=None,
) -> List[SimResult]:
    """Run ``jobs`` on ``device`` (the card unless ``"cpu"``), results in job
    order.  ``lane="scalar"`` (the event-driven DES) is not ported."""
    if lane == "scalar":
        raise NotImplementedError(
            "the scalar DES lane is not ported yet (ROADMAP queue A, "
            "'the scalar DES lane'); use lane='batched'"
        )
    if lane != "batched":
        raise ValueError(
            f"unknown sweep lane {lane!r}; expected 'scalar' or 'batched'"
        )
    from repro_torch.memsim.batched.lane import run_sweep_batched

    return run_sweep_batched(jobs, device=device)
