"""Canonical workload builders of the paper's benchmarks (§3); a copy of
``repro.memsim.workloads.bw_test``."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.des import WorkloadSpec
from repro_torch.core.littles_law import OpClass


def bw_test(
    tier: str,
    op: OpClass,
    n_threads: int,
    *,
    name: Optional[str] = None,
    mlp: int = 160,
    miku_managed: bool = True,
    wss_mb: float = 32768.0,
    llc_alloc_mb: float = 0.0,
    phases: Optional[Sequence[Tuple[float, str]]] = None,
    ddr_fraction: Optional[float] = None,
) -> WorkloadSpec:
    """lmbench-style sequential bandwidth test: ``n_threads`` cores, each a
    1 GB non-overlapping region (WSS >> LLC, so all accesses miss)."""
    return WorkloadSpec(
        name=name or f"bw-{tier}-{op.value}-{n_threads}t",
        op=op,
        tier=tier,
        n_cores=n_threads,
        mlp=mlp,
        wss_mb=wss_mb,
        llc_alloc_mb=llc_alloc_mb,
        phases=phases,
        miku_managed=miku_managed,
        ddr_fraction=ddr_fraction,
    )
