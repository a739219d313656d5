"""Canonical workload builders of the paper's benchmarks (§3); a copy of
``repro.memsim.workloads`` without ``serve_test`` (open-loop arrivals are
not ported)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def lat_test(
    tier: str,
    op: OpClass = OpClass.LOAD,
    n_threads: int = 1,
    *,
    name: Optional[str] = None,
) -> WorkloadSpec:
    """Pointer-chasing latency test: a randomly linked circular list, one
    outstanding access per thread (512 MB WSS >> LLC)."""
    return WorkloadSpec(
        name=name or f"lat-{tier}-{op.value}-{n_threads}t",
        op=op,
        tier=tier,
        n_cores=n_threads,
        dependent=True,
        wss_mb=512.0,
    )


def lat_share(n_threads: int = 2, *, name: str = "lat-share") -> WorkloadSpec:
    """Threads CAS-updating one shared cacheline (coherence through the
    CHA/ToR; paper §4.4)."""
    return WorkloadSpec(
        name=name,
        op=OpClass.STORE,
        tier="ddr",
        n_cores=n_threads,
        sync=True,
        wss_mb=0.001,
        miku_managed=False,
    )


def alternating_bw_pair(
    op: OpClass,
    n_threads: int = 16,
    period_ns: float = 100_000.0,
) -> List[WorkloadSpec]:
    """Fig. 10's dynamic scenario: two groups alternating DDR and CXL access
    every ``period_ns`` (the paper's 100 s, time-scaled)."""
    return [
        WorkloadSpec(name="alt-a", op=op, tier="ddr", n_cores=n_threads,
                     phases=[(period_ns, "ddr"), (period_ns, "cxl")]),
        WorkloadSpec(name="alt-b", op=op, tier="cxl", n_cores=n_threads,
                     phases=[(period_ns, "cxl"), (period_ns, "ddr")]),
    ]
