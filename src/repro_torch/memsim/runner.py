"""Figure-level experiment runners: thin wrappers over the scenario API (a
port of ``repro.memsim.runner``).

Each wrapper runs one registered scenario of
:mod:`repro_torch.scenarios.library` and keeps the reference's call
signature and return shape (plain dicts and lists: bandwidths in GB/s,
latencies in ns, times in simulated ns).  The port adds ``device`` (the
card unless ``"cpu"``) and ``lane`` (``"batched"``, the default, or
``"scalar"``), where the reference reads ``REPRO_SWEEP_LANE``.  New
experiments use the registry directly::

    from repro_torch.scenarios import run_scenario
    rows = run_scenario("fig3_bandwidth", {"platform": "A"}).rows
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.device_model import PlatformModel
from repro_torch.core.littles_law import OpClass


def _rows(name: str, overrides: dict, processes: Optional[int],
          drop: Tuple[str, ...] = ("platform",), *, device=None,
          lane: str = "batched") -> List[dict]:
    from repro_torch.scenarios import run_scenario  # local: avoids an import cycle

    table = run_scenario(name, overrides, device, lane=lane, processes=processes)
    return [{k: v for k, v in r.items() if k not in drop}
            for r in table.rows]


# -- Fig. 3: single-threaded and peak bandwidth, DDR vs CXL -----------------


def bandwidth_matrix(
    platform: PlatformModel,
    threads: Tuple[int, ...] = (1, 16),
    processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Fig. 3 rows: per-tier bw-test bandwidth over a thread grid."""
    return _rows("fig3_bandwidth",
                 {"platform": platform, "threads": threads}, processes,
                 device=device, lane=lane)


# -- Fig. 4: average and tail latency ----------------------------------------


def latency_matrix(
    platform: PlatformModel,
    threads: Tuple[int, ...] = (1, 2, 4, 8, 16),
    processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Fig. 4 rows: per-tier loaded avg/p50/p99 latency over threads."""
    return _rows("fig4_latency",
                 {"platform": platform, "threads": threads}, processes,
                 device=device, lane=lane)


# -- Fig. 2: tiered memory management schemes --------------------------------


def tiering_schemes(
    platform: PlatformModel, op: OpClass, processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> Dict[str, float]:
    """Aggregate bandwidth of two 16-thread copies under each scheme
    (upper / lower / native / interleave / os_managed / ideal_combined)."""
    (row,) = _rows("fig2_tiering",
                   {"platform": platform, "op": (op,)}, processes,
                   drop=("platform", "op"), device=device, lane=lane)
    return row


# -- Fig. 5 + 6: co-run collapse and ToR accounting ---------------------------


def corun_matrix(
    platform: PlatformModel,
    n_threads: int = 16,
    processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Fig. 5/6 rows: co-run collapse + ToR accounting per op class."""
    return _rows("fig5_corun",
                 {"platform": platform, "n_threads": n_threads}, processes,
                 device=device, lane=lane)


def tor_insert_bandwidth_correlation(
    platform: PlatformModel, processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> float:
    """Pearson correlation between ToR insertion rate and delivered bandwidth
    across scenarios (paper: r = 0.998)."""
    (row,) = _rows("fig6_tor_correlation", {"platform": platform}, processes,
                   device=device, lane=lane)
    return row["pearson_r"]


# -- Fig. 7: LLC partitioning (Intel CAT analogue) ----------------------------


def llc_partition_sweep(
    platform: PlatformModel,
    wss_mb: float,
    allocs: Tuple[float, ...] = (0.95, 0.75, 0.5, 0.25, 0.05),
    processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Fig. 7 rows: LLC (CAT) allocation sweep under tiered co-run."""
    return _rows(
        "fig7_llc",
        {"platform": platform, "wss_mb": (wss_mb,), "ddr_share": allocs},
        processes,
        device=device,
        lane=lane,
    )


# -- Fig. 8: inter-core synchronization ---------------------------------------


def sync_interference(
    platform: PlatformModel,
    bg_threads: Tuple[int, ...] = (0, 4, 8, 16),
    processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Fig. 8 rows: CAS latency vs per-tier background thread count."""
    return _rows("fig8_sync",
                 {"platform": platform, "bg_threads": bg_threads}, processes,
                 device=device, lane=lane)


# -- Fig. 9: service time vs concurrency --------------------------------------


def service_time_curve(
    platform: PlatformModel,
    op: OpClass = OpClass.LOAD,
    threads: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
    processes: Optional[int] = None,
    *,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Fig. 9 rows: ToR-derived service time and bandwidth over threads."""
    return _rows(
        "fig9_service",
        {"platform": platform, "op": op, "threads": threads},
        processes,
        device=device,
        lane=lane,
    )


# -- Fig. 10: MIKU vs DataRacing vs Opt ---------------------------------------


@dataclasses.dataclass
class MikuComparison:
    op: str
    opt_ddr: float
    opt_cxl: float
    racing_ddr: float
    racing_cxl: float
    miku_ddr: float
    miku_cxl: float
    miku_mba_ddr: float
    miku_mba_cxl: float

    @property
    def miku_ddr_frac_of_opt(self) -> float:
        return self.miku_ddr / max(self.opt_ddr, 1e-9)


def pertier_comparison(
    platform: str = "A-switch",
    op: OpClass = OpClass.STORE,
    *,
    laws: Tuple[str, ...] = ("racing", "merged", "pertier"),
    n_threads: int = 16,
    sim_ns: float = 300_000.0,
    processes: Optional[int] = None,
    device=None,
    lane: str = "batched",
) -> List[dict]:
    """Three-tier co-run under each control law (``corun3_pertier``):
    per-slow-tier MIKU ladders vs the merged-slow broadcast vs racing.
    Rows carry per-tier mean caps and rates and restricted-window counts:
    under the per-tier law the switch tier's ladder sits below local
    CXL's; under the merged law both columns are equal by construction."""
    return _rows(
        "corun3_pertier",
        # corun3_pertier's op is a scalar axis: the reference passes (op,),
        # which its DES cannot run (a KeyError on the tuple).
        {"platform": platform, "op": op, "law": laws,
         "n_threads": n_threads, "sim_ns": sim_ns},
        processes,
        drop=(),
        device=device,
        lane=lane,
    )


def miku_comparison(
    platform: PlatformModel,
    op: OpClass,
    *,
    n_threads: int = 16,
    period_ns: float = 100_000.0,
    cycles: int = 3,
    processes: Optional[int] = None,
    device=None,
    lane: str = "batched",
) -> MikuComparison:
    """The paper's §6 micro-benchmark case study: two 16-thread groups
    alternating DDR/CXL every period (Opt, DataRacing, MIKU, MIKU-MBA)."""
    (row,) = _rows(
        "fig10_miku",
        {
            "platform": platform,
            "op": (op,),
            "n_threads": n_threads,
            "period_ns": period_ns,
            "cycles": cycles,
        },
        processes,
        device=device,
        lane=lane,
    )
    return MikuComparison(**row)
