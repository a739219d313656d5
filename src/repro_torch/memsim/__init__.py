"""The port's simulated-testbed sweeps (counterpart of ``repro.memsim``):
the micro-benchmark workloads, the MIKU calibration, the sweep entry point
and the figure-level runners over the scenario registry."""

from repro_torch.memsim.calibration import calibrate_estimator, default_miku
from repro_torch.memsim.runner import (
    bandwidth_matrix,
    corun_matrix,
    latency_matrix,
    llc_partition_sweep,
    miku_comparison,
    sync_interference,
)
from repro_torch.memsim.sweep import SimJob, run_job, run_sweep

__all__ = [
    "calibrate_estimator",
    "default_miku",
    "bandwidth_matrix",
    "corun_matrix",
    "latency_matrix",
    "llc_partition_sweep",
    "miku_comparison",
    "sync_interference",
    "SimJob",
    "run_job",
    "run_sweep",
]
