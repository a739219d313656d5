"""Tier specs, offload runtime and the MIKU control plane of the port: the
device models, the DES and MVA of the simulated testbed, the Little's-Law
estimator and the throttle controllers, and the tier/offload runtime they
govern."""

from repro_torch.core.controller import (
    Decision,
    MergedSlowPolicy,
    MikuConfig,
    MikuController,
    Phase,
    SlowTierMiku,
    StragglerGovernor,
    TierDecisions,
)
from repro_torch.core.des import SimResult, TieredMemorySim, WorkloadSpec, validate_workloads
from repro_torch.core.device_model import (
    CXL_DEVICE,
    CXL_SWITCH_DEVICE,
    DDR5_DIMM,
    DDR_REMOTE_DIMM,
    PLATFORMS,
    DeviceModel,
    PlatformModel,
    UnknownTierError,
    platform_a,
    platform_a_numa,
    platform_a_switch,
    platform_b,
    tpu_host_platform,
)
from repro_torch.core.littles_law import (
    EstimatorConfig,
    LittlesLawEstimator,
    OpClass,
    TierCounters,
    TierEstimate,
    TierWindow,
    merge_tier_counters,
)
from repro_torch.core.offload import HostOffloader, TransferQueue
from repro_torch.core.substrate import (
    ControlLoop,
    MemorySubstrate,
    ReplaySubstrate,
    StepTimingSubstrate,
    TierSetWindowedCounters,
    WindowedCounters,
    WindowRecord,
    window_record_jsonable,
)
from repro_torch.core.tiers import (
    HBM_TIER,
    HOST_TIER,
    TieredLayout,
    TierSpec,
    host_offload_supported,
    put_on_tier,
)

__all__ = [
    "Decision", "MergedSlowPolicy", "MikuConfig", "MikuController", "Phase", "SlowTierMiku",
    "StragglerGovernor", "TierDecisions", "SimResult", "TieredMemorySim", "WorkloadSpec",
    "validate_workloads", "CXL_DEVICE", "CXL_SWITCH_DEVICE", "DDR5_DIMM", "DDR_REMOTE_DIMM",
    "DeviceModel", "PlatformModel", "PLATFORMS", "UnknownTierError", "platform_a",
    "platform_a_numa", "platform_a_switch", "platform_b", "tpu_host_platform",
    "EstimatorConfig", "LittlesLawEstimator", "OpClass", "TierCounters", "TierEstimate",
    "TierWindow", "merge_tier_counters", "HostOffloader", "TransferQueue", "ControlLoop",
    "MemorySubstrate", "ReplaySubstrate", "StepTimingSubstrate", "TierSetWindowedCounters",
    "WindowedCounters", "WindowRecord", "window_record_jsonable", "HBM_TIER", "HOST_TIER",
    "TieredLayout", "TierSpec", "host_offload_supported", "put_on_tier",
]
