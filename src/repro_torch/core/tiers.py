"""Memory-tier specifications of the serving runtime.

The fast tier is device memory; the slow tier is pinned host memory over
the host link.  The constants are the reference's TPU-v5e-flavoured ones
(``repro/core/tiers.py``), kept as the parity default so that the port's
simulated serving clock equals the reference's; they do not describe an
H100.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory tier of the serving/training runtime."""

    name: str
    bandwidth_gbps: float  # B/ns per chip
    capacity_gib: float  # per chip
    #: Max concurrently in-flight fetch streams before device-side queueing
    #: explodes (the paper's hardware-parallelism disparity).
    parallelism: int


HBM_TIER = TierSpec(name="hbm", bandwidth_gbps=819.0, capacity_gib=16.0,
                    parallelism=64)
HOST_TIER = TierSpec(name="host", bandwidth_gbps=16.0, capacity_gib=256.0,
                     parallelism=8)


def host_offload_supported(device: torch.device) -> bool:
    """Pinned host memory exists only beside a CUDA device; on the CPU a
    host-placed instance keeps its tensors where they are."""
    return device.type == "cuda"
