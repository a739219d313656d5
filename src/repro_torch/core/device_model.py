"""Memory-device service models of the simulated testbed.

A copy of the part of ``repro.core.device_model`` the batched sweep lane
uses: :class:`DeviceModel`, :class:`PlatformModel`, the paper's two
platforms (Table 1) and a :data:`PLATFORMS` table of the entries the
grid scenarios name (A, B and their one-DIMM, one-expander ``-1to1``
variants).  The switch, NUMA-remote, TPU-unit and fabric platforms are not
ported yet.

Every device is ``c`` deterministic servers with per-access service time
``s`` (64 B cachelines) plus a pipeline latency that holds no slot:

    peak_bw  = c * 64 B / s
    latency(unloaded) = pipeline + s
    latency(loaded)   = pipeline + s + queue_wait

An ordinary store is a read-modify-write (two device accesses); an
nt-store is one write access; writes are slower than reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.littles_law import ACCESS_MIX, OpClass

CACHELINE = 64  # bytes


class UnknownTierError(ValueError):
    """A workload or lookup named a tier its platform lacks; the message
    lists every known tier."""

    def __init__(self, tier: str, known: Tuple[str, ...]):
        super().__init__(
            f"unknown memory tier {tier!r}; platform tiers are "
            f"{', '.join(known)}"
        )
        self.tier = tier
        self.known = tuple(known)


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A memory device (or a hardware-interleaved group of identical ones).

    ``parallelism`` is the number of concurrently serviceable accesses;
    ``read_service_ns``/``write_service_ns`` the slot occupancy per 64 B
    access; ``pipeline_ns`` the latency that occupies no slot.
    ``interleave`` multiplies parallelism.
    """

    name: str
    tier: str
    parallelism: int
    read_service_ns: float
    write_service_ns: float
    pipeline_ns: float
    interleave: int = 1
    access_bytes: int = CACHELINE

    @property
    def total_slots(self) -> int:
        return self.parallelism * self.interleave

    def service_ns(self, op: OpClass) -> float:
        """Total slot occupancy per retired instruction of class ``op``."""
        reads, writes = ACCESS_MIX[op]
        return reads * self.read_service_ns + writes * self.write_service_ns

    def peak_bandwidth_gbps(self, op: OpClass) -> float:
        """Peak retired-data bandwidth (GB/s) for a pure stream of ``op``."""
        return self.total_slots * self.access_bytes / self.service_ns(op)  # B/ns == GB/s

    def scaled(self, interleave: int, name: str = "") -> "DeviceModel":
        return dataclasses.replace(
            self, interleave=interleave, name=name or f"{self.name}x{interleave}"
        )


#: One DDR5-4800 DIMM behind one channel: ~32 GB/s loads.
DDR5_DIMM = DeviceModel(
    name="ddr5-dimm",
    tier="ddr",
    parallelism=16,
    read_service_ns=32.0,
    write_service_ns=44.0,
    pipeline_ns=78.0,
)

#: One 256 GB CXL expander on PCIe Gen5 x8 (paper §4.1: the parallelism of
#: about one DIMM, DDR's latency plus a constant protocol overhead).
CXL_DEVICE = DeviceModel(
    name="cxl-exp",
    tier="cxl",
    parallelism=14,
    read_service_ns=36.0,
    write_service_ns=72.0,
    pipeline_ns=255.0,
)


@dataclasses.dataclass(frozen=True)
class PlatformModel:
    """A host platform: an ordered list of memory tiers (fast tier first)
    behind one shared request-tracking structure (the CHA's ToR).

    ``tor_entries`` bounds tracked requests, ``irq_entries`` staged ones
    (both in cachelines); ``llc_service_ns``/``llc_slots`` model LLC hits,
    which also hold ToR entries (paper §4.3).
    """

    name: str
    ddr: DeviceModel
    cxl: DeviceModel
    tor_entries: int
    irq_entries: int
    core_mlp: int
    n_cores: int
    llc_service_ns: float
    llc_slots: int
    llc_capacity_mb: float

    @property
    def tiers(self) -> Tuple[DeviceModel, ...]:
        """Ordered tier devices, fast tier first."""
        return (self.ddr, self.cxl)

    @property
    def tier_names(self) -> Tuple[str, ...]:
        return tuple(d.tier for d in self.tiers)

    def device_for(self, tier: str) -> DeviceModel:
        """The device of tier ``tier``."""
        names = self.tier_names
        if tier not in names:
            raise UnknownTierError(tier, names)
        return self.tiers[names.index(tier)]


def platform_a(ddr_dimms: int = 8, cxl_devices: int = 2) -> PlatformModel:
    """Intel Xeon Gold 6530 (EMR) socket: 8x DDR5 + 2x CXL (Table 1)."""
    return PlatformModel(
        name=f"intel-emr-{ddr_dimms}ddr-{cxl_devices}cxl",
        ddr=DDR5_DIMM.scaled(ddr_dimms, name=f"ddr5x{ddr_dimms}"),
        cxl=CXL_DEVICE.scaled(cxl_devices, name=f"cxlx{cxl_devices}"),
        tor_entries=2048,
        irq_entries=256,
        core_mlp=160,
        n_cores=32,
        llc_service_ns=18.0,
        llc_slots=96,
        llc_capacity_mb=160.0,
    )


def platform_b(ddr_dimms: int = 12, cxl_devices: int = 4) -> PlatformModel:
    """AMD EPYC 9634 (Genoa) socket: 12x DDR5 + 4x CXL (Table 1)."""
    return PlatformModel(
        name=f"amd-genoa-{ddr_dimms}ddr-{cxl_devices}cxl",
        ddr=DDR5_DIMM.scaled(ddr_dimms, name=f"ddr5x{ddr_dimms}"),
        cxl=CXL_DEVICE.scaled(cxl_devices, name=f"cxlx{cxl_devices}"),
        tor_entries=2304,
        irq_entries=320,
        core_mlp=192,
        n_cores=84,
        llc_service_ns=16.0,
        llc_slots=128,
        llc_capacity_mb=384.0,
    )


PLATFORMS: Dict[str, PlatformModel] = {
    "A": platform_a(),
    "B": platform_b(),
    "A-1to1": platform_a(ddr_dimms=1, cxl_devices=1),
    "B-1to1": platform_b(ddr_dimms=1, cxl_devices=1),
}
