"""Memory-device service models of the simulated testbed.

A copy of the part of ``repro.core.device_model`` the batched sweep lane
uses: :class:`DeviceModel`, :class:`PlatformModel` (an ordered tier list,
fast tier first), the paper's two platforms (Table 1), the three-tier
variants of platform A (CXL behind a switch, the remote socket's DDR) and a
:data:`PLATFORMS` table of the entries the grid scenarios name (A, B, their
one-DIMM, one-expander ``-1to1`` variants, ``A-switch`` and ``A-numa``).
The TPU-unit and fabric platforms are not ported yet.

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

#: The same expander reached through a CXL switch: the device's own
#: parallelism and service, plus the switch's store-and-forward hop each way
#: (~90 ns a direction).
CXL_SWITCH_DEVICE = DeviceModel(
    name="cxl-sw-exp",
    tier="cxl_sw",
    parallelism=14,
    read_service_ns=36.0,
    write_service_ns=72.0,
    pipeline_ns=435.0,
)

#: A DDR5 DIMM on the other socket: the local DIMM's service plus the
#: cross-socket interconnect's flight (local 78 ns + ~87 ns round trip).
DDR_REMOTE_DIMM = DeviceModel(
    name="ddr5-remote-dimm",
    tier="ddr_remote",
    parallelism=16,
    read_service_ns=32.0,
    write_service_ns=44.0,
    pipeline_ns=165.0,
)


@dataclasses.dataclass(frozen=True)
class PlatformModel:
    """A host platform: an ordered list of memory tiers (fast tier first)
    behind one shared request-tracking structure (the CHA's ToR).

    The tiers are ``(ddr, cxl) + extra_tiers``: ``ddr`` is the fast tier
    the control plane protects, every later one a slow tier it may
    throttle, each keyed by its :attr:`DeviceModel.tier` name.
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
    extra_tiers: Tuple[DeviceModel, ...] = ()

    def __post_init__(self):
        names = tuple(d.tier for d in self.tiers)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in platform: {names}")

    @property
    def tiers(self) -> Tuple[DeviceModel, ...]:
        """Ordered tier devices, fast tier first."""
        return (self.ddr, self.cxl) + self.extra_tiers

    @property
    def tier_names(self) -> Tuple[str, ...]:
        return tuple(d.tier for d in self.tiers)

    def device_for(self, tier: str) -> DeviceModel:
        """The device of tier ``tier``."""
        names = self.tier_names
        if tier not in names:
            raise UnknownTierError(tier, names)
        return self.tiers[names.index(tier)]

    def with_extra_tiers(self, *devices: DeviceModel) -> "PlatformModel":
        """A copy of this platform with ``devices`` appended as slow tiers."""
        return dataclasses.replace(self, extra_tiers=self.extra_tiers + tuple(devices))


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


def platform_a_switch(
    ddr_dimms: int = 8, cxl_devices: int = 2, switch_devices: int = 2
) -> PlatformModel:
    """Platform A with a third tier, CXL expanders behind a switch:
    (ddr, cxl, cxl_sw)."""
    base = platform_a(ddr_dimms, cxl_devices)
    return dataclasses.replace(
        base,
        name=f"{base.name}-{switch_devices}sw",
        extra_tiers=(CXL_SWITCH_DEVICE.scaled(switch_devices,
                                              name=f"cxlswx{switch_devices}"),),
    )


def platform_a_numa(
    ddr_dimms: int = 8, cxl_devices: int = 2, remote_dimms: int = 8
) -> PlatformModel:
    """Platform A with the remote socket's DDR pool as a third tier:
    (ddr, cxl, ddr_remote)."""
    base = platform_a(ddr_dimms, cxl_devices)
    return dataclasses.replace(
        base,
        name=f"{base.name}-{remote_dimms}rddr",
        extra_tiers=(DDR_REMOTE_DIMM.scaled(remote_dimms,
                                            name=f"rddr5x{remote_dimms}"),),
    )


PLATFORMS: Dict[str, PlatformModel] = {
    "A": platform_a(),
    "B": platform_b(),
    "A-1to1": platform_a(ddr_dimms=1, cxl_devices=1),
    "B-1to1": platform_b(ddr_dimms=1, cxl_devices=1),
    "A-switch": platform_a_switch(),
    "A-numa": platform_a_numa(),
}
