"""Fabric-carrying platform factories (registered into ``PLATFORMS``; a copy
of ``repro.fabric.platforms``).

These wrap the canonical Platform A with a routed topology: the degenerate
direct-attach fabric (a pure-refactoring sanity platform — bit-identical
simulation to plain ``A``), a single-switch port in front of the CXL tier,
and the two-host spine-leaf fabric where cross-host congestion lives.
Importing :mod:`repro_torch.fabric` registers ``"A-direct"`` and ``"A-spine"``
into :data:`repro_torch.core.device_model.PLATFORMS` so the benchmark CLI can
name them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.device_model import PLATFORMS, PlatformModel, platform_a
from repro_torch.fabric.topology import direct, single_switch, spine_leaf

__all__ = [
    "direct_platform",
    "single_switch_platform",
    "spine_leaf_platform",
]


def direct_platform(base: str = "A") -> PlatformModel:
    """``PLATFORMS[base]`` carrying the degenerate direct-attach fabric:
    zero hop stations, so it simulates bit-identically to ``base`` — the
    refactoring-sanity platform the one-hop identity tests pin."""
    pm = PLATFORMS[base]
    return dataclasses.replace(
        pm,
        name=f"{pm.name}-direct",
        fabric=direct(pm.tier_names),
    )


def single_switch_platform(
    *,
    port_slots: int = 8,
    port_service_ns: float = 36.0,
    port_queue: int = 1024,
) -> PlatformModel:
    """Platform A with its CXL tier behind one port-bearing switch link
    (``sw0-cxl``): the minimal real fabric, used by the port-queue-vs-ToR
    crossover scenario.  ``port_queue`` is the port's entry limit in
    cachelines (compare against ``tor_entries=2048``)."""
    base = platform_a()
    topo = single_switch(
        base.tier_names, routed=("cxl",),
        port_slots=port_slots, service_ns=port_service_ns,
        queue_entries=port_queue,
    )
    return dataclasses.replace(
        base,
        name=f"{base.name}-sw{port_slots}p{port_queue}q",
        fabric=topo,
    )


def spine_leaf_platform(
    *,
    n_hosts: int = 2,
    uplink_slots=16,
    uplink_service_ns=18.0,
    uplink_queue=1024,
    spine_slots: int = 8,
    spine_service_ns: float = 36.0,
    spine_queue: int = 1024,
) -> PlatformModel:
    """Platform A behind a two-host spine-leaf fabric: each host's CXL
    requests traverse ``uplink{i}`` then the *shared* ``spine-cxl``
    downlink, while DDR stays direct-attached per host.  Uplink parameters
    accept a scalar or a per-host sequence (asymmetric uplinks for the
    per-edge MIKU fairness scenario).  Queue limits are in cachelines."""
    base = platform_a()
    topo = spine_leaf(
        base.tier_names, routed=("cxl",), n_hosts=n_hosts,
        uplink_slots=uplink_slots, uplink_service_ns=uplink_service_ns,
        uplink_queue=uplink_queue,
        spine_slots=spine_slots, spine_service_ns=spine_service_ns,
        spine_queue=spine_queue,
    )
    return dataclasses.replace(
        base,
        name=f"{base.name}-spine{spine_slots}p{spine_queue}q",
        fabric=topo,
    )


PLATFORMS.setdefault("A-direct", direct_platform())
PLATFORMS.setdefault("A-spine", spine_leaf_platform())
