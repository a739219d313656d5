"""Per-edge MIKU: the ladder ensemble generalized from tiers to fabric edges
(a copy of ``repro.fabric.control``).

A *control edge* is anything the simulator meters residency through and the
controller can independently throttle: every slow tier's **device edge**
(named by the tier) plus every port-bearing fabric link's **link edge**
(named by the link).  The schedule is fixed — slow tiers in platform
order, then station links in topology declaration order — and shared by
:func:`edge_names`, ``TieredMemorySim(control_scope="edge")``'s window
reports, and the controllers built here, so decision vectors line up by
construction.

The per-slow-tier ensemble is the zero-link special case: on a platform
whose fabric is absent (or all-transparent), :func:`peredge_miku` builds
the exact controller :func:`~repro_torch.memsim.calibration.default_miku`
builds, and edge windows equal tier windows, so decisions are
bit-identical to the ``pertier`` law.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.controller import MikuConfig, MikuController
from repro_torch.core.device_model import DeviceModel, PlatformModel
from repro_torch.memsim.calibration import calibrate_estimator, tier_class_caps

__all__ = ["edge_names", "peredge_miku"]


def edge_names(platform: PlatformModel) -> Tuple[str, ...]:
    """The platform's control-edge schedule: one device edge per slow tier
    (platform order, named by the tier), then one link edge per
    port-bearing fabric link (declaration order, named by the link)."""
    fabric = getattr(platform, "fabric", None)
    links = fabric.station_links if fabric is not None else ()
    return tuple(platform.tier_names[1:]) + tuple(l.name for l in links)


def _link_device(link, reference: DeviceModel) -> DeviceModel:
    """View a port-bearing link as a DeviceModel so the standard tier
    calibration helpers apply to it unchanged: the port's servers are the
    parallelism, its per-cacheline service time covers reads and writes
    alike (the port transports both), and there is no pipeline — a link's
    entry-holding cost is pure service + queueing."""
    return DeviceModel(
        name=f"link:{link.name}",
        tier=link.name,
        parallelism=link.port_slots,
        read_service_ns=link.service_ns,
        write_service_ns=link.service_ns,
        pipeline_ns=0.0,
        access_bytes=reference.access_bytes,
    )


def peredge_miku(
    platform: PlatformModel,
    granularity: int = 4,
    **est_overrides,
) -> MikuController:
    """A per-edge MIKU ensemble calibrated for ``platform``.

    Device edges get ladders identical to
    :func:`~repro_torch.memsim.calibration.default_miku`'s per-slow-tier units
    (same rungs, same entry-holding-scaled caps, same ToR-share-split
    thresholds), so a fabric-less platform yields the per-tier ensemble
    exactly.  Each link edge gets its own ladder calibrated from the
    port's DeviceModel view (:func:`_link_device`): threshold from the
    port service time with the standard queue markup, caps scaled by the
    port's entry-holding time — a narrow port gets a low ceiling.  Pair
    with ``TieredMemorySim(..., control_scope="edge")`` (or
    ``SimJob(miku=True, miku_law="peredge")``)."""
    slow_devs = platform.tiers[1:]
    n_slow = len(slow_devs)
    reference = slow_devs[0]
    cfgs = [
        MikuConfig(
            levels=(1, 2, 4, 8, 16),
            class_caps=tier_class_caps(dev, reference, granularity),
        )
        for dev in slow_devs
    ]
    ests = [
        calibrate_estimator(
            platform, granularity, slow_device=dev,
            shared_slow_tiers=n_slow, **est_overrides
        )
        for dev in slow_devs
    ]
    fabric = getattr(platform, "fabric", None)
    links = fabric.station_links if fabric is not None else ()
    for link in links:
        dev = _link_device(link, reference)
        cfgs.append(MikuConfig(
            levels=(1, 2, 4, 8, 16),
            class_caps=tier_class_caps(dev, reference, granularity),
        ))
        ests.append(calibrate_estimator(
            platform, granularity, slow_device=dev,
            shared_slow_tiers=1, **est_overrides
        ))
    return MikuController(cfgs, ests)
