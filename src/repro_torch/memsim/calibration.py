"""Offline calibration of MIKU's estimator from device models (paper §5.2).

A copy of ``repro.memsim.calibration``: :func:`calibrate_estimator`,
:func:`tier_class_caps`, the per-tier law :func:`default_miku` and the
merged-slow baseline :func:`merged_miku`.

* ``t_fast`` is the fast tier's loaded ToR residency (pool size over
  service rate): the paper finds DDR never backlogs the ToR.
* ``threshold`` is the slow tier's pipeline plus ``g`` read services with
  ``depth`` service times of device queueing allowed before it counts as a
  backlog; writes get twice the threshold (paper footnote 2).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.controller import MergedSlowPolicy, MikuConfig, MikuController
from repro_torch.core.device_model import DeviceModel, PlatformModel
from repro_torch.core.littles_law import EstimatorConfig, OpClass


def calibrate_estimator(
    platform: PlatformModel,
    granularity: int = 4,
    *,
    slow_queue_markup: float = 4.0,
    ewma: float = 0.5,
    slow_device: Optional[DeviceModel] = None,
    shared_slow_tiers: int = 1,
) -> EstimatorConfig:
    """Estimator calibration for one slow tier (default: the CXL tier);
    ``shared_slow_tiers`` splits the backlog-free queue depth between the
    slow tiers that share the ToR."""
    g = granularity
    ddr = platform.ddr
    cxl = slow_device if slow_device is not None else platform.cxl
    pool = platform.tor_entries / g  # macro entries
    mu_fast = ddr.total_slots / (g * ddr.read_service_ns)  # macro/ns
    t_fast = max(pool / mu_fast, ddr.pipeline_ns + g * ddr.read_service_ns)
    rs, ws = ddr.read_service_ns, ddr.write_service_ns
    per_instr = {
        OpClass.LOAD: rs,
        OpClass.STORE: rs + ws,
        OpClass.NT_STORE: ws,
        OpClass.MIGRATE: rs + ws,
    }
    class_scale = {c: s / rs for c, s in per_instr.items()}
    pipeline_cover = cxl.pipeline_ns / max(g * cxl.read_service_ns, 1e-9)
    depth = max(slow_queue_markup, pipeline_cover) / max(shared_slow_tiers, 1)
    threshold = cxl.pipeline_ns + g * cxl.read_service_ns * (1.0 + depth)
    return EstimatorConfig(
        t_fast=t_fast,
        slow_read_threshold=threshold,
        write_threshold_scale=2.0,
        ewma=ewma,
        t_fast_class_scale=class_scale,
    )


#: Paper defaults: per-class backlog-free concurrency for the local CXL
#: expander (§5.2: 8/4/1 cores for load/store/nt-store; MIGRATE is the
#: tiering engine's page-copy class).
_BASE_CLASS_CAPS = {
    OpClass.LOAD: 8,
    OpClass.STORE: 4,
    OpClass.NT_STORE: 1,
    OpClass.MIGRATE: 2,
}


def _default_config() -> MikuConfig:
    return MikuConfig(levels=(1, 2, 4, 8, 16), class_caps=dict(_BASE_CLASS_CAPS))


def tier_class_caps(
    device: DeviceModel,
    reference: DeviceModel,
    granularity: int = 4,
) -> dict:
    """Backlog-free class caps for one slow tier: the paper's caps scaled
    down by the tier's entry-holding time relative to ``reference``."""
    g = granularity
    hold_ref = reference.pipeline_ns + g * reference.read_service_ns
    hold = device.pipeline_ns + g * device.read_service_ns
    scale = min(1.0, hold_ref / max(hold, 1e-9))
    return {c: max(1, round(n * scale)) for c, n in _BASE_CLASS_CAPS.items()}


def default_miku(
    platform: PlatformModel,
    granularity: int = 4,
    **est_overrides,
) -> MikuController:
    """A per-slow-tier MIKU ensemble calibrated for ``platform``: one
    ladder per slow tier, each from that tier's own device model."""
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
    return MikuController(cfgs, ests)


def merged_miku(
    platform: PlatformModel,
    granularity: int = 4,
    **est_overrides,
) -> MergedSlowPolicy:
    """The merged-slow MIKU: one CXL-calibrated ladder fed the fold of all
    slow tiers' deltas, its decision broadcast to every slow tier (the
    baseline ``corun3_pertier`` compares the per-tier law with)."""
    est = calibrate_estimator(platform, granularity, **est_overrides)
    return MergedSlowPolicy(MikuController(_default_config(), est))
