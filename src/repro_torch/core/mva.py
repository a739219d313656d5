"""Approximate Mean-Value Analysis of the tiered-memory queueing network.

A port of ``repro.core.mva``: a closed network of two memory stations
(fast / slow), a delay stage (the pipeline flight that holds no slot) and
the shared ToR pool as a population bound, with two customer classes
(fast- and slow-bound streams, threads x MLP each).  The multi-server
approximation ``R = s * (1 + max(Q - c, 0) / c)`` is iterated to a fixed
point.  The reference's ``jax.lax.while_loop`` runs exactly ``max_iter``
damped rounds (its condition is ``i < max_iter``), so this is a plain loop
of ``max_iter`` rounds in f32 on the inputs' device.

Approximate MVA ignores the FIFO head-of-line coupling that makes the
unfairness (the simulated testbed owns that); it gives per-tier loaded
service times and throughput ceilings.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.device_model import DeviceModel, PlatformModel
from repro_torch.core.littles_law import OpClass
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MvaResult:
    throughput_fast: torch.Tensor  # macro-requests / ns
    throughput_slow: torch.Tensor
    residency_fast: torch.Tensor  # ns at the station (queueing included) + pipeline
    residency_slow: torch.Tensor
    bandwidth_fast_gbps: torch.Tensor
    bandwidth_slow_gbps: torch.Tensor


def _station_params(dev: DeviceModel, op: OpClass, granularity: int):
    return dev.service_ns(op) * granularity, float(dev.total_slots), dev.pipeline_ns


def solve(n_fast, n_slow, fast_service, fast_slots, fast_pipeline,
          slow_service, slow_slots, slow_pipeline, tor_entries, max_iter: int = 200):
    """Fixed-point iteration of two-class approximate MVA on tensors:
    (x_fast, x_slow, residency_fast, residency_slow).  The populations are
    first scaled down together if their sum exceeds the ToR pool."""
    n_total = n_fast + n_slow
    scale = torch.clamp(tor_entries / torch.clamp(n_total, min=1e-9), max=1.0)
    n_f = n_fast * scale
    n_s = n_slow * scale
    q_f, q_s = n_f * 0.5, n_s * 0.5
    x_f, x_s = torch.zeros_like(n_f), torch.zeros_like(n_s)
    for _ in range(max_iter):
        r_f = fast_service * (1.0 + torch.clamp(q_f - fast_slots, min=0.0) / fast_slots)
        r_s = slow_service * (1.0 + torch.clamp(q_s - slow_slots, min=0.0) / slow_slots)
        x_f = n_f / (r_f + fast_pipeline)
        x_s = n_s / (r_s + slow_pipeline)
        q_f = 0.5 * q_f + 0.5 * (x_f * r_f)
        q_s = 0.5 * q_s + 0.5 * (x_s * r_s)
    # Throughputs are also capped by the stations' service capacity.
    x_f = torch.minimum(x_f, fast_slots / fast_service)
    x_s = torch.minimum(x_s, slow_slots / slow_service)
    r_f = torch.where(x_f > 0, q_f / torch.clamp(x_f, min=1e-12), fast_service)
    r_s = torch.where(x_s > 0, q_s / torch.clamp(x_s, min=1e-12), slow_service)
    return x_f, x_s, r_f + fast_pipeline, r_s + slow_pipeline


def analyze(
    platform: PlatformModel,
    op: OpClass,
    fast_threads: int,
    slow_threads: int,
    *,
    mlp: int = 160,
    granularity: int = 4,
    device=None,
) -> MvaResult:
    """:func:`solve` in the simulated testbed's units (threads x MLP
    populations, macro-requests of ``granularity`` cachelines), on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    g = granularity

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    f_svc, f_slots, f_pipe = _station_params(platform.ddr, op, g)
    s_svc, s_slots, s_pipe = _station_params(platform.cxl, op, g)
    x_f, x_s, r_f, r_s = solve(
        f32(fast_threads * mlp / g), f32(slow_threads * mlp / g),
        f32(f_svc), f32(f_slots), f32(f_pipe), f32(s_svc), f32(s_slots), f32(s_pipe),
        f32(platform.tor_entries / g),
    )
    return MvaResult(
        throughput_fast=x_f,
        throughput_slow=x_s,
        residency_fast=r_f,
        residency_slow=r_s,
        bandwidth_fast_gbps=x_f * (platform.ddr.access_bytes * g),
        bandwidth_slow_gbps=x_s * (platform.cxl.access_bytes * g),
    )
