"""Three-term roofline analysis from dry-run costs (port of
``repro/roofline/analysis.py``).

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The costs are per device (:mod:`repro_torch.roofline.op_costs` counts the
ops one rank runs on its shards), so the terms are per-device cost over
per-device capability.  On a GPU cluster the links differ by mesh axis: a
``model`` group is one NVLink node, while ``data`` and ``pod`` cross the
InfiniBand fabric, so collective bytes counted by axis are each divided by
their axis's rate.

MODEL_FLOPS bookkeeping follows the reference: 6·N·D for training (N =
params, D = tokens; N_active for MoE) and 2·N_active·D for prefill/decode
(D = tokens processed: B·S for prefill, B for one decode step).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs import ArchSpec, Shape


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    peak_flops: float  # per device, bf16 dense
    hbm_bw: float  # B/s per device
    link_bw: float  # B/s per link (the rate of any axis not in axis_link_bw)
    hbm_gib: float
    #: per device, float32 outside the tensor cores (0: not given)
    peak_flops_f32: float = 0.0
    #: (mesh axis, B/s per device) where an axis's links differ from link_bw
    axis_link_bw: Tuple[Tuple[str, float], ...] = ()

    def link_bw_of(self, axis: str) -> float:
        return dict(self.axis_link_bw).get(axis, self.link_bw)


#: The reference's TPU v5e constants, kept for parity with its roofline.
V5E = HardwareModel(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9, hbm_gib=16.0
)
#: NVIDIA H100 SXM (data sheet; dense rates without sparsity, at 700 W):
#: 989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s of HBM3, 80 GB.  Within an
#: 8-GPU node (the ``model`` axis) NVLink 4 moves 450 GB/s a direction; a
#: GPU's 400 Gb/s InfiniBand port (``data``, ``pod``) moves 50 GB/s.
H100_SXM = HardwareModel(
    name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9, hbm_gib=80.0,
    peak_flops_f32=67e12, axis_link_bw=(("model", 450e9),),
)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_dev: float
    n_devices: int
    hw: HardwareModel = V5E

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x devices) — remat/redundancy waste."""
        total = self.hlo_flops_per_dev * self.n_devices
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the bound: MODEL_FLOPS/(devices·peak) ÷
        max(term), at the peak of this roofline's hardware."""
        ideal = self.model_flops / (self.n_devices * self.hw.peak_flops)
        return ideal / self.bound_s if self.bound_s > 0 else 0.0


def model_flops(spec: ArchSpec, shape: Shape) -> float:
    """The reference's bookkeeping (6·N·D / 2·N_active·D)."""
    cfg = spec.config
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        return 2.0 * n_active * shape.global_batch
    raise ValueError(shape.kind)


def collective_seconds(cost, hw: HardwareModel) -> float:
    """Collective bytes over link rates: by mesh axis where the cost counts
    them so (each axis at its own rate), else all at ``hw.link_bw``."""
    by_axis = getattr(cost, "axis_bytes", None)
    if by_axis:
        return sum(b / hw.link_bw_of(axis) for axis, b in by_axis.items())
    return cost.total_collective / hw.link_bw


def roofline_from_cell(
    spec: ArchSpec,
    shape: Shape,
    mesh_name: str,
    n_devices: int,
    cost,
    hw: HardwareModel = V5E,
) -> RooflineTerms:
    """``cost``: per-device ``flops``, ``bytes`` and collective bytes (an
    :class:`repro_torch.roofline.op_costs.OpCost`, or any object with the
    reference ``HloCost``'s fields)."""
    return RooflineTerms(
        arch=spec.arch_id,
        shape=shape.name,
        mesh=mesh_name,
        compute_s=cost.flops / hw.peak_flops,
        memory_s=cost.bytes / hw.hbm_bw,
        collective_s=collective_seconds(cost, hw),
        model_flops=model_flops(spec, shape),
        hlo_flops_per_dev=cost.flops,
        n_devices=n_devices,
        hw=hw,
    )
