"""Memory-tier specifications of the serving runtime, and tier placement.

The fast tier is device memory; the slow tier is pinned host memory over
the host link.  The constants are the reference's TPU-v5e-flavoured ones
(``repro/core/tiers.py``), kept as the parity default so that the port's
simulated serving clock equals the reference's; they do not describe an
H100.  :func:`put_on_tier` is the torch counterpart of the reference's
memory-kind placement: a tensor on the fast tier lives on the device, one
on the slow tier in pinned host memory beside a CUDA device.
:class:`TieredLayout` says how one KV cache or parameter bank splits
across the two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

#: The reference's memory-kind names: device memory and pinned host memory.
DEVICE = "device"
PINNED_HOST = "pinned_host"


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory tier of the serving/training runtime."""

    name: str
    bandwidth_gbps: float  # B/ns per chip
    capacity_gib: float  # per chip
    #: Max concurrently in-flight fetch streams before device-side queueing
    #: explodes (the paper's hardware-parallelism disparity).
    parallelism: int
    #: Where a tensor on this tier lives: :data:`DEVICE` or :data:`PINNED_HOST`.
    memory_kind: str = DEVICE


HBM_TIER = TierSpec(name="hbm", bandwidth_gbps=819.0, capacity_gib=16.0,
                    parallelism=64, memory_kind=DEVICE)
HOST_TIER = TierSpec(name="host", bandwidth_gbps=16.0, capacity_gib=256.0,
                     parallelism=8, memory_kind=PINNED_HOST)


def host_offload_supported(device: torch.device) -> bool:
    """Pinned host memory exists only beside a CUDA device; on the CPU a
    host-placed instance keeps its tensors where they are."""
    return device.type == "cuda"


def put_on_tier(x: torch.Tensor, tier: TierSpec, device=None) -> torch.Tensor:
    """``x`` placed on ``tier`` beside ``device`` (the card unless ``"cpu"``).

    The fast tier moves ``x`` to ``device``.  The slow tier moves it to the
    CPU, pinned when ``device`` is CUDA; pinning failure raises.  On a CPU
    ``device`` there is no pinned memory (as the reference stays on
    ``"device"`` where there is no pinned_host), so ``x`` stays an ordinary
    CPU tensor."""
    dev = resolve_device(device)
    if tier.memory_kind == DEVICE:
        return x.to(dev)
    if not host_offload_supported(dev):
        return x.to("cpu")
    if x.device.type == "cpu" and x.is_pinned():
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x)


@dataclasses.dataclass(frozen=True)
class TieredLayout:
    """How one logical KV cache (or parameter bank) splits across tiers.

    ``hot_tokens`` is the device-resident suffix window (the most recent
    tokens, which decode touches every step); everything older lives on the
    host tier in ``page_tokens``-sized pages fetched on demand.  For
    sliding-window-attention layers the hot window is the attention window.
    """

    total_tokens: int
    hot_tokens: int
    page_tokens: int = 2048

    def __post_init__(self):
        assert 0 < self.hot_tokens <= self.total_tokens
        assert self.page_tokens > 0

    @property
    def cold_tokens(self) -> int:
        return self.total_tokens - self.hot_tokens

    @property
    def n_cold_pages(self) -> int:
        return -(-self.cold_tokens // self.page_tokens)  # ceil

    def page_slice(self, page: int) -> slice:
        start = page * self.page_tokens
        return slice(start, min(start + self.page_tokens, self.cold_tokens))

    def bytes_per_token(self, n_kv_heads: int, head_dim: int, n_layers: int,
                        dtype_bytes: int = 2) -> int:
        return 2 * n_kv_heads * head_dim * n_layers * dtype_bytes  # K and V

    def cold_bytes(self, n_kv_heads: int, head_dim: int, n_layers: int,
                   dtype_bytes: int = 2) -> int:
        return self.cold_tokens * self.bytes_per_token(
            n_kv_heads, head_dim, n_layers, dtype_bytes
        )


def estimate_fetch_ns(nbytes: int, tier: TierSpec) -> float:
    """First-order fetch-time estimate for the simulated serving clock."""
    return nbytes / max(tier.bandwidth_gbps, 1e-9)  # B / (B/ns) = ns


def np_bytes(x) -> int:
    """Bytes of an array or tensor with ``shape`` and ``dtype.itemsize``."""
    return int(np.prod(x.shape)) * x.dtype.itemsize
