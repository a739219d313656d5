"""PyTorch/CUDA port of the tiered-memory serving path.

Mirrors the module layout of the JAX package ``repro`` so each counterpart
is easy to find, but imports nothing from it (nor from ``jax``): what the
port needs of the pure-Python layers is copied under ``repro_torch.core`` and
``repro_torch.obs``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
