"""The weights bridge: the reference's parameter tree, as numpy, into the port.

The reference and the port draw random weights from different generators,
so parity runs share weights, not seeds: the caller converts the
reference's ``TransformerLM.init(...)[0]`` to a nested dict of numpy arrays
(``np.asarray`` on each leaf) and hands it here.  The port never sees a
framework array of the reference.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import ModelConfig, param_shapes


def _convert(tree: Any, leaves: Any, device: torch.device, path: str) -> Any:
    if isinstance(leaves, dict):
        if not isinstance(tree, dict) or set(tree) != set(leaves):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: expected keys {sorted(leaves)}, got {got}")
        return {k: _convert(tree[k], leaves[k], device, f"{path}/{k}") for k in leaves}
    shapes, dtype = leaves
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(shapes):
        raise ValueError(f"{path}: expected shape {shapes}, got {arr.shape}")
    if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
        # bfloat16 (an extension dtype numpy cannot hand to torch) and f16
        # widen exactly to f32 first.
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The port's parameters from the reference's tree of numpy arrays on
    ``device``, each leaf cast to its dtype in
    :func:`~repro_torch.models.transformer.param_shapes` (``cfg.dtype``, or
    float32 for the SSM's ``A_log``, ``D`` and ``dt_bias``); raises on a
    missing, extra or misshapen leaf."""
    return _convert(tree, param_shapes(cfg), resolve_device(device), "")
