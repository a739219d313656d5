"""The weights bridge: the reference's parameter tree, as numpy, into the port.

The reference and the port draw random weights from different generators,
so parity runs share weights, not seeds: the caller converts the
reference's ``TransformerLM.init(...)[0]`` to a nested dict of numpy arrays
(``np.asarray`` on each leaf) and hands it here.  The port never sees a
framework array of the reference.  :func:`train_state_from_numpy` does the
same for a whole training state (params, AdamW's state, the
error-feedback residual).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import ModelConfig, param_shapes
from repro_torch.optim.adamw import OptState
from repro_torch.train.step import TrainState


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


def train_state_from_numpy(state: Any, cfg: ModelConfig, device=None) -> TrainState:
    """The port's ``TrainState`` from the reference's, its leaves numpy
    arrays (``jax.tree.map(np.asarray, state)``): params as
    :func:`params_from_numpy` casts them, ``m``, ``v``, the master copy and
    the residual (when present) in f32 with the params' shapes, ``step``
    int32; raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    f32 = _retype(param_shapes(cfg), torch.float32)

    def f32_tree(tree: Optional[Any], path: str) -> Optional[Dict[str, Any]]:
        return None if tree is None else _convert(tree, f32, dev, path)

    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, cfg, dev),
        opt=OptState(step=torch.tensor(np.asarray(opt.step), dtype=torch.int32, device=dev),
                     m=f32_tree(opt.m, "opt/m"), v=f32_tree(opt.v, "opt/v"),
                     master=f32_tree(opt.master, "opt/master")),
        ef_residual=f32_tree(state.ef_residual, "ef_residual"),
    )


def _retype(leaves: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    return {k: _retype(v, dtype) if isinstance(v, dict) else (v[0], dtype)
            for k, v in leaves.items()}
