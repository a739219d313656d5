"""Weights from the seed, made on the device in a few large calls.

Every bf16 leaf is a view of one flat buffer filled with standard normals by
a ``torch.Generator`` on the device, then scaled in place: products by their
fan-in to the -1/2 (the port's ``dense_init``), the embedding and an untied
head by 0.02, and every other leaf of rank 2 or less (a stacked vector
``[L, n]`` or ``[n]``: the norms, the conv bias) by 0.1, so that a norm weight
the program dropped would show; every product is at least 3-D.
The SSM's float32 leaves come from one uniform draw: ``A_log = log(A)`` with
A in [1, 16], ``dt_bias`` the inverse softplus of dt log-uniform in [1e-3,
1e-1] (mamba2's initialisation ranges), ``D`` in [0.5, 1.5].  The tree has
the layout ``TransformerLM`` takes, and the same tensors go to the program
and to the reference.

A configuration may bring scale rules for leaves of its own (its file's
``weights``): ``fan_in_axes``, the axes whose sizes multiply to a leaf's
fan-in where that is not axis 1 (an expert stack ``[L, E, in, out]``:
``[2]``), which shapes cannot tell.  A rule names a leaf by its last key;
leaves no rule names keep the scales above.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

#: Each bf16 leaf starts on a multiple of this many elements (256 bytes).
ALIGN = 128
#: The embedding's standard deviation (GPT-2's initialisation).  With a tied
#: head, a table of standard deviation 1 would make every logit favour the
#: input token by far (the model would copy its input whatever its state),
#: and no output would depend on the attention or the SSM state.
EMBED_STD = 0.02
#: Elements drawn per call.
DRAW = 1 << 28

_FAN_IN_AXES = {"wo": (-3, -2)}  # [L, Hq, Dh, D]: fan-in Hq x Dh
_SSM_SCALARS = ("A_log", "D", "dt_bias")


def _leaves(tree: Dict, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_leaves(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def _scale(path: Tuple[str, ...], shape: Tuple[int, ...],
           rules: Optional[Dict[str, Any]] = None) -> float:
    name = path[-1]
    rules = rules or {}
    if name == "embed" or name == "lm_head":
        return EMBED_STD
    if len(shape) <= 2:
        return 0.1
    axes = rules.get("fan_in_axes", {}).get(name) or _FAN_IN_AXES.get(name)
    if axes:
        return math.prod(shape[a] for a in axes) ** -0.5
    if name == "conv_w":
        return shape[-2] ** -0.5
    # [L, in, ...] stacked products
    return shape[1] ** -0.5


def _put(tree: Dict, path: Tuple[str, ...], value: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_weights(shapes: Dict, seed: int, device: torch.device,
                 rules: Optional[Dict[str, Any]] = None) -> Dict:
    """The weight tree for ``shapes`` (``repro_torch``'s ``param_shapes``:
    ``(shape, dtype)`` leaves) from ``seed`` on ``device``, scaled by the
    configuration's ``rules`` where they name a leaf."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = _leaves(shapes)
    low = [(p, s) for p, (s, _) in leaves if p[-1] not in _SSM_SCALARS]
    f32 = [(p, s) for p, (s, _) in leaves if p[-1] in _SSM_SCALARS]
    dtypes = {dt for p, (_, dt) in leaves if p[-1] not in _SSM_SCALARS}
    if len(dtypes) != 1:
        raise ValueError(f"one dtype expected for the products and norms, got {dtypes}")
    dtype = dtypes.pop()
    offsets, total = [], 0
    for _, shape in low:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, DRAW):
        n = min(DRAW, total - start)
        flat[start:start + n] = torch.randn(n, generator=gen, device=device, dtype=dtype)
    tree: Dict = {}
    for (path, shape), off in zip(low, offsets):
        leaf = flat[off:off + math.prod(shape)].view(shape)
        leaf.mul_(_scale(path, shape, rules))
        _put(tree, path, leaf)
    if f32:
        sizes = [math.prod(s) for _, s in f32]
        u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
        for (path, shape), part in zip(f32, torch.split(u, sizes)):
            part = part.view(shape)
            name = path[-1]
            if name == "A_log":
                leaf = torch.log1p(15.0 * part)
            elif name == "dt_bias":
                dt = torch.exp(math.log(1e-3) + part * (math.log(1e-1) - math.log(1e-3)))
                leaf = dt + torch.log(-torch.expm1(-dt))
            else:
                leaf = 0.5 + part
            _put(tree, path, leaf.to(dict(leaves)[path][1]).contiguous())
    return tree
