"""Model-layout wrapper of the flash-decode kernel (port of
``repro/kernels/ops.py::decode_attention``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain version.  There is no fallback from one to the other.  The
reference's padding of G to 8 existed for the TPU's sublane tiling and is
dropped: the kernel takes any G.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.ref import decode_attention_ref


def decode_attention(
    q: torch.Tensor,  # [B, Hq, Dh] (one new token per sequence)
    k: torch.Tensor,  # [B, S, Hkv, Dh] (model layout) — newest at lengths-1
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    lengths: torch.Tensor,  # [B] valid token counts
    *,
    window: int = 1 << 30,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-decode GQA.  Returns [B, Hq, Dh]."""
    b, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if g * hkv != hq:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    qg = q.reshape(b, hkv, g, dh)
    # [B, Hkv, S, Dh] views: the kernel reads rows by stride, no copy.
    kk = k.transpose(1, 2)
    vv = v.transpose(1, 2)
    if q.device.type == "cuda":
        out = decode_attention_cuda(qg, kk, vv, lengths.to(torch.int32),
                                    window=window, softcap=softcap, scale=scale)
    elif q.device.type == "cpu":
        out = decode_attention_ref(qg, kk, vv, lengths, window=window,
                                   softcap=softcap, scale=scale)
    else:
        raise ValueError(f"decode_attention has no path for device {q.device}")
    return out.reshape(b, hq, dh)
