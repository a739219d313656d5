"""Plain PyTorch versions of the port's kernels.

``decode_attention_ref`` follows ``repro/kernels/ref.py``'s oracle: full
materialization of the scores, f32 scores and softmax, the same ``NEG_INF``
mask, window and softcap.  The CPU path of :mod:`repro_torch.kernels.ops`
runs it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hkv, G, Dh]
    k: torch.Tensor,  # [B, Hkv, S, Dh]
    v: torch.Tensor,  # [B, Hkv, S, Dh]
    lengths: torch.Tensor,  # [B] int32 valid token counts
    *,
    window: int = 1 << 30,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    dh = q.shape[-1]
    s = k.shape[2]
    if scale is None:
        scale = dh**-0.5
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float() * scale, k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)[None, :]  # [1, S]
    length = lengths.to(device=q.device, dtype=torch.int64)[:, None]  # [B, 1]
    valid = (pos < length) & (length - 1 - pos < window)  # [B, S]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v.float())
    return out.to(q.dtype)
