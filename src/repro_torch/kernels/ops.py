"""Model-layout wrappers of the port's model kernels (port of
``repro/kernels/ops.py``): flash-decode GQA and the SSD chunked scan.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain version.  There is no fallback from one to the other.  The
reference's padding of G to 8 existed for the TPU's sublane tiling and is
dropped: the kernel takes any G.  The reference's halving of the scan's
chunk until it divides S is dropped too (a prime prompt length would fall
to chunk 1): S is padded to a chunk multiple with dt = 0 instead, as
``models/ssm.py::ssd_chunked`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.ref import decode_attention_ref, ssd_scan_chunked_ref
from repro_torch.kernels.ssd_scan import ssd_scan_cuda


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


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P] (model layout)
    dt: torch.Tensor,  # [B, S, H] f32 (post-softplus)
    bmat: torch.Tensor,  # [B, S, N] (G = 1)
    cmat: torch.Tensor,  # [B, S, N]
    a: torch.Tensor,  # [H] f32 negative
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with chunks of ``min(chunk, S)`` steps.  Returns
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] f32).  No path of
    the reference seeds the state, so ``initial_state`` must be None."""
    if initial_state is not None:
        raise NotImplementedError("ssd_scan starts from a zero state")
    ck = min(chunk, x.shape[1])
    if x.device.type == "cuda":
        # The kernel reads the model layout by strides and pads a ragged
        # last chunk itself.
        return ssd_scan_cuda(x, dt.float(), bmat, cmat, a.float(), chunk=ck)
    if x.device.type == "cpu":
        y, state = ssd_scan_chunked_ref(x.transpose(1, 2), dt.transpose(1, 2),
                                        torch.stack([bmat, cmat], dim=2), a, chunk=ck)
        return y.transpose(1, 2), state
    raise ValueError(f"ssd_scan has no path for device {x.device}")
