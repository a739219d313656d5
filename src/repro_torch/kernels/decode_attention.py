"""Build, bind and launch the flash-decode GQA kernel (``csrc/decode_attention.cu``).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (:mod:`repro_torch.kernels._nvcc`),
and loaded with ``ctypes``.  Nothing is built or imported from the toolkit
when this module is imported.

:data:`LAUNCHES` counts kernel launches (one per :func:`decode_attention_cuda`
call); callers reset it around the run they want to attribute.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.invariants import require
from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import LaunchCounter

SOURCE = _nvcc.CudaSource("decode_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

LAUNCHES = LaunchCounter()

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_rows(name: str, t: torch.Tensor) -> None:
    """K/V rows are read with 16-byte loads from strided positions."""
    esize = t.element_size()
    require(t.stride(3) == 1, "decode-attention-layout",
            f"{name}: the head dimension must be contiguous", stride=t.stride())
    require(t.data_ptr() % 16 == 0
            and all(st * esize % 16 == 0 for st in t.stride()[:3]),
            "decode-attention-layout", f"{name}: rows must be 16-byte aligned",
            stride=t.stride())


def decode_attention_cuda(
    q: torch.Tensor,  # [B, Hkv, G, Dh]
    k: torch.Tensor,  # [B, Hkv, S, Dh], any strides with Dh contiguous
    v: torch.Tensor,  # [B, Hkv, S, Dh]
    lengths: torch.Tensor,  # [B] int32
    *,
    window: int = 1 << 30,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns [B, Hkv, G, Dh]."""
    b, hkv, g, dh = q.shape
    s = k.shape[2]
    require(q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device, "decode-attention-device",
            "q, k, v and lengths must be on one CUDA device")
    require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
            "decode-attention-dtype", "q, k, v must share float32 or bfloat16",
            dtypes=(q.dtype, k.dtype, v.dtype))
    require(dh in _HEAD_DIMS, "decode-attention-shape", "head_dim must be 64 or 128",
            head_dim=dh)
    require(tuple(k.shape) == (b, hkv, s, dh) and k.shape == v.shape
            and tuple(lengths.shape) == (b,), "decode-attention-shape",
            "expected q [B,Hkv,G,Dh], k/v [B,Hkv,S,Dh], lengths [B]",
            q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape),
            lengths=tuple(lengths.shape))
    require(lengths.dtype == torch.int32, "decode-attention-dtype",
            "lengths must be int32", dtype=lengths.dtype)
    require(0 < window < 1 << 31, "decode-attention-window",
            "window must fit a positive int32", window=window)
    require(softcap is None or softcap > 0, "decode-attention-softcap",
            "softcap must be positive or None", softcap=softcap)
    _check_rows("k", k)
    _check_rows("v", v)
    q = q.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    if scale is None:
        scale = dh**-0.5
    lib = _load()
    k_strides = (ctypes.c_int64 * 3)(*k.stride()[:3])
    v_strides = (ctypes.c_int64 * 3)(*v.stride()[:3])
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, s, dh, _DTYPES[q.dtype], k_strides, v_strides,
        float(scale), int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({err})")
    LAUNCHES.count += 1
    return out
