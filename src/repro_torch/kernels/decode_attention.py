"""Build, bind and launch the flash-decode GQA kernel (``csrc/decode_attention.cu``).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (:mod:`repro_torch.kernels._nvcc`),
and loaded with ``ctypes``.  Nothing is built or imported from the toolkit
when this module is imported.

The kernel splits each row's cache across ``n_split`` blocks
(:func:`split_count`, chosen here from the shapes and the card, never from
the device-side lengths) and, when ``n_split > 1``, merges the blocks' f32
partials with a second small kernel; :func:`launch_plan` says what one call
launches.  The plain version of exactly that arithmetic is
:func:`repro_torch.kernels.ref.decode_attention_split_ref`.

:data:`LAUNCHES` counts wrapper calls that launched the kernel (one per
:func:`decode_attention_cuda` call, however many device kernels it ran);
callers reset it around the run they want to attribute.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.invariants import require
from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import LaunchCounter

SOURCE = _nvcc.CudaSource("decode_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128, 160)

#: No split is cut shorter than this many positions (of the cache length S):
#: each split pays the fill of its staging ring, its warps' merge and a
#: share of the combine, so at B = 1 and S = 32768 16 splits of 2048 run
#: faster than the 33 that would fill a wave.
MIN_SPLIT = 2048

LAUNCHES = LaunchCounter()

_lib: Optional[ctypes.CDLL] = None
#: (device, dh, dtype) -> (resident blocks on the card, query rows a block takes)
_plan_consts: Dict[Tuple[int, int, int], Tuple[int, int]] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
        lib.decode_attention_g_chunk.argtypes = []
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def split_count(s: int, row_blocks: int, resident_blocks: int) -> int:
    """Blocks per cache row: the most that keeps all ``row_blocks x n``
    blocks in one wave of ``resident_blocks``, at least 1, and no split
    under :data:`MIN_SPLIT` positions of ``s`` (so a cache of up to 2048
    positions, the serve shape's 96 included, is never split)."""
    return max(1, min(-(-s // MIN_SPLIT), resident_blocks // row_blocks))


def launch_plan(b: int, hkv: int, g: int, s: int, dh: int, dtype: torch.dtype,
                device: torch.device) -> Dict[str, int]:
    """What one call on these shapes launches on ``device``: ``n_split``,
    the split kernel's ``blocks``, ``resident_blocks`` (SMs x blocks per
    SM).  A call runs the split kernel, and the combine kernel when
    ``n_split > 1``."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, dh, _DTYPES[dtype])
    if key not in _plan_consts:
        lib = _load()
        with torch.cuda.device(idx):
            n = lib.decode_attention_blocks_per_sm(dh, _DTYPES[dtype])
        if n <= 0:
            msg = lib.decode_attention_error_string(-n).decode() if n else "0 blocks"
            raise RuntimeError(f"decode_attention does not fit an SM: {msg}")
        _plan_consts[key] = (n * torch.cuda.get_device_properties(idx).multi_processor_count,
                             lib.decode_attention_g_chunk())
    resident, g_chunk = _plan_consts[key]
    row_blocks = b * hkv * -(-g // g_chunk)
    n_split = split_count(s, row_blocks, resident)
    return dict(n_split=n_split, blocks=row_blocks * n_split, resident_blocks=resident)


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
    require(dh in _HEAD_DIMS, "decode-attention-shape",
            "head_dim must be 32, 64, 80, 128 or 160", head_dim=dh)
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
    n_split = launch_plan(b, hkv, g, s, dh, q.dtype, q.device)["n_split"]
    # Split partials: m and l [B, Hkv, n_split, G], then acc [..., Dh], f32.
    part = (torch.empty(b * hkv * n_split * g * (dh + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    k_strides = (ctypes.c_int64 * 3)(*k.stride()[:3])
    v_strides = (ctypes.c_int64 * 3)(*v.stride()[:3])
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        b, hkv, g, s, dh, _DTYPES[q.dtype], n_split, k_strides, v_strides,
        float(scale), int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({err})")
    LAUNCHES.count += 1
    return out
