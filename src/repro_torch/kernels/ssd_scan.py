"""Build, bind and launch the SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (:mod:`repro_torch.kernels._nvcc`),
and loaded with ``ctypes``.  Nothing is built when this module is imported.

The launcher takes the model layout: x [B, S, H, P], dt [B, S, H] f32, and
B and C [B, S, N] (one group), each by strides with its last dimension
contiguous, so the views the model cuts from its [B, S, conv_dim]
projection are read in place.  A chunk of any length from 1 to 128 is
taken; a ragged last chunk is padded inside the kernel with dt = 0.

:data:`LAUNCHES` counts kernel launches (one per :func:`ssd_scan_cuda` call);
callers reset it around the run they want to attribute.  The plain version
is :func:`repro_torch.kernels.ref.ssd_scan_chunked_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.invariants import require
from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import LaunchCounter

SOURCE = _nvcc.CudaSource("ssd_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The register tiles and shared memory of the kernel are sized for these.
MAX_CHUNK = 128
MAX_HEAD_DIM = 64
MAX_STATE = 128

LAUNCHES = LaunchCounter()

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
        fn = lib.ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssd_scan_cuda(
    x: torch.Tensor,  # [B, S, H, P], P contiguous
    dt: torch.Tensor,  # [B, S, H] f32
    bmat: torch.Tensor,  # [B, S, N], N contiguous
    cmat: torch.Tensor,  # [B, S, N], N contiguous
    a: torch.Tensor,  # [H] f32
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream with chunks of ``chunk``
    steps (at most 128; the caller takes ``min(chunk, S)``).  Returns
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    tensors = (x, dt, bmat, cmat, a)
    require(x.is_cuda and all(t.device == x.device for t in tensors), "ssd-scan-device",
            "x, dt, B, C and a must be on one CUDA device",
            devices=sorted({str(t.device) for t in tensors}))
    require(x.dtype in _DTYPES and bmat.dtype == x.dtype and cmat.dtype == x.dtype,
            "ssd-scan-dtype", "x, B and C must share float32 or bfloat16",
            dtypes=(x.dtype, bmat.dtype, cmat.dtype))
    require(dt.dtype == torch.float32 and a.dtype == torch.float32, "ssd-scan-dtype",
            "dt and a must be float32", dtypes=(dt.dtype, a.dtype))
    require(tuple(dt.shape) == (b, s, h) and tuple(bmat.shape) == (b, s, n)
            and tuple(cmat.shape) == (b, s, n) and tuple(a.shape) == (h,),
            "ssd-scan-shape", "expected x [B,S,H,P], dt [B,S,H], B/C [B,S,N], a [H]",
            x=tuple(x.shape), dt=tuple(dt.shape), b=tuple(bmat.shape),
            c=tuple(cmat.shape), a=tuple(a.shape))
    require(0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE and s > 0 and b > 0 and h > 0,
            "ssd-scan-shape",
            f"the kernel takes head_dim 1..{MAX_HEAD_DIM} and state 1..{MAX_STATE}",
            head_dim=p, state=n, seq=s)
    require(0 < chunk <= min(MAX_CHUNK, s), "ssd-scan-chunk",
            f"chunk must be in 1..min({MAX_CHUNK}, S)", chunk=chunk, seq=s)
    require(x.stride(3) == 1 and bmat.stride(2) == 1 and cmat.stride(2) == 1,
            "ssd-scan-layout", "x's head dim and B's and C's state dim must be contiguous",
            x=x.stride(), b=bmat.stride(), c=cmat.stride())
    a = a.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _load()
    strides = [(ctypes.c_int64 * 3)(*t.stride()[:3]) for t in (x, dt)]
    strides += [(ctypes.c_int64 * 2)(*t.stride()[:2]) for t in (bmat, cmat)]
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, h, p, n, chunk, _DTYPES[x.dtype],
        *strides, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({err})")
    LAUNCHES.count += 1
    return y, state
