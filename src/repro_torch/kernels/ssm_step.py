"""Build, bind and launch the fused SSM decode-step kernel (``csrc/ssm_step.cu``).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (:mod:`repro_torch.kernels._nvcc`),
and loaded with ``ctypes``.  Nothing is built when this module is imported.

One decode step of every Mamba-2 head: the f32 state ``h`` [B, H, P, N] is
decayed and fed in place, and the read-out ``y`` [B, H, P] comes from the
same pass over it.  The launcher takes the model layout: x [B, H, P],
dt_raw [B, H] (before ``dt_bias`` and the softplus), B and C [B, G, N],
each by strides of any layout (the views the model cuts from its conv
output and input projection are read in place), and ``dt_bias``,
``A_log`` and ``D`` [H] in f32.  P is a multiple of 16, at most 64; N is
16, 32, 64 or 128 (the kernel is built for those alone, each tested on the
card); G divides H.

:func:`ssm_step_ref` is the plain version, the arithmetic the model ran as
separate PyTorch ops; it updates ``h`` in place too.  The kernel rounds each
product and sum of the update as it does, so the new state is the plain
version's bit for bit on the card; ``y`` differs only by the order of its
sum over N.

:data:`LAUNCHES` counts wrapper calls that launched the kernel; callers
reset it around the run they want to attribute.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.invariants import require
from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import LaunchCounter

SOURCE = _nvcc.CudaSource("ssm_step")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
STATES = (16, 32, 64, 128)
LAUNCHES = LaunchCounter()

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
        fn = lib.ssm_step_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssm_step_error_string.argtypes = [ctypes.c_int]
        lib.ssm_step_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssm_step_ref(
    h: torch.Tensor,  # [B, H, P, N] f32, updated in place
    x: torch.Tensor,  # [B, H, P]
    dt_raw: torch.Tensor,  # [B, H]
    bmat: torch.Tensor,  # [B, G, N]
    cmat: torch.Tensor,  # [B, G, N]
    dt_bias: torch.Tensor,  # [H] f32
    a_log: torch.Tensor,  # [H] f32
    d: torch.Tensor,  # [H] f32
) -> torch.Tensor:
    """The plain version: ``h`` decayed by ``exp(dt a)`` and fed ``dt x B``,
    in place; returns ``y = h C + D x`` [B, H, P] in x's dtype.  Each head
    reads the B and C of its group."""
    rep = h.shape[1] // bmat.shape[1]
    dt = F.softplus(dt_raw.float() + dt_bias)  # [B, H]
    da = torch.exp(dt * -torch.exp(a_log))  # [B, H]
    b1 = bmat.repeat_interleave(rep, dim=1).float()  # [B, H, N]
    c1 = cmat.repeat_interleave(rep, dim=1).float()  # [B, H, N]
    x1 = x.float()
    new_h = h * da[:, :, None, None] + torch.einsum("bhp,bhn->bhpn", dt[:, :, None] * x1, b1)
    y = torch.einsum("bhpn,bhn->bhp", new_h, c1) + d[None, :, None] * x1
    h.copy_(new_h)
    return y.to(x.dtype)


def _check(h, x, dt_raw, bmat, cmat, dt_bias, a_log, d) -> None:
    """Raise a structured error for inputs the kernel does not take; the
    device last, so that every other rule can be tried on the CPU."""
    require(h.dtype == torch.float32
            and all(t.dtype == torch.float32 for t in (dt_bias, a_log, d)), "ssm-step-dtype",
            "the state, dt_bias, A_log and D must be float32",
            dtypes=(h.dtype, dt_bias.dtype, a_log.dtype, d.dtype))
    require(x.dtype in _DTYPES and all(t.dtype == x.dtype for t in (dt_raw, bmat, cmat)),
            "ssm-step-dtype", "x, dt_raw, B and C must share float32 or bfloat16",
            dtypes=(x.dtype, dt_raw.dtype, bmat.dtype, cmat.dtype))
    require(h.dim() == 4 and x.dim() == 3 and dt_raw.dim() == 2 and bmat.dim() == 3
            and cmat.dim() == 3, "ssm-step-shape",
            "expected h [B,H,P,N], x [B,H,P], dt_raw [B,H], B and C [B,G,N]",
            h=tuple(h.shape), x=tuple(x.shape), dt=tuple(dt_raw.shape), b=tuple(bmat.shape),
            c=tuple(cmat.shape))
    b, nh, p, n = h.shape
    g = bmat.shape[1]
    require(x.shape == (b, nh, p) and dt_raw.shape == (b, nh) and bmat.shape == (b, g, n)
            and cmat.shape == (b, g, n) and all(t.shape == (nh,) for t in (dt_bias, a_log, d))
            and b > 0 and g > 0 and nh % g == 0, "ssm-step-shape",
            "expected h [B,H,P,N], x [B,H,P], dt_raw [B,H], B and C [B,G,N] with G dividing "
            "H, dt_bias, A_log and D [H]",
            h=tuple(h.shape), x=tuple(x.shape), dt=tuple(dt_raw.shape), b=tuple(bmat.shape),
            c=tuple(cmat.shape))
    require(0 < p <= MAX_HEAD_DIM and p % 16 == 0 and n in STATES, "ssm-step-shape",
            f"the kernel takes a head_dim that is a multiple of 16, at most {MAX_HEAD_DIM}, "
            f"and a state of {STATES}", head_dim=p, state=n)
    require(h.is_contiguous() and h.data_ptr() % 16 == 0
            and all(t.is_contiguous() for t in (dt_bias, a_log, d)), "ssm-step-layout",
            "the state must be contiguous and 16-byte aligned (it is read 16 bytes at a time), "
            "dt_bias, A_log and D contiguous",
            h=h.stride(), offset=h.data_ptr() % 16)
    inputs = (h, x, dt_raw, bmat, cmat, dt_bias, a_log, d)
    require(h.is_cuda and all(t.device == h.device for t in inputs), "ssm-step-device",
            "every input must be on the state's CUDA device",
            devices=sorted({str(t.device) for t in inputs}))


def ssm_step_cuda(
    h: torch.Tensor,  # [B, H, P, N] f32, contiguous, updated in place
    x: torch.Tensor,  # [B, H, P], any strides
    dt_raw: torch.Tensor,  # [B, H], any strides
    bmat: torch.Tensor,  # [B, G, N], any strides
    cmat: torch.Tensor,  # [B, G, N], any strides
    dt_bias: torch.Tensor,  # [H] f32
    a_log: torch.Tensor,  # [H] f32
    d: torch.Tensor,  # [H] f32
) -> torch.Tensor:
    """Launch the kernel on the current stream: ``h`` is updated in place;
    returns y [B, H, P] in x's dtype."""
    _check(h, x, dt_raw, bmat, cmat, dt_bias, a_log, d)
    b, nh, p, n = h.shape
    y = torch.empty((b, nh, p), dtype=x.dtype, device=h.device)
    lib = _lib or _load()
    err = lib.ssm_step_launch(
        h.data_ptr(), x.data_ptr(), dt_raw.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        dt_bias.data_ptr(), a_log.data_ptr(), d.data_ptr(), y.data_ptr(),
        b, nh, p, n, bmat.shape[1], _DTYPES[x.dtype],
        *x.stride(), *dt_raw.stride(), *bmat.stride(), *cmat.stride(),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        msg = lib.ssm_step_error_string(err).decode()
        raise RuntimeError(f"ssm_step launch failed: {msg} ({err})")
    LAUNCHES.count += 1
    return y
