"""Build, bind and launch the SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (:mod:`repro_torch.kernels._nvcc`),
and loaded with ``ctypes``.  Nothing is built when this module is imported.

The launcher takes the model layout: x [B, S, H, P], dt [B, S, H] f32, and
B and C [B, S, N] (one group) or [B, S, G, N] (G groups, each read by the
H / G heads of its group), each by strides with its last dimension
contiguous and its rows 16-byte aligned, so the views the model cuts from
its [B, S, conv_dim] projection are read in place.  P and N are multiples
of 16 (at most 64 and 128).  A chunk of any length from 1 to 128 is taken;
a ragged last chunk is padded inside the kernel with dt = 0.

A sequence of one chunk runs one device kernel; a longer one runs three
(chunk states, the state pass, chunk outputs) through f32 scratch that this
wrapper allocates.  :func:`launch_plan` says what a call launches; it is a
pure function of the shapes, the SM count and the Stage C blocks an SM
holds (which the library reports as compiled), cached per shape here.

:data:`LAUNCHES` counts wrapper calls that launched the kernels (one per
:func:`ssd_scan_cuda` call, however many device kernels it ran); callers
reset it around the run they want to attribute.  The plain versions are
:func:`repro_torch.kernels.ref.ssd_scan_chunked_ref` and, rounding where
the kernels round, :func:`repro_torch.kernels.ref.ssd_scan_staged_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.invariants import InvariantViolation
from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import LaunchCounter

SOURCE = _nvcc.CudaSource("ssd_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The register tiles and shared memory of the kernels are sized for these.
MAX_CHUNK = 128
MAX_HEAD_DIM = 64
MAX_STATE = 128
LAUNCHES = LaunchCounter()

_lib: Optional[ctypes.CDLL] = None
_device_consts: Dict[tuple, Tuple[int, int]] = {}
_plans: Dict[tuple, Dict[str, int]] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
        fn = lib.ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] + [ctypes.c_int] * 9
                       + [ctypes.c_int64] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ssd_scan_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssd_scan_blocks_per_sm.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_plan(b: int, s: int, h: int, p: int, n: int, chunk: int, dtype: torch.dtype,
                sm_count: int, blocks_per_sm: int, groups: int = 1) -> Dict[str, int]:
    """What one call on these shapes launches, on a card of ``sm_count`` SMs
    that hold ``blocks_per_sm`` Stage C blocks each.  A block takes heads
    of one of the ``groups`` groups of B and C only, so ``heads_per_block``
    is at most ``h / groups`` and ``head_groups`` counts the head blocks of
    every group (at ``groups`` = 1, the plan is what it was before groups).

    ``heads_per_block`` (hpb) is chosen by a cost model of Stage C: its
    blocks run in ``ceil(blocks / wave)`` waves of ``blocks_per_sm x
    sm_count`` resident blocks, and a block costs about ``hpb + 1`` heads'
    time (one for its C B^T and its B and C loads).  The hpb of least
    ``waves x (hpb + 1)`` wins, the larger on a tie (more heads share one
    C B^T), among those that leave at least ``sm_count`` blocks wherever
    there are that many (chunk, head, batch row) units.  At H = 80 on 132
    SMs: 1 at S <= 256 (B = 1), 5 at S = 2048 (256 bf16 blocks in one wave
    of 264 at 2 blocks an SM; f32, 1 an SM: 256 blocks in two waves of
    132), 20 at S = 8192.  Stage A uses the same grid; Stage B has one
    block per 1024 state elements of each (head, batch row).
    ``device_kernels_per_call`` is 1 for one chunk (the fused kernel) and 3
    above; ``scratch_bytes`` is what the wrapper allocates (0 for one
    chunk).  Only the number of chunks of ``s`` matters."""
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    wave = blocks_per_sm * sm_count
    units = nc * h * b
    hpg = h // groups
    best = None
    for cand in range(1, hpg + 1):
        blocks = nc * b * groups * -(-hpg // cand)
        if blocks < min(sm_count, units):
            break  # fewer blocks still for every larger cand
        cost = -(-blocks // wave) * (cand + 1)
        if best is None or cost <= best[0]:
            best = (cost, cand)
    hpb = best[1]
    groups = groups * -(-hpg // hpb)
    blocks = nc * groups * b
    if nc == 1:
        return dict(n_chunks=1, heads_per_block=hpb, head_groups=groups,
                    blocks_state=0, blocks_pass=0, blocks_chunk=blocks,
                    device_kernels_per_call=1, scratch_bytes=0, wave_blocks=wave)
    states = b * h * nc * p * n
    scratch = 4 * (states + -(-(b * h * nc) // 4) * 4)
    if dtype == torch.bfloat16:
        scratch += 2 * states  # h_in in bf16, beside s_c
    return dict(n_chunks=nc, heads_per_block=hpb, head_groups=groups, blocks_state=blocks,
                blocks_pass=-(-(p * n // 4) // 256) * h * b, blocks_chunk=blocks,
                device_kernels_per_call=3, scratch_bytes=scratch, wave_blocks=wave)


def device_consts(dtype: torch.dtype, device: torch.device) -> Tuple[int, int]:
    """(SMs, resident Stage C blocks an SM) of ``device`` for ``dtype``:
    the second as compiled, from CUDA's occupancy calculator in the
    library (``ssd_scan_blocks_per_sm``), read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, dtype)
    if key not in _device_consts:
        lib = _lib or _load()
        with torch.cuda.device(idx):
            n = lib.ssd_scan_blocks_per_sm(_DTYPES[dtype], 1)
        if n <= 0:
            msg = lib.ssd_scan_error_string(-n).decode() if n else "0 blocks"
            raise RuntimeError(f"ssd_chunk_kernel does not fit an SM: {msg}")
        _device_consts[key] = (torch.cuda.get_device_properties(idx).multi_processor_count, n)
    return _device_consts[key]


def plan_for(b: int, s: int, h: int, p: int, n: int, chunk: int, dtype: torch.dtype,
             device: torch.device, groups: int = 1) -> Dict[str, int]:
    """:func:`launch_plan` for ``device``, cached per shape and number of
    chunks (``chunk`` at most ``s``)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (b, -(-s // chunk), h, p, n, chunk, dtype, idx, groups)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = launch_plan(b, s, h, p, n, chunk, dtype,
                                         *device_consts(dtype, device), groups=groups)
    return plan


def rows_aligned(t: torch.Tensor) -> bool:
    """Rows of ``t`` (its last dimension contiguous) start on 16-byte
    boundaries: the kernels stage them with 16-byte ``cp.async`` copies."""
    esize = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * esize % 16 == 0 for st in t.stride()[:-1]))


def _check(x, dt, bmat, cmat, a, chunk) -> None:
    """Raise a structured error for inputs the kernels do not take.  Each
    rule is tested once; its context is built only when it fails."""
    b, s, h, p = x.shape
    g, n = bmat.shape[-2], bmat.shape[-1]
    dev = x.device
    if not (x.is_cuda and dt.device == dev and bmat.device == dev and cmat.device == dev
            and a.device == dev):
        raise InvariantViolation(
            "ssd-scan-device", "x, dt, B, C and a must be on one CUDA device",
            context=dict(devices=sorted({str(t.device) for t in (x, dt, bmat, cmat, a)})))
    if not (x.dtype in _DTYPES and bmat.dtype == x.dtype and cmat.dtype == x.dtype):
        raise InvariantViolation(
            "ssd-scan-dtype", "x, B and C must share float32 or bfloat16",
            context=dict(dtypes=(x.dtype, bmat.dtype, cmat.dtype)))
    if not (dt.dtype == torch.float32 and a.dtype == torch.float32):
        raise InvariantViolation("ssd-scan-dtype", "dt and a must be float32",
                                 context=dict(dtypes=(dt.dtype, a.dtype)))
    if not (dt.shape == (b, s, h) and bmat.shape == (b, s, g, n) and cmat.shape == (b, s, g, n)
            and a.shape == (h,) and h % g == 0):
        raise InvariantViolation(
            "ssd-scan-shape", "expected x [B,S,H,P], dt [B,S,H], B/C [B,S,N] or [B,S,G,N] "
            "with G dividing H, a [H]",
            context=dict(x=tuple(x.shape), dt=tuple(dt.shape), b=tuple(bmat.shape),
                         c=tuple(cmat.shape), a=tuple(a.shape)))
    if not (0 < p <= MAX_HEAD_DIM and p % 16 == 0 and 0 < n <= MAX_STATE and n % 16 == 0
            and s > 0 and b > 0 and h > 0):
        raise InvariantViolation(
            "ssd-scan-shape", f"the kernels take head_dim and state multiples of 16, at "
            f"most {MAX_HEAD_DIM} and {MAX_STATE}", context=dict(head_dim=p, state=n, seq=s))
    if not 0 < chunk <= min(MAX_CHUNK, s):
        raise InvariantViolation("ssd-scan-chunk", f"chunk must be in 1..min({MAX_CHUNK}, S)",
                                 context=dict(chunk=chunk, seq=s))
    if not (rows_aligned(x) and rows_aligned(bmat) and rows_aligned(cmat)):
        raise InvariantViolation(
            "ssd-scan-layout", "x's head dim and B's and C's state dim must be contiguous, "
            "their rows 16-byte aligned",
            context=dict(x=x.stride(), b=bmat.stride(), c=cmat.stride(),
                         offsets=[t.data_ptr() % 16 for t in (x, bmat, cmat)]))


def ssd_scan_cuda(
    x: torch.Tensor,  # [B, S, H, P], P contiguous
    dt: torch.Tensor,  # [B, S, H] f32
    bmat: torch.Tensor,  # [B, S, N] or [B, S, G, N], N contiguous
    cmat: torch.Tensor,  # [B, S, N] or [B, S, G, N], N contiguous
    a: torch.Tensor,  # [H] f32
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels on the current stream with chunks of ``chunk``
    steps (at most 128; the caller takes ``min(chunk, S)``).  Returns
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] f32), outside
    the autograd graph: with grad enabled, an input that requires grad
    raises (the model's :class:`repro_torch.models.ssm.SSDScan` calls this
    with grad disabled and differentiates the plain scan)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, bmat, cmat, a)):
        raise RuntimeError("ssd_scan_cuda's outputs carry no gradient: a scan whose inputs "
                           "require grad goes through repro_torch.models.ssm.ssd")
    if bmat.dim() == 3:  # one group
        bmat, cmat = bmat[:, :, None], cmat[:, :, None]
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    dev = x.device
    _check(x, dt, bmat, cmat, a, chunk)
    a = a.contiguous()
    plan = plan_for(b, s, h, p, n, chunk, x.dtype, dev, g)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    nbytes = plan["scratch_bytes"]
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=dev) if nbytes else None
    lib = _lib or _load()
    xs, dts, bs, cs = x.stride(), dt.stride(), bmat.stride(), cmat.stride()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr() if nbytes else None, nbytes,
        b, s, h, p, n, chunk, _DTYPES[x.dtype], plan["heads_per_block"], g,
        xs[0], xs[1], xs[2], dts[0], dts[1], dts[2], bs[0], bs[1], bs[2], cs[0], cs[1], cs[2],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({err})")
    LAUNCHES.count += 1
    return y, state
