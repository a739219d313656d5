"""Build, bind and launch the batched lane's window solver
(``csrc/fluid_solver.cu``): K2, the global-lambda bisection, and K3, one
window's fused wait relaxation.

Both take float64 or float32 CUDA tensors in the reference's layout,
clamp them to 1e30 (the f32 stand-in for +inf) and cast them to f32 on the
card, as ``repro.memsim.batched.kernel`` does before its Pallas calls, and
return float64 tensors on the same device.  :data:`WINDOW_SOLVE_LAUNCHES`
counts K3's launches and :data:`GLOBAL_LAMBDA_LAUNCHES` the standalone K2
kernel's.  On the sweep path K2 launches no time of its own: its bisection
is a device function that every K3 relaxation step calls, as in the
reference's fused solver.  The plain versions are
:func:`repro_torch.kernels.ref.global_lambda_ref` and
:func:`~repro_torch.kernels.ref.fused_window_solve_ref`.

Both kernels run one warp per cell, four cells a block.  Their 48-step
bisections run speculatively across the warp's lanes in rounds of several
levels (the global lambda's, and the S station bisections' at once; the
CUDA source owns the scheme and :func:`round_scheme` reads it back) and give
the sequential result bit for bit;
:func:`~repro_torch.kernels.ref.speculative_bisect_ref` is that scheme in
plain torch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.invariants import require
from repro_torch.kernels import _nvcc
from repro_torch.kernels._nvcc import LaunchCounter

#: Contracted multiply-adds would round differently from the reference's
#: f32 solver and move bisection decisions.
SOURCE = _nvcc.CudaSource("fluid_solver", ("-fmad=false",))
#: The kernels keep a cell's rows in registers and shared memory of these sizes.
MAX_W = 8
MAX_S = 8
BIG = 1e30
GLOBAL_LAMBDA_LAUNCHES = LaunchCounter()
WINDOW_SOLVE_LAUNCHES = LaunchCounter()

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
        lib.fluid_global_lambda_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.fluid_global_lambda_launch.restype = ctypes.c_int
        lib.fluid_window_solve_launch.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_void_p])
        lib.fluid_window_solve_launch.restype = ctypes.c_int
        for name in ("fluid_warps_per_cell", "fluid_bisect_iters", "fluid_glam_levels"):
            getattr(lib, name).argtypes = []
        lib.fluid_station_levels.argtypes = [ctypes.c_int]
        lib.fluid_window_instance.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        lib.fluid_window_instance.restype = None
        lib.fluid_error_string.argtypes = [ctypes.c_int]
        lib.fluid_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def round_scheme(S: int) -> Dict[str, object]:
    """The bisection scheme the kernels run at ``S`` stations, as the CUDA
    source defines it (built at first use): warps per cell, steps of the
    sequential bisection, levels per round and dependent rounds per
    bisection, for the global lambda and for the station bisections."""
    lib = _load()
    steps = lib.fluid_bisect_iters()
    levels = dict(station=lib.fluid_station_levels(S), global_lambda=lib.fluid_glam_levels())
    return dict(warps_per_cell=lib.fluid_warps_per_cell(), sequential_steps=steps,
                levels_per_round=levels,
                rounds_per_bisection={k: -(-steps // v) for k, v in levels.items()})


def window_solve_instance(W: int, S: int) -> Tuple[int, int]:
    """The ``fused_window_solve_kernel<W_MAX, S_MAX>`` instance that K3
    launches for ``W`` workloads and ``S`` stations, as the CUDA source
    dispatches it (built at first use)."""
    w_max, s_max = ctypes.c_int(), ctypes.c_int()
    _load().fluid_window_instance(W, S, ctypes.byref(w_max), ctypes.byref(s_max))
    return w_max.value, s_max.value


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(max=BIG).to(torch.float32).contiguous()


def _check(tensors: dict, C: int, W: int, S: Optional[int] = None) -> torch.device:
    dev = next(iter(tensors.values())).device
    require(all(t.is_cuda and t.device == dev for t in tensors.values()),
            "fluid-solver-device", "every input must be on one CUDA device",
            devices=sorted({str(t.device) for t in tensors.values()}))
    require(all(t.dtype in (torch.float32, torch.float64) for t in tensors.values()),
            "fluid-solver-dtype", "inputs must be float32 or float64",
            dtypes=sorted({str(t.dtype) for t in tensors.values()}))
    require(0 < W <= MAX_W and (S is None or 0 < S <= MAX_S), "fluid-solver-shape",
            f"the kernels take 1..{MAX_W} workloads and 1..{MAX_S} stations",
            workloads=W, stations=S)
    for name, t in tensors.items():
        want = {"cw": (C, W), "cws": (C, W, S), "cs": (C, S), "c": (C,)}[name.split(":")[0]]
        require(tuple(t.shape) == want, "fluid-solver-shape", f"{name} must be {want}",
                got=tuple(t.shape))
    return dev


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _load().fluid_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def global_lambda_cuda(A, cap, y_sta, o_eff, R_tor, tor_cap, irq_cap) -> torch.Tensor:
    """K2: the max common per-core rate per cell under the ToR population
    bound; ``(C,)`` float64, +inf where the ToR never fills.  ``hi0`` is
    computed in the inputs' precision before the cast, as the reference
    computes it in numpy."""
    C, W = A.shape
    _check({"cw:A": A, "cw:cap": cap, "cw:y_sta": y_sta, "cw:o_eff": o_eff,
            "cw:R_tor": R_tor, "c:tor_cap": tor_cap, "c:irq_cap": irq_cap}, C, W)
    hi0 = (cap.clamp(max=BIG) / A.clamp(min=1e-12)).amax(dim=1) + 1e-6
    args = [_f32(t) for t in (A, cap, y_sta, o_eff, R_tor, tor_cap, irq_cap, hi0)]
    out = torch.empty(C, dtype=torch.float32, device=A.device)
    lib = _load()
    err = lib.fluid_global_lambda_launch(
        *(t.data_ptr() for t in args), out.data_ptr(), C, W,
        torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(err, "global_lambda")
    GLOBAL_LAMBDA_LAUNCHES.count += 1
    return out.to(torch.float64)


def fused_window_solve_cuda(
    A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor_cap, irq_cap, Wq,
    n_outer: int, damp: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: one window's whole wait relaxation, one launch for every cell.
    Returns float64 ``(y (C, W), Wq (C, S), lam (C,))``; ``lam`` is the last
    iteration's global lambda, +inf where the ToR never fills."""
    C, W, S = route.shape
    _check({"cw:A": A, "cw:y_rate": y_rate, "cw:o_eff": o_eff, "cws:route": route,
            "cws:route_svc": route_svc, "cws:svc_pipe": svc_pipe, "cs:slots": slots,
            "c:tor_cap": tor_cap, "c:irq_cap": irq_cap, "cs:Wq": Wq}, C, W, S)
    require(n_outer >= 0, "fluid-solver-iterations", "n_outer must be >= 0",
            n_outer=n_outer)
    args = [_f32(t) for t in (A, y_rate, o_eff, route, route_svc, svc_pipe, slots,
                              tor_cap, irq_cap, Wq)]
    f32 = dict(dtype=torch.float32, device=A.device)
    y = torch.empty(C, W, **f32)
    wq = torch.empty(C, S, **f32)
    lam = torch.empty(C, **f32)
    lib = _load()
    err = lib.fluid_window_solve_launch(
        *(t.data_ptr() for t in args), y.data_ptr(), wq.data_ptr(), lam.data_ptr(),
        C, W, S, int(n_outer), float(damp),
        torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(err, "fused_window_solve")
    WINDOW_SOLVE_LAUNCHES.count += 1
    return y.to(torch.float64), wq.to(torch.float64), lam.to(torch.float64)
