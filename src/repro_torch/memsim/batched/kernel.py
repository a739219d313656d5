"""Per-window equilibrium solvers of the batched lane, dispatched on device.

The fluid engine reduces each control window to two water-filling
questions, both answered by bisection over the common per-core admission
rate lambda:

* :func:`station_lambdas`: per-station fair rates (+inf where the station
  is unconstrained);
* :func:`global_lambda`: one lambda per cell under the shared-ToR
  population bound: each workload holds ``min(O, y*R_tor)`` entries, its
  whole MLP population once a saturated station clamps it; when the
  holdings exceed the ToR, lambda shrinks until they fit (the paper's
  unfair-queuing collapse in fluid form).

:func:`fused_window_solve` runs a window's whole wait relaxation.

The tensors' device picks the route.  A CUDA tensor launches the Hopper
kernels of :mod:`repro_torch.kernels.fluid_solver` (K2 for
:func:`global_lambda`, K3 for :func:`fused_window_solve`, f32 with 1e30
standing in for +inf) and raises if they cannot build or launch; a CPU
tensor takes the float64 plain versions of :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import fluid_solver
from repro_torch.kernels.ref import (
    fused_window_solve_ref,
    global_lambda_ref,
    station_lambdas_ref,
)


def _route(t: torch.Tensor, what: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{what} has no path for device {t.device}")


def station_lambdas(A, cap, route_svc, slots) -> torch.Tensor:
    """Per-(cell, station) fair per-core rate ``(C, S)``, +inf where the
    station serves every user at its cap.  On the card the station
    bisection runs only inside :func:`fused_window_solve` (K3)."""
    if _route(A, "station_lambdas") == "cuda":
        raise NotImplementedError(
            "station_lambdas has no standalone kernel: on the card the "
            "station bisection runs inside fused_window_solve (K3)"
        )
    return station_lambdas_ref(A, cap, route_svc, slots)


def global_lambda(A, cap, y_sta, o_eff, R_tor, tor_cap, irq_cap) -> torch.Tensor:
    """Max common per-core rate per cell under the ToR population bound,
    ``(C,)``, +inf where the ToR never fills.  ``cap`` is the issue-side
    cap, ``y_sta`` the fair station share, ``o_eff`` the MLP population,
    ``R_tor`` the per-insert ToR residency, ``irq_cap`` the staging queue."""
    if _route(A, "global_lambda") == "cuda":
        return fluid_solver.global_lambda_cuda(A, cap, y_sta, o_eff, R_tor,
                                               tor_cap, irq_cap)
    return global_lambda_ref(A, cap, y_sta, o_eff, R_tor, tor_cap, irq_cap)


def fused_window_solve(
    A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor_cap, irq_cap, Wq,
    n_outer: int, damp: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One window's full wait relaxation: ``(y (C, W), Wq (C, S), lam
    (C,))``, float64 on the inputs' device.  ``lam`` is the last
    iteration's global lambda, +inf where the ToR never fills, so
    ``torch.isfinite(lam)`` is the coupling test."""
    args = (A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor_cap,
            irq_cap, Wq, n_outer, damp)
    if _route(A, "fused_window_solve") == "cuda":
        return fluid_solver.fused_window_solve_cuda(*args)
    return fused_window_solve_ref(*args)
