"""Plain PyTorch versions of the port's kernels.

``decode_attention_ref`` follows ``repro/kernels/ref.py``'s oracle: full
materialization of the scores, f32 scores and softmax, the same ``NEG_INF``
mask, window and softcap.  The CPU path of :mod:`repro_torch.kernels.ops`
runs it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

``station_lambdas_ref``, ``global_lambda_ref`` and ``fused_window_solve_ref``
are the batched lane's solver in float64 on any device: the reference's
numpy ``station_lambdas`` and ``_global_lambda_numpy``
(``repro/memsim/batched/kernel.py``) and its numpy relaxation loop
(``repro/memsim/batched/fluid.py:222-297``), operation for operation.  The
CPU path of :mod:`repro_torch.memsim.batched.kernel` runs them, and
``chip_smoke.py`` holds the f32 kernels against them on the card.

``ssd_scan_ref`` is the reference's token-by-token SSD recurrence
(``repro/kernels/ref.py:46``) in float32, and ``ssd_scan_chunked_ref`` the
plain version of exactly what the scan kernel computes: the chunked
algorithm of ``repro/kernels/ssd_scan.py::_ssd_kernel``, float32 inside,
one group, the kernel layout (x [B, H, S, P], dt [B, H, S], bc [B, S, 2, N],
a [H]).  Both return y in x's dtype and the final state [B, H, P, N] f32.
The CPU path of :func:`repro_torch.kernels.ops.ssd_scan` runs the chunked
one; the model's CPU path runs ``models/ssm.py::ssd_chunked`` instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


_BISECT_ITERS = 48
_EPS = 1e-9


def station_lambdas_ref(A, cap, route_svc, slots) -> torch.Tensor:
    """Per-(cell, station) fair per-core rate, ``(C, S)``; +inf where the
    station serves every user at its cap.  ``A``/``cap`` ``(C, W)``,
    ``route_svc`` ``(C, W, S)``, ``slots`` ``(C, S)`` (0 = padding)."""
    C = A.shape[0]
    S = slots.shape[1]
    hi0 = (cap / A.clamp(min=1e-12)).amax(dim=1) + 1e-6
    hi = hi0[:, None].expand(C, S).clone()
    lo = torch.zeros_like(hi)

    def demand(lam):
        y = torch.minimum(lam[:, None, :] * A[:, :, None], cap[:, :, None])
        return (y * route_svc).sum(dim=1)

    feasible_at_cap = demand(hi) <= slots + _EPS
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = demand(mid) <= slots + _EPS
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return torch.where(feasible_at_cap, float("inf"), lo)


def _population(lam, A, cap, y_sta, o_eff, R_tor, irq_cap):
    """Per-workload ToR holdings at per-core rate ``lam``; a queue-forming
    workload holds its MLP population minus its share of the IRQ."""
    y_free = torch.minimum(lam[:, None] * A, cap)
    y = torch.minimum(y_free, y_sta)
    clamped = y_sta < y_free * (1.0 - 1e-9)
    unclamped_pop = torch.minimum(o_eff, y * R_tor)
    share = y / y.sum(dim=1, keepdim=True).clamp(min=1e-12)
    qb_pop = torch.maximum(o_eff - irq_cap[:, None] * share, unclamped_pop)
    return y, torch.where(clamped, qb_pop, unclamped_pop)


def global_lambda_ref(A, cap, y_sta, o_eff, R_tor, tor_cap, irq_cap) -> torch.Tensor:
    """Max common per-core rate per cell under the ToR population bound,
    ``(C,)``; +inf where the ToR never fills."""
    hi0 = (cap / A.clamp(min=1e-12)).amax(dim=1) + 1e-6
    lo = torch.zeros_like(hi0)
    hi = hi0.clone()

    def feasible(lam):
        _, pop = _population(lam, A, cap, y_sta, o_eff, R_tor, irq_cap)
        return pop.sum(dim=1) <= tor_cap + _EPS

    feasible_at_cap = feasible(hi0)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return torch.where(feasible_at_cap, float("inf"), lo)


def _contract(x, m):
    """``einsum("cw,cws->cs", x, m)`` as products then a sum, as numpy's
    einsum forms it (no fused multiply-add)."""
    return (x[:, :, None] * m).sum(dim=1)


def fused_window_solve_ref(
    A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor_cap, irq_cap, Wq,
    n_outer: int, damp: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One window's wait relaxation: ``n_outer`` damped iterations of
    station scaling, the global-lambda bisection, the population accounting
    of queue-forming workloads and the Little's-law wait update.  Returns
    ``(y (C, W), Wq (C, S), lam (C,))``; ``lam`` is the last iteration's,
    +inf where the ToR never fills."""
    C, W = A.shape
    y = torch.zeros_like(A)
    lam = torch.full((C,), float("inf"), dtype=A.dtype, device=A.device)
    used = route_svc > 1e-12
    for _ in range(n_outer):
        r_sta = Wq[:, None, :] + svc_pipe
        R_tor = (route * r_sta).sum(dim=2)
        R_base = (route * svc_pipe).sum(dim=2)
        # Issue-side caps: token rate and the MLP population (waits
        # included: a backlogged tier slows its own issuers).
        cap = torch.minimum(y_rate, o_eff / R_tor.clamp(min=1e-9))
        cap = torch.where(A > 0, cap, 0.0)
        lam_s = station_lambdas_ref(A, cap, route_svc, slots)
        lam_min = torch.where(used, lam_s[:, None, :], float("inf")).amin(dim=2)
        # Padded workloads have no used station: clamp +inf before the
        # product so it is 0, not NaN.
        y_sta = torch.where(torch.isfinite(lam_min), lam_min, 1e30) * A.clamp(min=0.0)
        lam = global_lambda_ref(A, cap, y_sta, o_eff, R_tor, tor_cap, irq_cap)
        lam_b = torch.where(torch.isfinite(lam), lam, 1e30)[:, None]
        y_free = torch.minimum(lam_b * A, cap)
        y = torch.minimum(y_free, y_sta)
        # Queue-forming workloads: held at their station share while their admission
        # allowance and issue caps still have headroom.
        qb = (y_sta <= lam_b * A * (1.0 + 1e-9)) & (y_sta < cap * (1.0 - 1e-9))
        unc_pop = torch.minimum(o_eff, y * R_tor)
        share = y / y.sum(dim=1, keepdim=True).clamp(min=1e-12)
        pop_w = torch.where(
            qb, torch.maximum(o_eff - irq_cap[:, None] * share, unc_pop), unc_pop)

        # Wait relaxation: the queued population sits at the saturated
        # stations of the station-clamped workloads (Little's law).
        d_s = _contract(y, route_svc)
        inflow_s = _contract(y, route)
        util = d_s / slots.clamp(min=1e-9)
        sat = (util >= 0.98) & (slots > 0)
        n_pop = torch.minimum(pop_w.sum(dim=1), tor_cap)
        base_pop = (y * R_base).sum(dim=1)
        q_total = (n_pop - base_pop).clamp(min=0.0)
        q_max = torch.where(qb, (pop_w - y * R_base).clamp(min=0.0), 0.0)
        q_sum = q_max.sum(dim=1)
        scale = torch.where(
            q_sum > 1e-12, (q_total / q_sum.clamp(min=1e-12)).clamp(max=1.0), 0.0)
        q_w = q_max * scale[:, None]
        w_st = torch.where(sat[:, None, :], route_svc, 0.0)
        w_norm = w_st.sum(dim=2, keepdim=True)
        w_st = torch.where(w_norm > 1e-12, w_st / w_norm.clamp(min=1e-12), 0.0)
        q_s = _contract(q_w, w_st)
        mean_svc = d_s / inflow_s.clamp(min=1e-12)
        w_new = q_s * mean_svc / slots.clamp(min=1e-9)
        w_new = torch.where(sat, w_new, 0.0)
        Wq = damp * Wq + (1.0 - damp) * w_new
    return y, Wq, lam


def ssd_scan_ref(
    x: torch.Tensor,  # [B, H, S, P]
    dt: torch.Tensor,  # [B, H, S] f32
    bc: torch.Tensor,  # [B, S, 2, N]
    a: torch.Tensor,  # [H] f32 (negative)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token SSD recurrence (the ground-truth semantics):

        h_t = exp(a * dt_t) h_{t-1} + dt_t * x_t B_t^T
        y_t = h_t . C_t
    """
    b, h, s, p = x.shape
    n = bc.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bmat, cmat = bc[:, :, 0].float(), bc[:, :, 1].float()  # [B, S, N]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dtf[:, :, t]  # [B, H]
        decay = torch.exp(dtt * af[None, :])
        upd = torch.einsum("bhp,bn->bhpn", dtt[..., None] * xf[:, :, t], bmat[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cmat[:, t]))
    return torch.stack(ys, dim=2).to(x.dtype), state


def ssd_scan_chunked_ref(
    x: torch.Tensor,  # [B, H, S, P]
    dt: torch.Tensor,  # [B, H, S] f32
    bc: torch.Tensor,  # [B, S, 2, N]
    a: torch.Tensor,  # [H] f32 (negative)
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan kernel's arithmetic in plain torch, float32 inside: per
    chunk of ``min(chunk, S)`` steps, ``(C B^T * causal exp-segsum) @ (dt x)``
    plus ``exp(cum) * C h^T`` from the carried state, then
    ``h <- exp(sum dt a) h + sum_q tail_q dt_q x_q B_q^T``.  S is padded to a
    chunk multiple with dt = 0 (exact no-op steps)."""
    b, h, s, p = x.shape
    n = bc.shape[-1]
    chunk = min(chunk, s)
    pad = -s % chunk
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, pad))
    bcf = torch.nn.functional.pad(bc.float(), (0, 0, 0, 0, 0, pad))
    af = a.float()[None, :, None]  # [1, H, 1]
    q = chunk
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, q):
        xq = xf[:, :, c0:c0 + q]  # [B, H, Q, P]
        dtq = dtf[:, :, c0:c0 + q]  # [B, H, Q]
        bq, cq = bcf[:, c0:c0 + q, 0], bcf[:, c0:c0 + q, 1]  # [B, Q, N]
        da = dtq * af
        cum = torch.cumsum(da, dim=-1)  # [B, H, Q]
        rel = cum[..., :, None] - cum[..., None, :]  # [B, H, Q, Q]
        decay = torch.where(mask, torch.exp(rel), 0.0)
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)[:, None]  # [B, 1, Q, Q]
        dx = dtq[..., None] * xq  # [B, H, Q, P]
        y = torch.einsum("bhqk,bhkp->bhqp", scores * decay, dx)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bqn,bhpn->bhqp", cq, state)
        tail = torch.exp(cum[..., -1:] - cum)  # [B, H, Q]
        s_chunk = torch.einsum("bhqp,bqn->bhpn", (tail * dtq)[..., None] * xq, bq)
        state = torch.exp(da.sum(dim=-1))[..., None, None] * state + s_chunk
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :s]
    return y.to(x.dtype), state
