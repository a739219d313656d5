"""Plain PyTorch versions of the port's kernels.

``decode_attention_ref`` follows ``repro/kernels/ref.py``'s oracle: full
materialization of the scores, f32 scores and softmax, the same ``NEG_INF``
mask, window and softcap.  The CPU path of :mod:`repro_torch.kernels.ops`
runs it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

``decode_attention_split_ref`` is the plain version of what the CUDA kernel
computes on its split road: per split of each row's walked range, f32
``(m, l, acc)`` partials, then the combine's rescaling (empty splits
skipped).  The tests hold it to ``decode_attention_ref``; nothing else
runs it.

``station_lambdas_ref``, ``global_lambda_ref`` and ``fused_window_solve_ref``
are the batched lane's solver in float64 on any device: the reference's
numpy ``station_lambdas`` and ``_global_lambda_numpy``
(``repro/memsim/batched/kernel.py``) and its numpy relaxation loop
(``repro/memsim/batched/fluid.py:222-297``), operation for operation.  The
CPU path of :mod:`repro_torch.memsim.batched.kernel` runs them, and
``chip_smoke.py`` holds the f32 kernels against them on the card.

``speculative_bisect_ref`` is the round scheme of the solver kernel's
bisections in f32: each round evaluates the predicate at every midpoint of
the next ``levels`` levels of the bisection tree, then follows the path.
The tests hold it bit for bit to the sequential bisection.

``ssd_scan_ref`` is the reference's token-by-token SSD recurrence
(``repro/kernels/ref.py:46``) in float32, and ``ssd_scan_chunked_ref`` the
plain version of exactly what the scan kernel computes: the chunked
algorithm of ``repro/kernels/ssd_scan.py::_ssd_kernel``, float32 inside,
one group, the kernel layout (x [B, H, S, P], dt [B, H, S], bc [B, S, 2, N],
a [H]).  Both return y in x's dtype and the final state [B, H, P, N] f32.
The CPU path of :func:`repro_torch.kernels.ops.ssd_scan` runs the chunked
one; the model's CPU path runs ``models/ssm.py::ssd_chunked`` instead.
``ssd_scan_staged_ref`` is the plain version of the scan kernels' three
stages (chunk states, the state pass, chunk outputs) in the same layout,
f32 throughout or, with ``operand_dtype``, rounding where the kernels'
tensor-core operands round; ``chip_smoke.py`` holds the kernels to it on
the card.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

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


def split_bounds(length: int, s: int, n_split: int, window: int = 1 << 30,
                 tile: int = 64) -> List[Tuple[int, int]]:
    """The decode-attention kernel's ``[begin, end)`` of each of the
    ``n_split`` blocks of one row: the walked range (the valid positions
    ``[max(0, length - window), min(length, s))``, or all of ``[0, s)`` when
    none is valid) cut into ``n_split`` equal parts rounded up to whole
    tiles; trailing parts may be empty."""
    lo, hi = max(0, length - window), min(length, s)
    begin, end = (lo, hi) if lo < hi else (0, s)
    chunk = -(-(end - begin) // n_split)
    chunk = -(-chunk // tile) * tile
    bounds = []
    for z in range(n_split):
        b0 = min(end, begin + z * chunk)
        bounds.append((b0, min(end, b0 + chunk)))
    return bounds


def decode_attention_split_ref(
    q: torch.Tensor,  # [B, Hkv, G, Dh]
    k: torch.Tensor,  # [B, Hkv, S, Dh]
    v: torch.Tensor,  # [B, Hkv, S, Dh]
    lengths: torch.Tensor,  # [B] int32 valid token counts
    n_split: int,
    *,
    window: int = 1 << 30,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    p_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Split-KV flash-decode as the kernel computes it: each block's f32
    ``(m, l, acc)`` over its part of the walked range (masked scores inside
    it are ``NEG_INF``; an empty part is ``m = -inf, l = 0``), then
    ``out = sum_z e^(m_z - M) acc_z / max(sum_z e^(m_z - M) l_z, 1e-20)``
    over the non-empty parts.  ``p_dtype`` rounds the probabilities to that
    type as the operand of the value product (the kernel's bf16 road); ``l``
    sums them unrounded."""
    b, hkv, g, dh = q.shape
    s = k.shape[2]
    if scale is None:
        scale = dh**-0.5
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float() * scale, k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    length = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    valid = (pos < length) & (length - 1 - pos < window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    part_of = torch.full((b, s), -1, dtype=torch.int64, device=q.device)
    for row, n in enumerate(lengths.tolist()):
        for z, (b0, b1) in enumerate(split_bounds(int(n), s, n_split, window)):
            part_of[row, b0:b1] = z
    vf = v.float()
    ms, ls, accs = [], [], []
    for z in range(n_split):
        inside = (part_of == z)[:, None, None, :]
        m = torch.where(inside, scores, float("-inf")).amax(dim=-1, keepdim=True)
        p = torch.where(inside, torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0)),
                        0.0)
        ls.append(p.sum(dim=-1))
        ms.append(m[..., 0])
        pv = p if p_dtype is None else p.to(p_dtype).float()
        accs.append(torch.einsum("bhgs,bhsd->bhgd", pv, vf))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)  # split first
    kept = l > 0
    m_all = torch.where(kept, m, float("-inf")).amax(dim=0)
    wt = torch.where(kept, torch.exp(m - m_all), 0.0)
    l_all = (wt * l).sum(dim=0)
    out = (wt[..., None] * acc).sum(dim=0) / l_all.clamp(min=1e-20)[..., None]
    return out.to(q.dtype)


_BISECT_ITERS = 48
_EPS = 1e-9


def speculative_bisect_ref(
    pred: Callable[[torch.Tensor], torch.Tensor],
    lo: torch.Tensor,
    hi: torch.Tensor,
    iters: int,
    levels: int,
) -> torch.Tensor:
    """``iters`` bisection steps (``mid = 0.5 * (lo + hi)``; ``lo = mid``
    where ``pred(mid)``, else ``hi = mid``) in rounds of ``levels`` steps, as
    the solver kernel's lanes run them: a round evaluates ``pred`` at the
    ``2**levels - 1`` midpoints of the next ``levels`` levels of the tree,
    each derived from the round's ``(lo, hi)`` along its own path by the same
    f32 operations; the last-level node whose ancestors' values all agree
    with its path gives its bracket, and its own step ends the round.
    Returns ``lo``; it equals the sequential bisection's bit for bit."""
    done = 0
    while done < iters:
        lv = min(levels, iters - done)
        brackets, oks = [], []
        for node in range((1 << lv) - 1):
            path = node + 1  # a leading 1, then the path: 1 = predicate true
            n_lo, n_hi = lo, hi
            for i in range(path.bit_length() - 2, -1, -1):
                mid = 0.5 * (n_lo + n_hi)
                if (path >> i) & 1:
                    n_lo = mid
                else:
                    n_hi = mid
            brackets.append((n_lo, n_hi))
            oks.append(pred(0.5 * (n_lo + n_hi)))
        new_lo, new_hi = lo, hi
        for node in range((1 << (lv - 1)) - 1, (1 << lv) - 1):
            path, a = node + 1, 0
            on = torch.ones_like(oks[0])
            for i in range(path.bit_length() - 2, -1, -1):
                up = (path >> i) & 1
                on = on & (oks[a] if up else ~oks[a])
                a = 2 * a + 1 + up
            n_lo, n_hi = brackets[node]
            mid = 0.5 * (n_lo + n_hi)
            new_lo = torch.where(on, torch.where(oks[node], mid, n_lo), new_lo)
            new_hi = torch.where(on, torch.where(oks[node], n_hi, mid), new_hi)
        lo, hi = new_lo, new_hi
        done += lv
    return lo


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


def ssd_scan_staged_ref(
    x: torch.Tensor,  # [B, H, S, P]
    dt: torch.Tensor,  # [B, H, S] f32
    bc: torch.Tensor,  # [B, S, 2, N]
    a: torch.Tensor,  # [H] f32 (negative)
    *,
    chunk: int,
    operand_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan as the kernels stage it, chunks of ``min(chunk, S)`` steps
    (S padded to a chunk multiple with dt = 0):

    * A: per chunk, ``s_c = sum_k x_k (tail_k dt_k) B_k^T`` with
      ``tail_k = exp(cum_last - cum_k)``, and ``decay_c = exp(cum_last)``;
    * B: ``h_in[c] = h; h = decay_c h + s_c`` in chunk order (the last ``h``
      is the final state);
    * C: ``y = exp(cum_q) (C h_in[c]^T) + W' @ x`` with
      ``W'[q, k] = C B^T [k <= q] exp(cum_q - cum_k) dt_k``.

    f32 throughout when ``operand_dtype`` is None.  Otherwise the three
    products' rounded operands are rounded once to it, as the kernels'
    tensor-core road does: ``x_k tail_k dt_k`` (Stage A), ``h_in`` and
    ``W'`` (Stage C); x, B and C enter as given.  Returns y in x's dtype
    and the final state [B, H, P, N] f32."""
    b, h, s, p = x.shape
    n = bc.shape[-1]
    q = min(chunk, s)
    pad = -s % q
    nc = (s + pad) // q

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t if operand_dtype is None else t.to(operand_dtype).float()

    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad)).reshape(b, h, nc, q, p)
    dtf = torch.nn.functional.pad(dt.float(), (0, pad)).reshape(b, h, nc, q)
    bcf = torch.nn.functional.pad(bc.float(), (0, 0, 0, 0, 0, pad))
    bq = bcf[:, :, 0].reshape(b, nc, q, n)
    cq = bcf[:, :, 1].reshape(b, nc, q, n)
    cum = torch.cumsum(dtf * a.float()[None, :, None, None], dim=-1)  # [B, H, nc, Q]
    last = cum[..., -1:]
    # Stage A.
    xs = rnd(xf * (torch.exp(last - cum) * dtf)[..., None])
    s_c = torch.einsum("bhcqp,bcqn->bhcpn", xs, bq)
    decay = torch.exp(last[..., 0])  # [B, H, nc]
    # Stage B.
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = decay[:, :, c, None, None] * state + s_c[:, :, c]
    hin = rnd(torch.stack(h_in, dim=2))  # [B, H, nc, P, N]
    # Stage C.
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(mask, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    cb = torch.einsum("bcqn,bckn->bcqk", cq, bq)[:, None]  # [B, 1, nc, Q, Q]
    w = rnd(cb * seg * dtf[..., None, :])
    inter = torch.einsum("bcqn,bhcpn->bhcqp", cq, hin)
    y = torch.exp(cum)[..., None] * inter + torch.einsum("bhcqk,bhckp->bhcqp", w, xf)
    y = y.reshape(b, h, nc * q, p)[:, :, :s]
    return y.to(x.dtype), state
