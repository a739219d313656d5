"""The window-lockstep fluid engine: one step advances every cell of a group.

A port of ``repro.memsim.batched.fluid``.  Each control window is a
closed-network equilibrium of the structures the DES simulates event by
event (§4.2): cores with bounded MLP issuing round-robin, the FIFO IRQ/ToR
admission path, per-tier device stations, the LLC station and the shared
ToR population bound.  Per cell and window the ToR either has room (each
workload runs at its own issue cap, clamped to the fair share of any
saturated station it uses) or it is coupled (one per-core rate governs
every workload, and a saturated slow station collapses the fast tier's
inserts: the paper's unfair queuing in fluid form).  The per-tier window
counters feed the vector MIKU ladder, whose caps and rates throttle the
next window.

Everything runs on one device: the group's float64 host arrays are copied
there once, the relaxation goes through
:func:`~repro_torch.memsim.batched.kernel.fused_window_solve` (one K3
launch per window on the card, the float64 plain loop on the CPU), and the
ladder keeps its state there.  The host reads the device once per fired
window (the ladder's outputs, to build the :class:`Decision` records) and
once at the end (the accumulators); :data:`COUNTS` counts both.

Cells that ask for ``latency_hist`` get the reference's analytic
histograms: each window contributes one weighted entry per workload (the
window's mean latency from the station waits the solver returned, at the
window's completion count) and per tier.  Those means and counts are
computed on the device with the rest of the window and copied to the host
with the final accumulators; the host only buckets them.

Merged-law cells run their one ladder as unit 0: it is fed the fold of
every slow tier's window deltas, and its cap, rate and :class:`Decision`
are broadcast to each slow tier.  Cells that ask for ``record_windows`` get
one record per fired window in the schema of
:func:`~repro_torch.core.substrate.window_record_jsonable` (per-tier
counter deltas, per-tier decisions and, with ``latency_hist``, the window's
histogram entries and the tiering block); their per-window counters are
gathered on the device for those cells only and copied with the final
accumulators.

Cells with a tiering spec run the tiering pass after each fired window
(:class:`~repro_torch.memsim.batched.tiering.VectorTiering`, host numpy):
completed MIGRATE requests retire page copies, demand completions feed the
hotness, the policy queues new copies under the ladder's migration budgets
(or, for a merged cell, its broadcast restricted bit), and the routing and
migration issue gating it writes apply to the next window.  The window's
completions of those cells come to the host in the same transfer as the
ladder's outputs and budgets (a transfer of their own in a group without a
ladder), and the live routing and issue tables go back to the device only
in windows where the pass changed them.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.controller import (
    Decision,
    Phase,
    TierDecisions,
    VectorMikuLadder,
)
from repro_torch.core.des import SimResult, WorkloadStats
from repro_torch.core.littles_law import OpClass, TierCounters, TierEstimate
from repro_torch.core.substrate import _decision_jsonable
from repro_torch.device import resolve_device
from repro_torch.memsim.batched import kernel
from repro_torch.memsim.batched.stacking import BatchGroup
from repro_torch.memsim.batched.tiering import VectorTiering, build_tiering
from repro_torch.obs.histogram import LatencyHistogram

_OPS = tuple(OpClass)
_N_OUTER = 30  # wait-relaxation iterations per window
_DAMP = 0.5
#: Ladder output fields copied to the host at every fired window.
_LADDER_FIELDS = ("cap", "rate", "restricted", "t_avg", "alpha", "t_slow",
                  "t_slow_raw", "threshold", "backlogged", "valid")


class Counts:
    """What :func:`run_fluid` did since the last :meth:`reset`: windows
    advanced, device-to-host copies, host-to-device uploads inside the
    window loop, and the tiering passes run with their host seconds."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.windows = 0
        self.host_copies = 0
        self.uploads = 0
        self.tiering_steps = 0
        self.tiering_s = 0.0


COUNTS = Counts()


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy tensors to the host as float64 numpy arrays in one transfer."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    COUNTS.host_copies += 1
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _to_device(dev: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    """Copy host arrays to ``dev`` as float64 tensors in one transfer."""
    flat = np.concatenate([np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays])
    COUNTS.uploads += 1
    dev_flat = torch.from_numpy(flat).to(dev)
    out, at = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a)))
        out.append(dev_flat[at:at + n].reshape(np.shape(a)))
        at += n
    return out


def build_ladder(group: BatchGroup,
                 device: Optional[torch.device] = None) -> Optional[VectorMikuLadder]:
    """The group's stacked vector ladder on ``device`` (None when no cell
    has MIKU).  Raises ``ValueError`` for cells whose units mix rung
    tables."""
    grid = [p.units if p.units else [] for p in group.plans]
    if not any(grid):
        return None
    return VectorMikuLadder.from_units(grid, resolve_device(device))


def run_fluid(
    group: BatchGroup,
    ladder: Optional[VectorMikuLadder] = None,
    device=None,
    tiering: Optional[VectorTiering] = None,
) -> List[SimResult]:
    """Run one stacked cell group to its horizons on ``device`` (the card
    unless ``"cpu"``); SimResults in group order.  ``ladder`` and
    ``tiering`` are the group's pre-built :func:`build_ladder` and
    :func:`~repro_torch.memsim.batched.tiering.build_tiering` results (built
    here when omitted)."""
    dev = resolve_device(device)
    C, W, S, T = (len(group.plans), group.n_wl, group.n_st, group.n_tiers)
    llc = group.llc
    win = group.window_ns
    n_ops = len(_OPS)
    has_ctl = np.array([bool(p.units) for p in group.plans])
    merged = np.array([p.merged for p in group.plans])
    hist_mask = np.array([p.job.latency_hist for p in group.plans])
    hist_on = bool(hist_mask.any())
    n_slow_cell = group.n_tiers_cell - 1
    U = max(1, T - 1)
    if ladder is None:
        ladder = build_ladder(group, dev)
    vt = tiering if tiering is not None else build_tiering(group)
    tier_cells = vt.cell_act if vt is not None else np.zeros(C, bool)
    # Cells whose fired windows leave a record (a cell without a
    # controller, histograms or tiering records nothing, as the scalar
    # ControlLoop).
    rec_cells = np.flatnonzero(np.array([p.job.record_windows for p in group.plans])
                               & (has_ctl | hist_mask | tier_cells))
    inf = float("inf")
    f64 = dict(dtype=torch.float64, device=dev)

    def put(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dev)

    # Station-shaped constants: device service per (c, w, s) with the LLC
    # column; pipeline per station (the LLC has none).
    pipe_st = np.zeros((C, W, S))
    pipe_st[:, :, :T] = group.pipe[:, None, :T]
    svc = put(group.svc)
    svc_pipe = put(group.svc + pipe_st)  # per-insert residency sans queueing
    op_onehot = put(np.stack([group.op == o for o in range(n_ops)], axis=-1))
    has_phases = any(seq is not None for row in group.phases for seq in row)
    p = group.p_llc
    p_llc = put(np.where(p == 2.0, 1.0, np.where((p >= 0.0) & (p <= 1.0), p, 0.0)))
    managed = torch.as_tensor(group.managed).to(dev)
    active_w = torch.as_tensor(group.active_w).to(dev)
    cores = put(group.cores)
    bytes_t = put(group.bytes_t)
    slots = put(group.slots)
    tor_cap = put(group.tor_cap)
    irq_cap = put(group.irq_cap)
    # Live issue tables: routing vectors and effective MLP, which the
    # tiering pass rewrites on the host (placement re-resolution, migration
    # issue gating); without tiering they never change.
    tier_frac_live = group.tier_frac.copy()
    effmlp_live = group.effmlp.copy()
    tier_frac, effmlp = put(group.tier_frac), put(group.effmlp)
    if vt is not None:
        tier_idx = torch.as_tensor(np.flatnonzero(tier_cells)).to(dev)
        ins_host = np.zeros((C, W))
        live = (tier_frac_live, effmlp_live)
        sent = (tier_frac_live.copy(), effmlp_live.copy())  # what the device holds

    # The window clock lives on the host (it decides which cells fire); the
    # per-window lengths go to the device once.
    n_seg = int(np.max(np.ceil(group.sim_ns / win - 1e-9))) if C else 0
    t0_all = np.arange(n_seg)[:, None] * win + np.zeros(C)
    t1_all = np.minimum(t0_all + win, group.sim_ns)
    seg_all = np.maximum(t1_all - t0_all, 0.0)
    active_all = seg_all > 1e-12
    fire_all = active_all & (t1_all >= t0_all + win - 1e-9)
    dt_all = put(np.where(active_all, seg_all, 0.0))
    fire_dev = torch.as_tensor(fire_all).to(dev)
    apply_dev = (fire_dev[:, :, None]
                 & torch.as_tensor(has_ctl).to(dev)[None, :, None]
                 & (torch.arange(U, device=dev)[None, None, :]
                    < torch.as_tensor(n_slow_cell).to(dev)[None, :, None]))

    # Throttle state written by the ladder (tier-addressed, like apply()).
    tier_cap = torch.full((C, U), inf, **f64)
    tier_rate = torch.ones((C, U), **f64)
    if ladder is not None:
        # The ladder unit behind each (cell, slow tier): the tier's own, or
        # unit 0 for a merged cell (its decision is broadcast).
        L = ladder.units
        merged_dev = torch.as_tensor(merged).to(dev)
        unit_of = torch.where(merged_dev[:, None], 0,
                              torch.arange(U, device=dev).clamp(max=L - 1)[None, :])
        unit_of_host = unit_of.cpu().numpy()
    Wq = torch.zeros((C, S), **f64)  # station waits, warm-started

    bytes_w = torch.zeros((C, W), **f64)
    completed_w = torch.zeros((C, W), **f64)
    latsum_w = torch.zeros((C, W), **f64)
    ins_t = torch.zeros((C, T), **f64)
    occ_t = torch.zeros((C, T), **f64)
    cls_t = torch.zeros((C, T, n_ops), **f64)
    occ_int_t = torch.zeros((C, T), **f64)
    tor_inserts = torch.zeros(C, **f64)
    tor_occ = torch.zeros(C, **f64)
    tor_peak = torch.zeros(C, **f64)
    decisions: List[list] = [[] for _ in range(C)]
    bytes_wins: List[torch.Tensor] = []  # per window, for the timelines
    # Per window, for the histograms: (C, W) mean latency and count, (C, T)
    # the same per tier.
    hist_wins: List[List[torch.Tensor]] = [[], [], [], []]
    # Per window with a recording cell firing: (window, the record cells'
    # per-tier inserts, occupancy and class counts).
    rec_idx = torch.as_tensor(rec_cells).to(dev)
    rec_k: List[int] = []
    rec_wins: List[torch.Tensor] = []

    for k in range(n_seg):
        active = active_all[k]
        if not active.any():
            break
        fire = fire_all[k]
        COUNTS.windows += 1

        # -- routing & throttles for this window --------------------------
        if has_phases:
            (frac,) = _to_device(dev, group.window_fracs(t0_all[k], t1_all[k],
                                                         base=tier_frac_live))
        else:
            frac = tier_frac  # (C, W, T)
        route = torch.cat([frac * (1.0 - p_llc)[:, :, None], p_llc[:, :, None]],
                          dim=2)  # stations: tiers, then the LLC (S = T + 1)
        if T > 1:
            touched = managed[:, :, None] & (frac[:, :, 1:] > 1e-12)
            w_cap = torch.where(touched, tier_cap[:, None, :T - 1], inf).amin(dim=2)
            w_rate = torch.where(touched, tier_rate[:, None, :T - 1], 1.0).amin(dim=2)
        else:
            w_cap = torch.full((C, W), inf, **f64)
            w_rate = torch.ones((C, W), **f64)
        A = torch.minimum(cores, w_cap)
        A = torch.where(active_w, A.clamp(min=0.0), 0.0)
        e_cost = (frac * svc[:, :, :T]).sum(dim=2)
        y_rate = torch.where(w_rate >= 1.0 - 1e-12, inf,
                             w_rate / e_cost.clamp(min=1e-9))
        o_eff = A * effmlp
        route_svc = route * svc

        # -- equilibrium solve (wait relaxation + water-filling) ----------
        y, Wq, lam = kernel.fused_window_solve(
            A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor_cap,
            irq_cap, Wq, _N_OUTER, _DAMP)
        coupled = torch.isfinite(lam)

        # -- accumulate window counters -----------------------------------
        dt = dt_all[k]
        ins_w = y * dt[:, None]
        r_sta = Wq[:, None, :] + svc_pipe
        R_tor = (route * r_sta).sum(dim=2)
        y_tot = y.sum(dim=1)
        w_irq = torch.where(coupled, irq_cap / y_tot.clamp(min=1e-9), 0.0)
        ins_dev = ins_w[:, :, None] * route[:, :, :T]
        ins_t += ins_dev.sum(dim=1)
        occ_dev = ins_dev * r_sta[:, :, :T]
        occ_t += occ_dev.sum(dim=1)
        cls_w = (ins_dev[:, :, :, None] * op_onehot[:, :, None, :]).sum(dim=1)
        cls_t += cls_w
        bytes_win = ins_w * (frac * bytes_t).sum(dim=2)
        bytes_w += bytes_win
        bytes_wins.append(bytes_win)
        completed_w += ins_w
        lat_mean = R_tor + w_irq[:, None]  # (C, W) analytic mean latency
        latsum_w += ins_w * lat_mean
        if hist_on:
            lat_dev = r_sta[:, :, :T] + w_irq[:, None, None]
            cnt_t = ins_dev.sum(dim=1)
            mean_t = (ins_dev * lat_dev).sum(dim=1) / cnt_t.clamp(min=1e-300)
            for acc, x in zip(hist_wins, (lat_mean, ins_w, mean_t, cnt_t)):
                acc.append(x)
        tor_inserts += ins_w.sum(dim=1)
        pop = torch.minimum((y * R_tor).sum(dim=1), tor_cap)
        tor_occ += pop * dt
        tor_peak = torch.maximum(tor_peak, pop)
        llc_res = route[:, :, llc] * r_sta[:, :, llc]
        occ_int_t += (occ_dev + (ins_w * llc_res)[:, :, None] * frac).sum(dim=1)

        if len(rec_cells) and fire[rec_cells].any():
            rec_k.append(k)
            rec_wins.append(torch.cat([ins_dev.sum(dim=1), occ_dev.sum(dim=1),
                                       cls_w.reshape(C, T * n_ops)], dim=1)[rec_idx])

        # -- fire the control window (decisions apply to the next one) ----
        if not fire.any():
            continue
        t_fire = fire & tier_cells
        host = None
        if ladder is not None:
            # Slow-tier window deltas per ladder unit: each tier's own, or for
            # a merged cell their fold in unit 0.
            n_avail = min(L, T - 1)
            slow = [ins_dev.sum(dim=1)[:, 1:], occ_dev.sum(dim=1)[:, 1:], cls_w[:, 1:]]
            feed = []
            for x in slow:
                per = x.new_zeros((C, L) + x.shape[2:])
                per[:, :n_avail] = x[:, :n_avail]
                fold = x.new_zeros(per.shape)
                fold[:, 0] = x.sum(dim=1)
                feed.append(torch.where(merged_dev.view((C,) + (1,) * (per.dim() - 1)),
                                        fold, per))
            out = ladder.window(ins_dev[:, :, 0].sum(dim=1), occ_dev[:, :, 0].sum(dim=1),
                                cls_w[:, 0], *feed)
            # Tier-addressed apply: per-tier caps/rates for the next window,
            # written once for every firing cell with a controller.
            tier_cap = torch.where(apply_dev[k], out["cap"].gather(1, unit_of), tier_cap)
            tier_rate = torch.where(apply_dev[k], out["rate"].gather(1, unit_of), tier_rate)
            # One transfer: the ladder's outputs and, for a group with tiering,
            # its migration budgets and the tiering cells' window completions.
            extra = [ladder.migration_budgets(), ins_w[tier_idx]] if vt is not None else []
            got = _to_host(*(out[f] for f in _LADDER_FIELDS), *extra)
            host = dict(zip(_LADDER_FIELDS, got))
            for ci in np.flatnonzero(fire & has_ctl):
                names = group.plans[ci].export["tier_names"][1:]
                ds = []
                for u in range(int(n_slow_cell[ci])):
                    if merged[ci] and u > 0:
                        ds.append(ds[0])
                        continue
                    cap_v = float(host["cap"][ci, u])
                    restricted = bool(host["restricted"][ci, u])
                    est = TierEstimate(
                        t_avg=float(host["t_avg"][ci, u]),
                        alpha=float(host["alpha"][ci, u]),
                        t_slow=float(host["t_slow"][ci, u]),
                        t_slow_raw=float(host["t_slow_raw"][ci, u]),
                        threshold=float(host["threshold"][ci, u]),
                        backlogged=bool(host["backlogged"][ci, u]),
                        valid=bool(host["valid"][ci, u]),
                    )
                    ds.append(Decision(
                        max_concurrency=(
                            None if not restricted or math.isinf(cap_v) else int(cap_v)
                        ),
                        rate_factor=float(host["rate"][ci, u]),
                        phase=Phase.RESTRICTED if restricted else Phase.UNRESTRICTED,
                        estimate=est,
                    ))
                decisions[ci].append(TierDecisions(tiers=tuple(names), decisions=tuple(ds)))

        # -- tiering pass: migrations, hotness, placements (post-fire) ----
        if t_fire.any():
            if host is None:
                budgets = restr = None
                (ins_host[tier_cells],) = _to_host(ins_w[tier_idx])
            else:
                budgets, ins_host[tier_cells] = got[len(_LADDER_FIELDS):]
                # Each slow tier's restricted bit: its own unit's, or a
                # merged cell's unit 0 (the merged law broadcasts it).
                restr = host["restricted"][np.arange(C)[:, None], unit_of_host] > 0.5
            t0 = time.perf_counter()
            vt.step(fire, ins_host, budgets, restr, has_ctl & ~merged, has_ctl,
                    (k + 1) * win, tier_frac_live, effmlp_live)
            COUNTS.tiering_s += time.perf_counter() - t0
            COUNTS.tiering_steps += 1
            if not all(np.array_equal(a, b) for a, b in zip(live, sent)):
                # The pass moved routing or issue gating: send both again.
                for a, b in zip(live, sent):
                    b[...] = a
                tier_frac, effmlp = _to_device(dev, *live)

    # -- materialize SimResults -------------------------------------------
    n_run = len(bytes_wins)
    timeline = (torch.stack(bytes_wins) if n_run
                else torch.zeros((0, C, W), **f64))
    hists = [torch.stack(h) if h else torch.zeros((0, C, W if i < 2 else T), **f64)
             for i, h in enumerate(hist_wins)]
    recs = (torch.stack(rec_wins) if rec_wins
            else torch.zeros((0, len(rec_cells), T * (2 + n_ops)), **f64))
    (bytes_w, completed_w, latsum_w, ins_t, occ_t, cls_t, occ_int_t, tor_inserts,
     tor_occ, tor_peak, timeline, recs, *hists) = _to_host(
        bytes_w, completed_w, latsum_w, ins_t, occ_t, cls_t, occ_int_t,
        tor_inserts, tor_occ, tor_peak, timeline, recs, *hists)
    records = _window_records(group, rec_cells, rec_k, recs, fire_all, has_ctl,
                              hist_mask, hists, decisions, vt)
    results: List[SimResult] = []
    for ci, plan in enumerate(group.plans):
        e = plan.export
        names = e["tier_names"]
        fired = np.flatnonzero(fire_all[:n_run, ci])
        stats = {}
        for wi, name in enumerate(e["w_names"]):
            st = WorkloadStats()
            st.completed = int(round(completed_w[ci, wi]))
            st.bytes = float(bytes_w[ci, wi])
            st.latency_sum = float(latsum_w[ci, wi])
            st.latency_count = st.completed
            mean = st.latency_sum / max(1, st.latency_count)
            # No per-request reservoir in the fluid lane: percentiles
            # degenerate to the mean.
            st.latency_samples = [mean] if st.completed else []
            st.timeline = [((k + 1) * win, float(timeline[k, ci, wi])) for k in fired]
            if hist_mask[ci]:
                st.latency_hist = _window_hist(hists[0][:, ci, wi], hists[1][:, ci, wi])
            stats[name] = st
        tcs = {}
        for t in range(e["n_tiers"]):
            tc = TierCounters()
            tc.inserts = int(round(ins_t[ci, t]))
            tc.occupancy_time = float(occ_t[ci, t])
            tc.class_counts = {
                op: int(round(cls_t[ci, t, o])) for o, op in enumerate(_OPS)
            }
            tcs[names[t]] = tc
        results.append(SimResult(
            sim_ns=float(group.sim_ns[ci]),
            stats=stats,
            tier_counters=tcs,
            tor_peak=int(math.ceil(tor_peak[ci])),
            tor_occupancy_integral=float(tor_occ[ci]),
            tor_inserts=int(round(tor_inserts[ci])),
            decisions=decisions[ci],
            per_tier_occupancy_integral={
                names[t]: float(occ_int_t[ci, t]) for t in range(e["n_tiers"])
            },
            window_records=records.get(ci, []),
            tier_latency_hist=(
                {names[t]: _window_hist(hists[2][:, ci, t], hists[3][:, ci, t])
                 for t in range(e["n_tiers"])} if hist_mask[ci] else None),
            tiering=vt.summary(ci) if vt is not None else None,
        ))
    return results


def _window_records(group: BatchGroup, rec_cells, rec_k, recs, fire_all, has_ctl,
                    hist_mask, hists, decisions, vt) -> dict:
    """Each recording cell's per-window records (cell -> list), built on the
    host from the windows gathered on the device: ``recs[j, r]`` holds
    record cell ``r``'s per-tier inserts, occupancy and class counts of
    window ``rec_k[j]``; a tiering cell's block is its tiering pass's log
    entry of that window."""
    T, n_ops = group.n_tiers, len(_OPS)
    out = {int(ci): [] for ci in rec_cells}
    fired = np.zeros(len(group.plans), np.int64)  # fired windows per cell so far
    at = {k: j for j, k in enumerate(rec_k)}
    for k in range(rec_k[-1] + 1 if rec_k else 0):
        fired += fire_all[k]
        j = at.get(k)
        if j is None:
            continue
        ins, occ = recs[j, :, :T], recs[j, :, T:2 * T]
        cls = recs[j, :, 2 * T:].reshape(-1, T, n_ops)
        for r, ci in enumerate(rec_cells):
            if not fire_all[k, ci]:
                continue
            e = group.plans[ci].export
            rec: dict = {"window": int(fired[ci]), "t_ns": float((k + 1) * group.window_ns)}
            if has_ctl[ci]:
                names = e["tier_names"]
                rec["tiers"] = {
                    names[t]: {
                        "inserts": int(round(ins[r, t])),
                        "occupancy_time": float(occ[r, t]),
                        "class_counts": {op.value: int(round(cls[r, t, o]))
                                         for o, op in enumerate(_OPS)},
                    }
                    for t in range(e["n_tiers"])
                }
                td = decisions[ci][int(fired[ci]) - 1]
                rec["decision"] = {t: _decision_jsonable(d) for t, d in td.items()}
            if vt is not None and vt.cell_act[ci]:
                entry = vt.window_log[ci][int(fired[ci]) - 1]
                rec["tiering"] = {key: v for key, v in entry.items()
                                  if key not in ("window", "t_ns")}
            if hist_mask[ci]:
                # One weighted entry per workload: the window's analytic
                # contribution to the workload's histogram.
                lh = {}
                for wi, nm in enumerate(e["w_names"]):
                    h = LatencyHistogram()
                    h.record_weighted(float(hists[0][k, ci, wi]), float(hists[1][k, ci, wi]))
                    lh[nm] = h.to_jsonable()
                rec["latency_hist"] = lh
            out[int(ci)].append(rec)
    return out


def _window_hist(means: np.ndarray, counts: np.ndarray) -> LatencyHistogram:
    """One weighted entry per window with completions, in window order."""
    h = LatencyHistogram()
    for v, n in zip(means.tolist(), counts.tolist()):
        if n > 0.0:
            h.record_weighted(v, n)
    return h
