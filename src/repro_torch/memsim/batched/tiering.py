"""Vectorized tiering: the ``(cells x regions x pages)`` twin of the hook.

A copy of ``repro.memsim.batched.tiering``, and like it host numpy: FIFO
retirement order is load-bearing and a window's job volume is tiny, so the
state stays on the host beside the fluid engine's device arrays, which
hand it each window's completions and the ladder's views.

The scalar lane drives one :class:`~repro_torch.tiering.hook.TieringHook`
per simulation: a PageMap of decayed per-page hotness, a
MigrationEngine of per-slow-tier FIFO copy queues, and a policy that turns
both into promotion/demotion jobs each control window.  This module stacks
all of that across a whole cell group:

* page state lives in padded ``(C, R, P)`` arrays (tier codes, hotness,
  queued flags, active masks); decay, hot-set weighting, drift and
  placement re-resolution are single numpy expressions over every cell;
* policy candidate selection is a vectorized top-k: one ``np.lexsort``
  over the flattened page axis with the scalar policy's exact sort keys
  (``(-hotness, region name, page)`` for promotions, coldest first for
  demotions), truncated per cell by the same free-capacity / watermark /
  per-window budgets;
* only the migration queues stay per-cell Python deques.

The state machine is the scalar hook's fed the same per-window completion
streams: the reference's scalar run replays through it to the pinned
``tests/data/migrate_trace_goldens.json`` decision traces, entry for entry
(``tests/test_torch_batched_tiering.py``).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.tiering.policies import (
    HotnessLRUPolicy,
    MikuCoordinatedPolicy,
    StaticPolicy,
)

_POL_STATIC, _POL_LRU, _POL_MIKU = 0, 1, 2


def _num(x: float):
    """Integral floats as ints (scalar counters are ints; fluid credit is
    real-valued — keep telemetry honest either way)."""
    r = round(x)
    return int(r) if abs(x - r) < 1e-9 else float(x)


def build_tiering(group) -> Optional["VectorTiering"]:
    """The group's stacked tiering twin (None when no cell has a hook).

    Raises ``ValueError`` naming a policy the twin cannot express (a
    foreign registration in :data:`repro_torch.tiering.policies.POLICIES`):
    the lane catches it and runs that job on the scalar DES."""
    if not any(p.tiering is not None for p in group.plans):
        return None
    return VectorTiering(group.plans, group.n_tiers)


class VectorTiering:
    """Stacked per-cell tiering state over one :class:`BatchGroup`."""

    def __init__(self, plans: Sequence, n_tiers: int) -> None:
        hooks = [p.tiering for p in plans]
        C = len(plans)
        T = n_tiers
        U = max(1, T - 1)
        self.C, self.T, self.U = C, T, U
        self.cell_act = np.array([h is not None for h in hooks], bool)
        R = max(
            (len(h.pagemap.regions) for h in hooks if h is not None),
            default=1,
        ) or 1
        P = max(
            (r.n_pages for h in hooks if h is not None
             for r in h.pagemap.regions.values()),
            default=1,
        ) or 1
        self.R, self.P = R, P

        shape3 = (C, R, P)
        self.tier = np.zeros(shape3, np.int64)
        self.hotness = np.zeros(shape3)
        self.page_act = np.zeros(shape3, bool)
        self.queued = np.zeros(shape3, bool)
        self.region_act = np.zeros((C, R), bool)
        self.n_pages = np.zeros((C, R), np.int64)
        self.page_bytes = np.zeros((C, R), np.int64)
        self.home_slow = np.ones((C, R), np.int64)
        self.region_wi = np.zeros((C, R), np.int64)
        #: Lexicographic region-name rank — the scalar policies' sort
        #: tie-break between regions.
        self.region_rank = np.zeros((C, R), np.int64)
        self.hot_frac = np.full((C, R), 1.0)
        self.hot_weight = np.zeros((C, R))
        self.drift = np.zeros((C, R))
        self.hot_start = np.zeros((C, R))
        self.decay = np.ones(C)
        self.fast_cap = np.zeros(C, np.int64)

        # Per-cell policy parameters (one row per cell, scalar defaults).
        self.pol = np.zeros(C, np.int64)
        self.promote_pw = np.zeros(C, np.int64)
        self.demote_pw = np.zeros(C, np.int64)
        self.high_wm = np.ones(C)
        self.low_wm = np.ones(C)
        self.min_hot = np.zeros(C)
        self.jpbu = np.zeros(C, np.int64)

        # Migration engine state: FIFO queues stay per-cell deques (order
        # matters, volume is small); credit/backlog are arrays.
        self.mig_wi = np.full((C, U), -1, np.int64)
        self.mig_act = np.zeros((C, U), bool)
        self.rpp = np.ones((C, U), np.int64)
        self.mig_base = np.zeros((C, U))
        self.credit = np.zeros((C, U))
        self.qlen = np.zeros((C, U), np.int64)
        self._queues: List[List[deque]] = [
            [deque() for _ in range(U)] for _ in range(C)
        ]
        self.q_promo = np.zeros(C, np.int64)
        self.q_demo = np.zeros(C, np.int64)

        # Lifetime counters + telemetry.
        self.promoted = np.zeros(C, np.int64)
        self.demoted = np.zeros(C, np.int64)
        self.migrated_bytes = np.zeros(C, np.int64)
        self.deferred = np.zeros(C, np.int64)
        self.windows = np.zeros(C, np.int64)
        self.window_log: List[List[dict]] = [[] for _ in range(C)]
        self.region_names: List[List[str]] = [[] for _ in range(C)]
        self.tier_names: List[List[str]] = [
            list(p.export["tier_names"]) for p in plans
        ]
        self.policy_name: List[str] = [""] * C

        for ci, h in enumerate(hooks):
            if h is None:
                continue
            pm = h.pagemap
            names = list(pm.regions)
            self.region_names[ci] = names
            rank = {nm: i for i, nm in enumerate(sorted(names))}
            self.decay[ci] = pm.decay
            self.fast_cap[ci] = pm.fast_capacity_pages
            for ri, nm in enumerate(names):
                reg = pm.regions[nm]
                n = reg.n_pages
                self.region_act[ci, ri] = True
                self.n_pages[ci, ri] = n
                self.page_bytes[ci, ri] = reg.page_bytes
                self.home_slow[ci, ri] = reg.home_slow
                self.region_wi[ci, ri] = h._region_wi[nm]
                self.region_rank[ci, ri] = rank[nm]
                self.tier[ci, ri, :n] = reg.tier
                self.page_act[ci, ri, :n] = True
                pat = reg.pattern
                self.hot_frac[ci, ri] = pat.hot_fraction
                self.hot_weight[ci, ri] = pat.hot_weight
                self.drift[ci, ri] = pat.drift_pages
                self.hot_start[ci, ri] = reg._hot_start
            for code, wi in h._mig_wi.items():
                u = code - 1
                self.mig_wi[ci, u] = wi
                self.mig_act[ci, u] = True
                self.rpp[ci, u] = h.engine.reqs_per_page[code]
                self.mig_base[ci, u] = h._mig_effmlp[wi]
            pol = h.policy
            self.policy_name[ci] = pol.name
            if isinstance(pol, MikuCoordinatedPolicy):
                self.pol[ci] = _POL_MIKU
                self.jpbu[ci] = pol.jobs_per_budget_unit
                base: Optional[HotnessLRUPolicy] = pol.base
            elif isinstance(pol, HotnessLRUPolicy):
                self.pol[ci] = _POL_LRU
                base = pol
            elif isinstance(pol, StaticPolicy):
                self.pol[ci] = _POL_STATIC
                base = None
            else:
                raise ValueError(
                    f"the batched lane cannot vectorize tiering policy "
                    f"{getattr(pol, 'name', type(pol).__name__)!r} (it runs static, "
                    "hotness_lru and miku_coordinated)"
                )
            if base is not None:
                self.promote_pw[ci] = base.promote_per_window
                self.demote_pw[ci] = base.demote_per_window
                self.high_wm[ci] = base.high_watermark
                self.low_wm[ci] = base.low_watermark
                self.min_hot[ci] = base.min_hotness

        # Static sort keys for the flattened (region, page) axis.
        self._pidx = np.arange(P, dtype=np.float64)
        self._page_flat = np.broadcast_to(
            np.arange(P, dtype=np.int64), (R, P)
        ).reshape(-1)
        self._rank_flat = np.broadcast_to(
            self.region_rank[:, :, None], shape3
        ).reshape(C, R * P)

    # -- access model (PageRegion.access_weights, vectorized) ------------
    def _access_weights(self) -> np.ndarray:
        """Per-page access probability ``(C, R, P)`` under each region's
        current hot window (zero on padding)."""
        n = np.maximum(self.n_pages, 1).astype(np.float64)
        n_hot = np.maximum(1.0, np.round(self.hot_frac * n))
        uniform = n_hot >= n
        base = (1.0 - self.hot_weight) / np.maximum(n - n_hot, 1.0)
        rel = (
            self._pidx[None, None, :] - np.trunc(self.hot_start)[:, :, None]
        ) % n[:, :, None]
        is_hot = rel < n_hot[:, :, None]
        w = np.where(
            is_hot, self.hot_weight[:, :, None] / n_hot[:, :, None],
            base[:, :, None],
        )
        w = np.where(uniform[:, :, None], 1.0 / n[:, :, None], w)
        return np.where(self.page_act, w, 0.0)

    # -- one control window ----------------------------------------------
    def step(
        self,
        fire: np.ndarray,
        ins_w: np.ndarray,
        budgets: Optional[np.ndarray],
        restricted: Optional[np.ndarray],
        has_budgets: np.ndarray,
        has_decisions: np.ndarray,
        t_ns: float,
        tier_frac_live: np.ndarray,
        effmlp_live: np.ndarray,
    ) -> None:
        """One per-window tiering pass across every fired cell.

        ``ins_w`` is the window's per-workload completed macro-requests
        (``(C, W)``, the fluid station accounting the scalar hook samples);
        ``budgets``/``restricted`` are the post-window ladder views
        (``(C, U)``), consulted per ``has_budgets``/``has_decisions`` the
        way :class:`~repro_torch.tiering.policies.PolicyContext` is; routing and
        migration issue gating are written into ``tier_frac_live`` /
        ``effmlp_live`` for the *next* window, the fluid image of the
        scalar hook's re-pump."""
        act = fire & self.cell_act
        if not act.any():
            return
        C, R, P, T = self.C, self.R, self.P, self.T
        self.windows += act

        # 1. Completed MIGRATE traffic retires jobs FIFO and flips pages.
        prom_w = np.zeros(C, np.int64)
        dem_w = np.zeros(C, np.int64)
        mig_done: List[Dict[str, object]] = [{} for _ in range(C)]
        for ci in np.flatnonzero(act):
            for u in np.flatnonzero(self.mig_act[ci]):
                d = float(ins_w[ci, self.mig_wi[ci, u]])
                if d <= 0.0:
                    continue
                mig_done[ci][self.tier_names[ci][u + 1]] = _num(d)
                self.credit[ci, u] += d
                rpp = int(self.rpp[ci, u])
                q = self._queues[ci][u]
                n_ret = int(min(len(q), (self.credit[ci, u] + 1e-9) // rpp))
                for _ in range(n_ret):
                    ri, p, _src, dst = q.popleft()
                    self.credit[ci, u] -= rpp
                    self.queued[ci, ri, p] = False
                    self.tier[ci, ri, p] = dst
                    self.migrated_bytes[ci] += self.page_bytes[ci, ri]
                    if dst == 0:
                        prom_w[ci] += 1
                        self.q_promo[ci] -= 1
                    else:
                        dem_w[ci] += 1
                        self.q_demo[ci] -= 1
                self.qlen[ci, u] = len(q)
                if not q:
                    # Surplus credit over an empty queue pays for no page
                    # (over-issued copy traffic), same as the scalar engine.
                    self.credit[ci, u] = 0.0
        self.promoted += prom_w
        self.demoted += dem_w

        # 2. Demand completions feed the hotness tracker, then the hot set
        #    drifts — decay/accumulate/drift in the scalar region's order.
        actR = self.region_act & act[:, None]
        n_acc = np.zeros((C, R))
        ci_i, ri_i = np.nonzero(actR)
        n_acc[ci_i, ri_i] = ins_w[ci_i, self.region_wi[ci_i, ri_i]]
        w_pre = self._access_weights()
        self.hotness[act] *= self.decay[act, None, None]
        self.hotness += np.where(
            ((n_acc > 0) & actR)[:, :, None],
            n_acc[:, :, None] * w_pre, 0.0,
        )
        n_f = np.maximum(self.n_pages, 1).astype(np.float64)
        self.hot_start = np.where(
            actR, (self.hot_start + self.drift) % n_f, self.hot_start
        )

        # 3. Policy pass: vectorized candidate selection (the scalar sort
        #    keys exactly), then per-cell MIKU gating + FIFO enqueue.
        N = R * P
        tier_f = self.tier.reshape(C, N)
        hot_f = self.hotness.reshape(C, N)
        pact_f = self.page_act.reshape(C, N)
        qd_f = self.queued.reshape(C, N)
        page_f = np.broadcast_to(self._page_flat, (C, N))
        fast_used = (pact_f & (tier_f == 0)).sum(axis=1)
        run_pol = act & (self.pol != _POL_STATIC)

        free = self.fast_cap - fast_used - self.q_promo
        budget_p = np.maximum(
            np.where(run_pol, np.minimum(free, self.promote_pw), 0), 0
        )
        cand_p = (
            pact_f & (tier_f != 0) & (hot_f > self.min_hot[:, None])
            & ~qd_f & run_pol[:, None]
        )
        key_p = np.where(cand_p, -hot_f, np.inf)
        order_p = np.lexsort((page_f, self._rank_flat, key_p), axis=-1)
        sort_p = np.take_along_axis(cand_p, order_p, axis=1)
        sel_p = sort_p & (np.cumsum(sort_p, axis=1) <= budget_p[:, None])

        used_d = fast_used - self.q_demo
        over = used_d > self.high_wm * self.fast_cap
        target = np.maximum(
            used_d - np.floor(self.low_wm * self.fast_cap).astype(np.int64),
            0,
        )
        budget_d = np.where(
            run_pol & over, np.minimum(target, self.demote_pw), 0
        )
        cand_d = pact_f & (tier_f == 0) & ~qd_f & run_pol[:, None]
        key_d = np.where(cand_d, hot_f, np.inf)
        order_d = np.lexsort((page_f, self._rank_flat, key_d), axis=-1)
        sort_d = np.take_along_axis(cand_d, order_d, axis=1)
        sel_d = sort_d & (np.cumsum(sort_d, axis=1) <= budget_d[:, None])

        enq_w = np.zeros(C, np.int64)
        def_w = np.zeros(C, np.int64)
        for ci in np.flatnonzero(run_pol):
            jobs: List[tuple] = []
            for fi in order_p[ci][sel_p[ci]]:
                ri, p = divmod(int(fi), P)
                jobs.append((ri, p, int(tier_f[ci, fi]), 0))
            for fi in order_d[ci][sel_d[ci]]:
                ri, p = divmod(int(fi), P)
                jobs.append((ri, p, 0, int(self.home_slow[ci, ri])))
            if not jobs:
                continue
            miku = self.pol[ci] == _POL_MIKU
            taken: Dict[int, int] = {}
            for ri, p, src, dst in jobs:
                code = src if src != 0 else dst
                if miku:
                    if has_budgets[ci]:
                        b = int(budgets[ci, code - 1])
                        if b <= 0 or taken.get(code, 0) >= (
                            b * int(self.jpbu[ci])
                        ):
                            def_w[ci] += 1
                            continue
                    elif has_decisions[ci] and restricted is not None:
                        if bool(restricted[ci, code - 1]):
                            def_w[ci] += 1
                            continue
                    taken[code] = taken.get(code, 0) + 1
                u = code - 1
                self._queues[ci][u].append((ri, p, src, dst))
                self.qlen[ci, u] += 1
                self.queued[ci, ri, p] = True
                if dst == 0:
                    self.q_promo[ci] += 1
                else:
                    self.q_demo[ci] += 1
                enq_w[ci] += 1
        self.deferred += def_w

        # 4. Placement re-resolution: live access-weighted routing vectors
        #    (post-drift weights, exactly PageRegion.tier_fractions).
        w_post = self._access_weights()
        frac_r = np.zeros((C, R, T))
        for t in range(T):
            frac_r[:, :, t] = (w_post * (self.tier == t)).sum(axis=2)
        wis = self.region_wi[ci_i, ri_i]
        tier_frac_live[ci_i, wis, :] = frac_r[ci_i, ri_i, :]

        # 5. Migration issue gating: pseudo-workloads run only with backlog.
        pending = self.qlen * self.rpp - self.credit > 1e-9
        mi, ui = np.nonzero(self.mig_act & act[:, None])
        wim = self.mig_wi[mi, ui]
        effmlp_live[mi, wim] = np.where(
            pending[mi, ui], self.mig_base[mi, ui], 0.0
        )

        # 6. Telemetry: the scalar hook's window_log entry, per cell.
        for ci in np.flatnonzero(act):
            self.window_log[ci].append({
                "window": int(self.windows[ci]),
                "t_ns": float(t_ns),
                "promoted": int(prom_w[ci]),
                "demoted": int(dem_w[ci]),
                "enqueued": int(enq_w[ci]),
                "deferred": int(def_w[ci]),
                "backlog_pages": int(self.qlen[ci].sum()),
                "migrated_bytes": int(self.migrated_bytes[ci]),
                "mig_reqs_completed": mig_done[ci],
                "fast_fraction": {
                    nm: float(frac_r[ci, ri, 0])
                    for ri, nm in enumerate(self.region_names[ci])
                },
            })

    # -- result surface ---------------------------------------------------
    def summary(self, ci: int) -> Optional[dict]:
        """One cell's end-of-run summary, schema-identical to
        :meth:`repro_torch.tiering.hook.TieringHook.summary`."""
        if not self.cell_act[ci]:
            return None
        w = self._access_weights()[ci]
        occupancy = {
            tn: int(((self.tier[ci] == t) & self.page_act[ci]).sum())
            for t, tn in enumerate(self.tier_names[ci])
        }
        return {
            "pages_promoted": int(self.promoted[ci]),
            "pages_demoted": int(self.demoted[ci]),
            "migrated_bytes": int(self.migrated_bytes[ci]),
            "backlog_pages": int(self.qlen[ci].sum()),
            "policy": self.policy_name[ci],
            "windows": int(self.windows[ci]),
            "deferred_jobs": int(self.deferred[ci]),
            "fast_pages_used": int(
                ((self.tier[ci] == 0) & self.page_act[ci]).sum()
            ),
            "occupancy": occupancy,
            "fast_fraction": {
                nm: float((w[ri] * (self.tier[ci, ri] == 0)).sum())
                for ri, nm in enumerate(self.region_names[ci])
            },
        }
