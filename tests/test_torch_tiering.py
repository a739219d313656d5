"""Port parity: the tiering subsystem's copies (repro_torch.tiering) and the
MIKU migration budgets against the reference's (repro.tiering,
repro.core.controller), on numpy-seeded inputs, on the CPU.

PageMap and PageRegion (access weights, decay, drift, tier fractions,
moves, the rounding of the contiguous initial placement, bad placements),
MigrationEngine.on_completions, each policy's decide (miku_coordinated
under zero budgets and under the restricted bit), SlowTierMiku's and
VectorMikuLadder's migration budgets along seeded window sequences, and
ServingEngine.kv_tier_bytes (the counterpart of tests/test_tiering.py's
test_kv_tier_bytes_follows_pagemap)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.controller as ref_ctl
import repro.core.littles_law as ref_ll
import repro.tiering as rt
import repro_torch.core.littles_law as port_ll
import repro_torch.tiering as pt
from repro.core.device_model import PLATFORMS as REF_PLATFORMS
from repro.memsim.calibration import default_miku as ref_default_miku
from repro_torch.core import controller as ctl
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.littles_law import OpClass
from repro_torch.memsim.calibration import default_miku
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

TIERS = ("ddr", "cxl", "cxl_sw")


def _pattern(mod, rng, n):
    return mod.HotSetPattern(hot_fraction=float(rng.choice([0.05, 0.125, 0.5, 1.0])),
                             hot_weight=float(rng.uniform(0.5, 1.0)),
                             drift_pages=float(rng.choice([0.0, 1.0, 3.5, 64.0])),
                             hot_start=int(rng.integers(0, 2 * n)))


def _pagemaps(seed, n_regions=3):
    """The same random PageMap built through both packages."""
    rng = np.random.default_rng(seed)
    cap, decay = int(rng.integers(8, 200)), float(rng.uniform(0.3, 0.9))
    maps = [mod.PageMap(TIERS, cap, decay=decay) for mod in (rt, pt)]
    for ri in range(n_regions):
        n = int(rng.integers(5, 300))
        f = rng.dirichlet(np.ones(3))
        placement = dict(zip(TIERS, (float(f[0]), float(f[1]), 1.0 - float(f[0]) - float(f[1]))))
        pat_seed = int(rng.integers(1 << 30))
        for mod, pm in zip((rt, pt), maps):
            pm.add_region(f"r{(ri * 7) % n_regions}{ri}", n, 4096, placement,
                          _pattern(mod, np.random.default_rng(pat_seed), n))
    return rng, maps


def _same_region(r, p):
    assert np.array_equal(p.tier, r.tier) and p.home_slow == r.home_slow
    assert np.array_equal(p.hotness, r.hotness)
    assert np.array_equal(p.access_weights(), r.access_weights())
    assert np.array_equal(p.tier_fractions(), r.tier_fractions())


@pytest.mark.parametrize("seed", range(4))
def test_pagemap_matches_reference_along_seeded_windows(seed):
    """Initial placement (rounded cumulative runs), access weights, hotness
    decay and accumulation, hot-set drift, moves, tier fractions and
    occupancy, window by window."""
    rng, (ref, port) = _pagemaps(seed)
    assert list(port.regions) == list(ref.regions)
    for _ in range(25):
        for name in ref.regions:
            n_acc = float(rng.choice([0.0, rng.uniform(0, 500)]))
            ref.record_window(name, n_acc)
            port.record_window(name, n_acc)
            reg = ref.regions[name]
            for page in rng.integers(0, reg.n_pages, 3):
                dst = int(rng.integers(0, 3))
                ref.move(name, int(page), dst)
                port.move(name, int(page), dst)
            _same_region(ref.regions[name], port.regions[name])
            assert port.fast_fraction(name) == ref.fast_fraction(name)
            assert port.placement_fractions(name) == ref.placement_fractions(name)
        assert port.fast_pages_used() == ref.fast_pages_used()
        assert port.occupancy() == ref.occupancy()


@pytest.mark.parametrize("placement", [
    {"ddr": 1 / 3, "cxl": 1 / 3, "cxl_sw": 1 / 3},
    {"ddr": 0.25, "cxl_sw": 0.75},
    {"cxl": 1.0},
    {"ddr": 0.999999, "cxl": 0.0000005, "cxl_sw": 0.0000005},
])
def test_initial_placement_rounding_matches_reference(placement):
    for n in (1, 7, 10, 1024):
        r = rt.PageMap(TIERS, 4).add_region("w", n, 4096, placement)
        p = pt.PageMap(TIERS, 4).add_region("w", n, 4096, placement)
        _same_region(r, p)


@pytest.mark.parametrize("bad", [
    dict(placement={"hbm": 1.0}),
    dict(placement={"ddr": 0.5, "cxl": 0.4}),
    dict(n_pages=0),
    dict(duplicate=True),
    dict(tiers=("ddr",)),
    dict(pattern=dict(hot_fraction=0.0)),
    dict(pattern=dict(hot_weight=1.5)),
])
def test_bad_placements_raise_as_the_reference(bad):
    def attempt(mod):
        pm = mod.PageMap(bad.get("tiers", TIERS), 8)
        pat = mod.HotSetPattern(**bad["pattern"]) if "pattern" in bad else None
        pm.add_region("w", bad.get("n_pages", 8), 4096,
                      bad.get("placement", {"ddr": 1.0}), pat)
        if bad.get("duplicate"):
            pm.add_region("w", 8, 4096, {"ddr": 1.0})

    with pytest.raises(ValueError) as ref_err:
        attempt(rt)
    with pytest.raises(ValueError) as port_err:
        attempt(pt)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("seed", range(3))
def test_migration_engine_on_completions_matches_reference(seed):
    rng, (ref_pm, port_pm) = _pagemaps(seed + 10)
    rpp = {1: int(rng.integers(1, 9)), 2: int(rng.integers(1, 9))}
    ref, port = rt.MigrationEngine(rpp), pt.MigrationEngine(rpp)
    names = list(ref_pm.regions)
    for _ in range(30):
        jobs = []
        for _ in range(int(rng.integers(0, 12))):
            name = names[int(rng.integers(len(names)))]
            page = int(rng.integers(ref_pm.regions[name].n_pages))
            slow = int(rng.integers(1, 3))
            src, dst = (slow, 0) if rng.random() < 0.6 else (0, slow)
            jobs.append((name, page, src, dst))
        assert (port.enqueue(pt.MigrationJob(*j) for j in jobs)
                == ref.enqueue(rt.MigrationJob(*j) for j in jobs))
        for code in (1, 2):
            assert port.pending_reqs(code) == ref.pending_reqs(code)
            n = int(rng.integers(0, 40))
            assert (port.on_completions(code, n, port_pm)
                    == ref.on_completions(code, n, ref_pm))
        assert port.queued_promotions() == ref.queued_promotions()
        assert port.queued_demotions() == ref.queued_demotions()
        assert port.counters() == ref.counters()
        for name in names:
            _same_region(ref_pm.regions[name], port_pm.regions[name])


def _decisions(mod, restricted):
    """TierDecisions with the given restricted bit per slow tier."""
    ds = tuple(mod.Decision(max_concurrency=1 if r else None, rate_factor=1.0,
                            phase=mod.Phase.RESTRICTED if r else mod.Phase.UNRESTRICTED)
               for r in restricted)
    return mod.TierDecisions(tiers=TIERS[1:], decisions=ds)


@pytest.mark.parametrize("policy", ["static", "hotness_lru", "miku_coordinated"])
@pytest.mark.parametrize("seed", range(3))
def test_policy_decide_matches_reference(policy, seed):
    """Each policy's jobs and deferrals, window by window, with the pages
    the reference's engine moves; miku_coordinated under random budgets
    (zero included), and under the restricted bit when no budgets are
    given."""
    rng, (ref_pm, port_pm) = _pagemaps(seed + 20)
    kw = {} if policy == "static" else dict(
        promote_per_window=int(rng.integers(1, 80)),
        demote_per_window=int(rng.integers(1, 80)),
        high_watermark=float(rng.uniform(0.6, 0.95)), low_watermark=0.5)
    if policy == "miku_coordinated":
        kw["jobs_per_budget_unit"] = int(rng.integers(1, 9))
    ref_pol, port_pol = rt.make_policy(policy, **kw), pt.make_policy(policy, **kw)
    rpp = {1: 2, 2: 3}
    ref_eng, port_eng = rt.MigrationEngine(rpp), pt.MigrationEngine(rpp)
    moved = 0
    for w in range(20):
        for name in ref_pm.regions:
            n = float(rng.uniform(0, 400))
            ref_pm.record_window(name, n)
            port_pm.record_window(name, n)
        mode = int(rng.integers(3))
        budgets = ({t: int(rng.choice([0, 1, 2, 4])) for t in TIERS[1:]}
                   if mode == 0 else None)
        restricted = [bool(rng.random() < 0.5) for _ in TIERS[1:]]
        ref_ctx = rt.PolicyContext(window=w, tier_names=TIERS, engine=ref_eng,
                                   budgets=budgets,
                                   decisions=_decisions(ref_ctl, restricted) if mode == 1
                                   else None)
        port_ctx = pt.PolicyContext(window=w, tier_names=TIERS, engine=port_eng,
                                    budgets=budgets,
                                    decisions=_decisions(ctl, restricted) if mode == 1
                                    else None)
        ref_jobs = ref_pol.decide(ref_pm, ref_ctx)
        port_jobs = port_pol.decide(port_pm, port_ctx)
        key = [(j.region, j.page, j.src, j.dst) for j in ref_jobs]
        assert [(j.region, j.page, j.src, j.dst) for j in port_jobs] == key
        assert port_ctx.deferred == ref_ctx.deferred
        ref_eng.enqueue(ref_jobs)
        port_eng.enqueue(port_jobs)
        for code in (1, 2):
            n = int(rng.integers(0, 30))
            got = port_eng.on_completions(code, n, port_pm)
            assert got == ref_eng.on_completions(code, n, ref_pm)
            moved += sum(got)
    if policy != "static":
        assert moved > 0
    else:
        assert moved == 0


def test_miku_coordinated_defers_everything_under_zero_budgets():
    for mod in (rt, pt):
        pm = mod.PageMap(("ddr", "cxl"), 64)
        pm.add_region("w", 128, 4096, {"cxl": 1.0})
        pm.record_window("w", 1000.0)
        eng = mod.MigrationEngine({1: 2})
        ctx = mod.PolicyContext(window=1, tier_names=("ddr", "cxl"), engine=eng,
                                budgets={"cxl": 0})
        assert mod.make_policy("miku_coordinated").decide(pm, ctx) == []
        assert ctx.deferred == 64
        ctx.budgets = {"cxl": 1}
        ctx.deferred = 0
        assert len(mod.make_policy("miku_coordinated").decide(pm, ctx)) == 8
        assert ctx.deferred == 56


def test_make_policy_names_the_registry():
    with pytest.raises(ValueError, match="hotness_lru, miku_coordinated, static"):
        pt.make_policy("bogus")
    assert sorted(pt.POLICIES) == sorted(rt.POLICIES)


def _counters(ll, rng, scale):
    """Random window counters in the types of littles_law module ``ll``."""
    tc = ll.TierCounters()
    n = int(rng.integers(0, 400) * scale)
    tc.inserts = n
    tc.occupancy_time = float(n * rng.uniform(50.0, 2000.0))
    split = rng.multinomial(n, [0.4, 0.2, 0.2, 0.1, 0.1]) if n else [0] * 5
    tc.class_counts = {op: int(k) for op, k in zip(tuple(ll.OpClass), split)}
    return tc


def _pair(rng, scale):
    """The same random window counters in both packages' types."""
    seed = int(rng.integers(1 << 30))
    return (_counters(ref_ll, np.random.default_rng(seed), scale),
            _counters(port_ll, np.random.default_rng(seed), scale))


@pytest.mark.parametrize("seed", [3, 4])
def test_migration_budgets_match_reference_along_seeded_windows(seed):
    """SlowTierMiku.migration_budget, MikuController.migration_budgets and
    VectorMikuLadder.migration_budgets (read after each window) against
    the reference's, per cell and tier."""
    rng = np.random.default_rng(seed)
    names = ["A", "B", "A-switch", "A"]
    ref_ctls, port_ctls, ref_units, port_units = [], [], [], []
    for nm in names:
        r, p = ref_default_miku(REF_PLATFORMS[nm], 4), default_miku(PLATFORMS[nm], 4)
        tiers = list(REF_PLATFORMS[nm].tier_names[1:])
        r._ensure_units(len(tiers), tiers)
        p._ensure_units(len(tiers), tiers)
        ref_ctls.append(r)
        port_ctls.append(p)
        ref_units.append(r.units[:len(tiers)])
        port_units.append(p.units[:len(tiers)])
    # The vector ladders run their own copies of the calibrated units.
    ref_vec = ref_ctl.VectorMikuLadder.from_units(ref_units)
    port_vec = ctl.VectorMikuLadder.from_units(port_units, "cpu")
    C, U, n_ops = len(names), 2, len(OpClass)
    seen = set()
    for w in range(60):
        fast = np.zeros((C, 3))
        f_cls = np.zeros((C, n_ops))
        s_ins, s_occ, s_cls = np.zeros((C, U)), np.zeros((C, U)), np.zeros((C, U, n_ops))
        for ci, nm in enumerate(names):
            rf, pf = _pair(rng, rng.choice([0.0, 0.2, 1.0]))
            slows = [_pair(rng, rng.choice([0.0, 1.0, 3.0]))
                     for _ in ref_ctls[ci].units]
            ref_ctls[ci].window([rf] + [s[0] for s in slows])
            port_ctls[ci].window([pf] + [s[1] for s in slows])
            fast[ci] = pf.inserts, pf.occupancy_time, 0
            f_cls[ci] = [pf.class_counts.get(op, 0) for op in OpClass]
            for u, (_, ps) in enumerate(slows):
                s_ins[ci, u], s_occ[ci, u] = ps.inserts, ps.occupancy_time
                s_cls[ci, u] = [ps.class_counts.get(op, 0) for op in OpClass]
            for ru, pu in zip(ref_ctls[ci].units, port_ctls[ci].units):
                assert pu.migration_budget() == ru.migration_budget(), (w, nm)
            assert port_ctls[ci].migration_budgets() == ref_ctls[ci].migration_budgets()
            seen.update(port_ctls[ci].migration_budgets().values())
        arrays = (fast[:, 0], fast[:, 1], f_cls, s_ins, s_occ, s_cls)
        ref_vec.window(*arrays)
        port_vec.window(*(torch.as_tensor(a) for a in arrays))
        got = port_vec.migration_budgets()
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), ref_vec.migration_budgets()), w
    assert 0 in seen and len(seen) > 1


def test_kv_tier_bytes_follows_pagemap():
    pm = pt.PageMap(("hbm", "host"), fast_capacity_pages=8)
    pm.add_region("eng", 10, 4096, {"hbm": 0.5, "host": 0.5},
                  pt.HotSetPattern(hot_fraction=1.0))  # uniform access
    stub = SimpleNamespace(kv_pagemap=pm, cfg=SimpleNamespace(name="eng", placement="host"),
                           n_active=4)
    assert ServingEngine.kv_tier_bytes(stub, 1000) == (500, 500)
    pm.move("eng", 9, 0)  # promote one KV page
    assert ServingEngine.kv_tier_bytes(stub, 1000) == (600, 400)
    # Without a PageMap the static placement decides, bit for bit.
    stub_static = SimpleNamespace(kv_pagemap=None,
                                  cfg=SimpleNamespace(name="eng", placement="host"),
                                  n_active=4)
    assert ServingEngine.kv_tier_bytes(stub_static, 1000) == (0, 1000)
    stub_static.cfg.placement = "device"
    assert ServingEngine.kv_tier_bytes(stub_static, 1000) == (1000, 0)
    # A PageMap without this engine's region leaves the placement split.
    stub.cfg.name = "other"
    assert ServingEngine.kv_tier_bytes(stub, 1000) == (0, 1000)
