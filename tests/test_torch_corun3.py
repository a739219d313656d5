"""Port parity: the three-tier platforms, the merged MIKU law and the
three-tier scenarios (corun3_switch, corun3_pertier, numa_remote) on the
port's batched lane against the reference's, on the CPU.

The scenarios run at their defaults through both registries with
tests/test_torch_figures.py's checks (exact-lane cells equal, fluid cells
within rel 1e-6 with the same restricted windows, rows key for key), and
every MIKU job's per-tier decisions window by window.  The unit tests hold
the copies to the reference on numpy-seeded inputs: the A-switch and
A-numa tier sets, merge_tier_counters, MergedSlowPolicy, merged_miku's
calibration and the exported tier routing of a ddr_remote placement."""

import math

import numpy as np
import pytest
import torch

import repro.core.controller as ref_ctl
import repro.core.device_model as ref_dm
from repro.core.des import TieredMemorySim, WorkloadSpec as RefWorkload
from repro.core.littles_law import OpClass as RefOp
from repro.core.littles_law import TierCounters as RefCounters
from repro.core.littles_law import TierWindow as RefWindow
from repro.core.littles_law import merge_tier_counters as ref_merge
from repro.memsim.batched.exact import exact_regime as ref_exact_regime
from repro.memsim.batched.stacking import plan_cell as ref_plan_cell
from repro.memsim.calibration import merged_miku as ref_merged_miku
from repro.memsim.sweep import SimJob as RefJob
from repro.memsim.workloads import bw_test as ref_bw_test
from repro.scenarios import plan as ref_plan
from repro_torch.core import controller as ctl
from repro_torch.core import device_model as dm
from repro_torch.core.des import WorkloadSpec, export_state
from repro_torch.core.littles_law import OpClass, TierCounters, TierWindow, merge_tier_counters
from repro_torch.memsim.batched.exact import exact_regime
from repro_torch.memsim.batched.lane import can_batch, run_sweep_batched
from repro_torch.memsim.batched.stacking import plan_cell
from repro_torch.memsim.calibration import merged_miku
from repro_torch.memsim.sweep import SimJob
from repro_torch.memsim.workloads import bw_test
from repro_torch.scenarios import plan
from test_torch_figures import _assert_job, _run_both

torch.set_num_threads(1)

THREE_TIER = ("A-switch", "A-numa")
NEW_SCENARIOS = ("fig13_spark", "fig14_kv", "corun3_switch", "corun3_pertier", "numa_remote")
DEVICE_FIELDS = ("name", "tier", "parallelism", "read_service_ns", "write_service_ns",
                 "pipeline_ns", "interleave", "access_bytes")
PLATFORM_FIELDS = ("name", "tor_entries", "irq_entries", "core_mlp", "n_cores",
                   "llc_service_ns", "llc_slots", "llc_capacity_mb")
ESTIMATE_FIELDS = ("t_avg", "alpha", "t_slow", "t_slow_raw", "threshold", "backlogged",
                   "valid")


def _assert_decision(p, r, rel=1e-6):
    assert p.max_concurrency == r.max_concurrency
    assert p.rate_factor == pytest.approx(r.rate_factor, rel=rel)
    assert p.phase.value == r.phase.value
    for f in ESTIMATE_FIELDS:
        want = getattr(r.estimate, f)
        if isinstance(want, bool):
            assert getattr(p.estimate, f) == want, f
        else:
            assert getattr(p.estimate, f) == pytest.approx(want, rel=rel, abs=1e-9), f


def check_scenario(name, monkeypatch):
    """Every job and row of ``name`` against the reference's batched lane,
    and each MIKU job's per-tier decisions window by window; the port's
    rows."""
    ref_rows, rows, jobs = _run_both(name, monkeypatch)
    for job, r, p in jobs:
        _assert_job(job, r, p)
        for pd, rd in zip(p.decisions, r.decisions):
            assert pd.tiers == rd.tiers
            for t in rd.tiers:
                _assert_decision(pd.for_tier(t), rd.for_tier(t))
    assert len(rows) == len(ref_rows) > 0
    for r, p in zip(ref_rows, rows):
        assert list(p) == list(r)
        for key, want in r.items():
            if isinstance(want, float):
                assert p[key] == pytest.approx(want, rel=1e-6), key
                assert math.isfinite(p[key]), key
            else:
                assert p[key] == want, key
    return rows


def test_corun3_switch_matches_reference_batched_lane(monkeypatch):
    rows = check_scenario("corun3_switch", monkeypatch)
    assert len(rows) == 6  # 3 ops x MIKU off/on


def test_corun3_pertier_matches_reference_batched_lane(monkeypatch):
    rows = {r["law"]: r for r in check_scenario("corun3_pertier", monkeypatch)}
    # The merged law broadcasts one decision to both slow tiers; the
    # per-tier law decides each on its own.
    merged, pertier = rows["merged"], rows["pertier"]
    assert merged["cxl_mean_cap"] == merged["cxl_sw_mean_cap"]
    assert merged["cxl_restricted_windows"] == merged["cxl_sw_restricted_windows"] > 0
    assert pertier["cxl_mean_cap"] != pertier["cxl_sw_mean_cap"]
    assert rows["racing"]["cxl_restricted_windows"] == 0


def test_numa_remote_matches_reference_batched_lane(monkeypatch):
    rows = check_scenario("numa_remote", monkeypatch)
    assert [r["remote_inserts"] > 0 for r in rows] == [False, True, True]


@pytest.mark.parametrize("name", NEW_SCENARIOS)
def test_exact_regime_routes_the_reference_cells(name):
    ref_jobs = [j for _, _, js in ref_plan(name) for j in js]
    jobs = [j for _, _, js in plan(name) for j in js]
    assert len(jobs) == len(ref_jobs)
    want = [ref_exact_regime(ref_plan_cell(j)) for j in ref_jobs]
    assert [exact_regime(plan_cell(j)) for j in jobs] == want
    if name in ("corun3_switch", "corun3_pertier"):
        # Each tier's bw-test alone, the switched tier's included, is closed form.
        assert all(w is not None for i, w in enumerate(want) if i % 4 < 3)


@pytest.mark.parametrize("name", THREE_TIER)
def test_three_tier_platforms_match_reference(name):
    p, r = dm.PLATFORMS[name], ref_dm.PLATFORMS[name]
    assert p.tier_names == r.tier_names and len(p.tier_names) == 3
    for f in PLATFORM_FIELDS:
        assert getattr(p, f) == getattr(r, f), f
    for pd, rd in zip(p.tiers, r.tiers):
        for f in DEVICE_FIELDS:
            assert getattr(pd, f) == getattr(rd, f), f
        for op in OpClass:
            assert pd.peak_bandwidth_gbps(op) == rd.peak_bandwidth_gbps(RefOp(op.value))
    for dev, ref_dev in ((dm.CXL_SWITCH_DEVICE, ref_dm.CXL_SWITCH_DEVICE),
                         (dm.DDR_REMOTE_DIMM, ref_dm.DDR_REMOTE_DIMM)):
        assert [getattr(dev, f) for f in DEVICE_FIELDS] == \
            [getattr(ref_dev, f) for f in DEVICE_FIELDS]


def test_with_extra_tiers_appends_slow_tiers():
    p = dm.platform_a().with_extra_tiers(dm.CXL_SWITCH_DEVICE, dm.DDR_REMOTE_DIMM)
    r = ref_dm.platform_a().with_extra_tiers(ref_dm.CXL_SWITCH_DEVICE,
                                             ref_dm.DDR_REMOTE_DIMM)
    assert p.tier_names == r.tier_names == ("ddr", "cxl", "cxl_sw", "ddr_remote")
    assert p.device_for("ddr_remote").pipeline_ns == 165.0
    with pytest.raises(ValueError, match="duplicate tier names"):
        dm.platform_a().with_extra_tiers(dm.CXL_DEVICE)
    with pytest.raises(dm.UnknownTierError, match="ddr, cxl"):
        dm.platform_a().device_for("cxl_sw")


def _counters(rng, n):
    """``n`` seeded (port, reference) TierCounters pairs with equal counts."""
    out = []
    for _ in range(n):
        ins = int(rng.integers(0, 5000))
        occ = float(rng.uniform(0.0, 2e6))
        cls = [int(x) for x in rng.integers(0, 3000, len(OpClass))]
        out.append((TierCounters(ins, occ, {c: n for c, n in zip(OpClass, cls)}),
                    RefCounters(ins, occ, {RefOp(c.value): n for c, n in zip(OpClass, cls)})))
    return out


def _same_counters(p, r):
    assert p.inserts == r.inserts and p.occupancy_time == r.occupancy_time
    assert {c.value: n for c, n in p.class_counts.items()} == \
        {c.value: n for c, n in r.class_counts.items()}


@pytest.mark.parametrize("seed", range(4))
def test_merge_tier_counters_matches_reference(seed):
    pairs = _counters(np.random.default_rng(seed), 1 + seed)
    merged = merge_tier_counters([p for p, _ in pairs])
    _same_counters(merged, ref_merge([r for _, r in pairs]))
    assert merged is not pairs[0][0]  # a new counter; the inputs are untouched
    _same_counters(pairs[0][0], pairs[0][1])


def _merged_windows(rng, n_windows, n_tiers, port: bool):
    """A seeded sequence of per-tier windows: a fast tier and n_tiers - 1
    slow tiers whose residency drifts between calm and backlogged."""
    names = ["ddr", "cxl", "cxl_sw"][:n_tiers]
    Counters = TierCounters if port else RefCounters
    Op = OpClass if port else RefOp
    Window = TierWindow if port else RefWindow
    out = []
    for k in range(n_windows):
        tiers = []
        for t in range(n_tiers):
            ins = int(rng.integers(0 if t else 50, 800))
            res = rng.uniform(200, 900) if t == 0 else rng.uniform(300, 4000) * (1 + (k // 5) % 2)
            op = Op.STORE if rng.random() < 0.4 else Op.LOAD
            cc = {c: 0 for c in Op}
            cc[op] = ins
            tiers.append(Counters(ins, ins * float(res), cc))
        out.append(Window(tiers, names))
    return out


@pytest.mark.parametrize("name,seed", [(n, s) for n in THREE_TIER for s in (0, 1)])
def test_merged_slow_policy_matches_reference(name, seed):
    pol = merged_miku(dm.PLATFORMS[name])
    ref = ref_merged_miku(ref_dm.PLATFORMS[name])
    pw = _merged_windows(np.random.default_rng(seed), 40, 3, port=True)
    rw = _merged_windows(np.random.default_rng(seed), 40, 3, port=False)
    restricted = 0
    for a, b in zip(pw, rw):
        pd, rd = pol.window(a), ref.window(b)
        assert pd.tiers == rd.tiers == ("cxl", "cxl_sw")
        # One decision, broadcast to every slow tier.
        assert pd.decisions[0] is pd.decisions[1]
        for x, y in zip(pd.decisions, rd.decisions):
            _assert_decision(x, y, rel=1e-12)
        restricted += pd.restricted
    assert restricted > 0  # the seeded windows drive the ladder
    assert len(pol.decisions) == len(pol.law.decisions) == 40


def test_pair_window_and_two_argument_window(monkeypatch):
    pw = _merged_windows(np.random.default_rng(7), 12, 2, port=True)
    rw = _merged_windows(np.random.default_rng(7), 12, 2, port=False)
    a = merged_miku(dm.PLATFORMS["A"]).law
    b = merged_miku(dm.PLATFORMS["A"]).law
    r = ref_merged_miku(ref_dm.PLATFORMS["A"]).law
    monkeypatch.setattr(ctl.MikuController, "_warned_pair", False)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        a.window(pw[0][0], pw[0][1])
    b.pair_window(pw[0][0], pw[0][1])
    r.pair_window(rw[0][0], rw[0][1])
    for x, y in zip(pw[1:], rw[1:]):
        d = a.window(x[0], x[1])
        assert isinstance(d, ctl.Decision)
        _assert_decision(d, b.pair_window(x[0], x[1]), rel=0.0)
        _assert_decision(d, r.pair_window(y[0], y[1]), rel=1e-12)
    # One per-tier vector still answers with TierDecisions.
    assert isinstance(a.window(pw[0]), ctl.TierDecisions)
    with pytest.raises(TypeError, match="per-tier delta vector"):
        a.window(pw[0][0], pw[0][1], pw[0][1])


@pytest.mark.parametrize("name,g", [(n, g) for n in ("A", "B", *THREE_TIER) for g in (1, 4)])
def test_merged_miku_matches_reference(name, g):
    p = merged_miku(dm.PLATFORMS[name], g, slow_queue_markup=3.0)
    r = ref_merged_miku(ref_dm.PLATFORMS[name], g, slow_queue_markup=3.0)
    pe, re_ = p.law.units[0].estimator.config, r.law.units[0].estimator.config
    for f in ("t_fast", "slow_read_threshold", "write_threshold_scale", "ewma",
              "alpha_calm", "min_window_inserts", "min_slow_inserts"):
        assert getattr(pe, f) == getattr(re_, f), f
    assert {c.value: v for c, v in pe.t_fast_class_scale.items()} == \
        {c.value: v for c, v in re_.t_fast_class_scale.items()}
    pc, rc = p.law.units[0].config, r.law.units[0].config
    assert tuple(pc.levels) == tuple(rc.levels)
    assert {c.value: v for c, v in pc.class_caps.items()} == \
        {c.value: v for c, v in rc.class_caps.items()}


@pytest.mark.parametrize("law", ("pertier", "merged"))
def test_plan_cell_builds_the_reference_units(law):
    def job(Job, P, bw, Op):
        wls = [bw(t, Op("store"), 16, name=t, miku_managed=t != "ddr")
               for t in ("ddr", "cxl", "cxl_sw")]
        return Job(platform=P["A-switch"], workloads=wls, sim_ns=50_000.0, miku=True,
                   miku_law=law)

    p = plan_cell(job(SimJob, dm.PLATFORMS, bw_test, OpClass))
    r = ref_plan_cell(job(RefJob, ref_dm.PLATFORMS, ref_bw_test, RefOp))
    assert p.merged == r.merged == (law == "merged")
    assert len(p.units) == len(r.units) == (1 if law == "merged" else 2)
    for pu, ru in zip(p.units, r.units):
        assert pu.tier == ru.tier
        assert pu.estimator.config.slow_read_threshold == ru.estimator.config.slow_read_threshold
        assert pu.estimator.config.t_fast == ru.estimator.config.t_fast


@pytest.mark.parametrize("seed", range(4))
def test_export_of_ddr_remote_placement_matches_reference(seed):
    """_tier_fractions of a placement over ddr and ddr_remote (and the rest
    of the exported state) on A-numa, as the reference sim exports it."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(3):
        f = float(rng.choice([0.0, 0.25, 0.5, rng.uniform(0, 1)]))
        place = {"ddr": 1.0 - f, "ddr_remote": f}
        if i == 2:
            c = float(rng.uniform(0, 1 - f))
            place = {"ddr": 1.0 - f - c, "cxl": c, "ddr_remote": f}
        specs.append(dict(name=f"w{i}", tier="ddr", n_cores=int(rng.integers(1, 17)),
                          mlp=int(rng.choice([32, 160])), placement=place))
    op = ("load", "store", "nt_store")[seed % 3]
    port = [WorkloadSpec(op=OpClass(op), **s) for s in specs]
    ref = [RefWorkload(op=RefOp(op), **s) for s in specs]
    got = export_state(dm.PLATFORMS["A-numa"], port, granularity=4, window_ns=10_000.0)
    want = TieredMemorySim(ref_dm.PLATFORMS["A-numa"], ref, granularity=4,
                           window_ns=10_000.0).export_state()
    assert got["tier_names"] == ["ddr", "cxl", "ddr_remote"]
    for key, value in got.items():
        assert value == want[key], key


def test_peredge_law_is_still_refused():
    wls = [bw_test(t, OpClass.LOAD, 4, name=t) for t in ("ddr", "cxl")]
    job = SimJob(platform=dm.PLATFORMS["A"], workloads=wls, sim_ns=20_000.0, miku=True,
                 miku_law="peredge")
    assert "fabric" in can_batch(job)
    with pytest.raises(NotImplementedError, match="peredge"):
        run_sweep_batched([job], device="cpu")
    for law in ("pertier", "merged"):
        job = SimJob(platform=dm.PLATFORMS["A-switch"], workloads=wls, sim_ns=20_000.0,
                     miku=True, miku_law=law, record_windows=True)
        assert can_batch(job) is None


def test_decision_classes_expose_items():
    d = ctl.Decision(max_concurrency=2, rate_factor=0.5, phase=ctl.Phase.RESTRICTED)
    td = ctl.TierDecisions(tiers=("cxl", "cxl_sw"), decisions=(d, d))
    rd = ref_ctl.TierDecisions(
        tiers=("cxl", "cxl_sw"),
        decisions=(ref_ctl.Decision(2, 0.5, ref_ctl.Phase.RESTRICTED),) * 2)
    assert [t for t, _ in td.items()] == [t for t, _ in rd.items()]
    assert td.for_tier("cxl_sw") is d


def test_sweep_cli_runs_numa_remote_on_cpu(capsys):
    from repro_torch.launch.sweep import main

    main(["numa_remote", "--set", "remote_fraction=0.25", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("platform,op,remote_fraction,striped_alone_gbps")
    assert len(lines) == 2 and lines[1].startswith("A-numa,load,0.25,")


def test_unported_scenarios_name_what_they_wait_for():
    from repro.scenarios.registry import names as ref_names
    from repro_torch.scenarios.library import SCENARIOS, UNPORTED

    assert set(SCENARIOS).isdisjoint(UNPORTED)
    assert set(SCENARIOS) | set(UNPORTED) == set(ref_names())
    assert set(NEW_SCENARIOS) <= set(SCENARIOS)
    assert len(UNPORTED) == 5 and "fig2_tiering" in SCENARIOS
    waits = ("the fabric law", "open-loop arrivals")
    for name, reason in UNPORTED.items():
        assert any(w in reason for w in waits), (name, reason)
