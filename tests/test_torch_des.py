"""Port parity: the scalar DES (repro_torch.core.des.TieredMemorySim and
``run_sweep(lane="scalar")``) against the reference's on the CPU.

The DES is host Python that draws from ``random.Random(seed)`` in a fixed
order and sums floats in a fixed order, so the port must equal the
reference bit for bit: every job below is built in both packages from
their own SimJob, WorkloadSpec and platforms and run on both scalar lanes,
and every field of the two results is compared at tolerance 0.  The
pinned goldens (tests/data/seed_fig_goldens.json, miku_trace_des.json) are
held through the port's own runners, as tests/test_substrate.py holds the
reference's."""

import json
import os
from types import SimpleNamespace

import pytest

import repro.core.des as ref_des
import repro.core.device_model as ref_dm
import repro.core.littles_law as ref_ll
import repro.memsim.calibration as ref_cal
import repro.memsim.sweep as ref_sweep
import repro.memsim.workloads as ref_wl
import repro.tiering as ref_tiering
import repro_torch.core.des as des
import repro_torch.core.device_model as dm
import repro_torch.core.littles_law as ll
import repro_torch.memsim.calibration as cal
import repro_torch.memsim.sweep as sweep
import repro_torch.memsim.workloads as wl
import repro_torch.tiering as tiering
from repro_torch.core.controller import TierDecisions

DATA = os.path.join(os.path.dirname(__file__), "data")

REF = SimpleNamespace(des=ref_des, dm=ref_dm, Op=ref_ll.OpClass, cal=ref_cal,
                      sweep=ref_sweep, wl=ref_wl, tiering=ref_tiering)
PORT = SimpleNamespace(des=des, dm=dm, Op=ll.OpClass, cal=cal, sweep=sweep, wl=wl,
                       tiering=tiering)


def _tiering_spec(ns, policy):
    return ns.tiering.TieringSpec(
        regions=(ns.tiering.RegionSpec(
            workload="app", n_pages=256, placement={"cxl": 1.0},
            pattern=ns.tiering.HotSetPattern(hot_fraction=0.2, hot_weight=0.9,
                                             drift_pages=8.0)),),
        policy=policy, fast_capacity_pages=128)


def _case(ns, name):
    """One job of the parity grid, built from ``ns``'s own classes."""
    Op, w, P = ns.Op, ns.wl, ns.dm.PLATFORMS
    W = ns.des.WorkloadSpec

    def job(platform, workloads, sim_ns, **kw):
        return ns.sweep.SimJob(platform=P[platform], workloads=workloads, sim_ns=sim_ns,
                               **kw)

    def corun(op, **kw):
        return [w.bw_test("ddr", op, 16, name="ddr", miku_managed=False),
                w.bw_test("cxl", op, 16, name="cxl", **kw)]

    three = [w.bw_test("ddr", Op.LOAD, 8, name="ddr", miku_managed=False),
             w.bw_test("cxl", Op.LOAD, 8, name="cxl"),
             w.bw_test("cxl_sw", Op.LOAD, 8, name="sw")]
    app = [w.bw_test("ddr", Op.LOAD, 8, name="app")]
    return {
        "bw_ddr_load": lambda: job("A", [w.bw_test("ddr", Op.LOAD, 16)], 40_000.0),
        "bw_cxl_store": lambda: job("B", [w.bw_test("cxl", Op.STORE, 16)], 40_000.0),
        "lat_test": lambda: job("A", [w.lat_test("cxl", Op.LOAD, 2)], 40_000.0,
                                granularity=1),
        "lat_share": lambda: job("A", [w.lat_share(4)], 30_000.0, granularity=1),
        "corun_racing": lambda: job("A", corun(Op.LOAD), 50_000.0),
        "corun_miku_pertier": lambda: job("A", corun(Op.STORE), 60_000.0, miku=True),
        "switch_merged": lambda: job("A-switch", three, 50_000.0, miku=True,
                                     miku_law="merged"),
        "switch_pertier": lambda: job("A-switch", three, 50_000.0, miku=True),
        "numa_placement": lambda: job("A-numa", [
            W(name="striped", op=Op.LOAD, tier="ddr", n_cores=8, miku_managed=False,
              placement={"ddr": 0.5, "ddr_remote": 0.3, "cxl": 0.2}),
            w.bw_test("cxl", Op.LOAD, 8, name="cxl")], 40_000.0, miku=True),
        "llc_partition": lambda: job("A", [
            w.bw_test("ddr", Op.LOAD, 8, name="hit", wss_mb=64.0, llc_alloc_mb=16.0),
            w.bw_test("cxl", Op.LOAD, 8, name="cxl")], 40_000.0),
        "alternating_phases": lambda: job("A", w.alternating_bw_pair(Op.LOAD, 8, 15_000.0),
                                          50_000.0, miku=True),
        "record_windows_hist": lambda: job("A", corun(Op.LOAD), 50_000.0, miku=True,
                                           record_windows=True, latency_hist=True),
        "tiering_static": lambda: job("A", list(app), 50_000.0, record_windows=True,
                                      tiering=_tiering_spec(ns, "static")),
        "tiering_hotness_lru": lambda: job("A-switch", list(app), 60_000.0,
                                           record_windows=True,
                                           tiering=_tiering_spec(ns, "hotness_lru")),
        "tiering_miku_coordinated": lambda: job(
            "A", app + [w.bw_test("cxl", Op.LOAD, 8, name="cxl")], 60_000.0, miku=True,
            record_windows=True, tiering=_tiering_spec(ns, "miku_coordinated")),
        "granularity_1": lambda: job("A", corun(Op.NT_STORE), 20_000.0, granularity=1),
        "seed_0": lambda: job("A", corun(Op.LOAD, ddr_fraction=0.3), 30_000.0, seed=0),
        "seed_3": lambda: job("A", corun(Op.LOAD, ddr_fraction=0.3), 30_000.0, seed=3),
    }[name]()


CASES = ("bw_ddr_load", "bw_cxl_store", "lat_test", "lat_share", "corun_racing",
         "corun_miku_pertier", "switch_merged", "switch_pertier", "numa_placement",
         "llc_partition", "alternating_phases", "record_windows_hist", "tiering_static",
         "tiering_hotness_lru", "tiering_miku_coordinated", "granularity_1", "seed_0",
         "seed_3")


def _hist(h):
    return None if h is None else h.to_jsonable()


def _decision(d):
    """Per-tier (cap, rate, phase) of one decision, either package's."""
    if hasattr(d, "items") and hasattr(d, "tiers"):
        return {t: (x.max_concurrency, x.rate_factor, x.phase.value) for t, x in d.items()}
    return (d.max_concurrency, d.rate_factor, d.phase.value)


def assert_same_result(got, want):
    """Every field of two SimResults, at tolerance 0."""
    assert got.sim_ns == want.sim_ns
    assert list(got.stats) == list(want.stats)
    for name, g in got.stats.items():
        r = want.stats[name]
        assert (g.completed, g.bytes, g.latency_sum, g.latency_count) == \
            (r.completed, r.bytes, r.latency_sum, r.latency_count), name
        assert g.latency_samples == r.latency_samples, name
        assert g.timeline == r.timeline, name
        assert _hist(g.latency_hist) == _hist(r.latency_hist), name
    assert list(got.tier_counters) == list(want.tier_counters)
    for t, g in got.tier_counters.items():
        r = want.tier_counters[t]
        assert (g.inserts, g.occupancy_time) == (r.inserts, r.occupancy_time), t
        assert {c.value: n for c, n in g.class_counts.items()} == \
            {c.value: n for c, n in r.class_counts.items()}, t
    assert (got.tor_peak, got.tor_inserts, got.tor_occupancy_integral) == \
        (want.tor_peak, want.tor_inserts, want.tor_occupancy_integral)
    assert got.per_tier_occupancy_integral == want.per_tier_occupancy_integral
    assert [_decision(d) for d in got.decisions] == [_decision(d) for d in want.decisions]
    assert json.dumps(got.window_records, sort_keys=True) == \
        json.dumps(want.window_records, sort_keys=True)
    gh, rh = got.tier_latency_hist, want.tier_latency_hist
    assert (gh is None) == (rh is None)
    if gh is not None:
        assert {t: h.to_jsonable() for t, h in gh.items()} == \
            {t: h.to_jsonable() for t, h in rh.items()}
    assert got.tiering == want.tiering
    assert got.fabric == want.fabric
    assert got.arrival == want.arrival


@pytest.mark.parametrize("case", CASES)
def test_scalar_lane_equals_the_reference_bit_for_bit(case):
    (got,) = sweep.run_sweep([_case(PORT, case)], lane="scalar")
    (want,) = ref_sweep.run_sweep([_case(REF, case)], lane="scalar")
    assert_same_result(got, want)
    assert sum(s.completed for s in got.stats.values()) > 0
    if case.startswith("tiering") or case == "record_windows_hist":
        assert got.window_records
    if case.startswith("tiering"):
        assert got.tiering["policy"] == case[len("tiering_"):]
    if case in ("corun_miku_pertier", "switch_pertier", "tiering_miku_coordinated"):
        assert got.decisions and all(isinstance(d, TierDecisions) for d in got.decisions)


def test_tiering_hook_window_log_equals_the_reference():
    """The hook's own per-window log (the on_window pass), not only the
    records it is merged into."""
    logs = []
    for ns in (PORT, REF):
        job = _case(ns, "tiering_hotness_lru")
        hook = job.tiering.build()
        sim = ns.des.TieredMemorySim(job.platform, job.workloads, seed=job.seed,
                                     granularity=job.granularity, window_ns=job.window_ns,
                                     tiering=hook)
        res = sim.run(job.sim_ns)
        logs.append((hook.window_log, hook.summary(), res.tiering))
    assert json.dumps(logs[0], sort_keys=True) == json.dumps(logs[1], sort_keys=True)
    assert logs[0][1]["pages_promoted"] > 0


def test_profile_records_the_phases():
    job = _case(PORT, "corun_miku_pertier")
    job.profile = True
    (res,) = sweep.run_sweep([job], lane="scalar")
    phases = res.profile["phases"]
    assert set(phases) == {"setup", "event_loop", "window_pass"}
    assert phases["window_pass"]["calls"] == 6
    assert phases["window_pass"]["seconds"] <= phases["event_loop"]["seconds"]


# -- the pinned goldens --------------------------------------------------------


def test_fig_goldens_load_column():
    """seed_fig_goldens.json's fig3 load column and fig5 load, through the
    port's runners (tests/test_substrate.py::test_fig_goldens_unchanged_quick)."""
    with open(os.path.join(DATA, "seed_fig_goldens.json")) as f:
        gold = json.load(f)
    P = dm.platform_a()
    for row in gold["fig3"]:
        if row["op"] != "load":
            continue
        r = des.run_bw_test(P, op=ll.OpClass.LOAD, tier=row["tier"], n_threads=16,
                            sim_ns=120_000)
        assert r.bandwidth(f"bw-{row['tier']}-load") == pytest.approx(
            row["bandwidth_gbps"], rel=0.01)
    both = des.run_corun(P, op=ll.OpClass.LOAD, n_threads=16, sim_ns=300_000)
    g = gold["fig5"]["load"]
    assert both.bandwidth("ddr") == pytest.approx(g["ddr_gbps"], rel=0.01)
    assert both.bandwidth("cxl") == pytest.approx(g["cxl_gbps"], rel=0.01)
    assert both.tor_inserts == g["tor_inserts"]
    assert both.tor_peak == g["tor_peak"]


def test_live_des_reproduces_the_recorded_decisions():
    """miku_trace_des.json's decision sequence from the port's live co-run
    (tests/test_substrate.py::test_live_des_reproduces_recorded_decision_sequence)."""
    with open(os.path.join(DATA, "miku_trace_des.json")) as f:
        golden = [w["decision"] for w in json.load(f)["windows"]]
    P = dm.platform_a()
    res = des.run_corun(P, op=ll.OpClass.STORE, n_threads=16, sim_ns=400_000,
                        controller=cal.default_miku(P))
    assert len(res.decisions) == len(golden)
    for i, (d, g) in enumerate(zip(res.decisions, golden)):
        assert (d.max_concurrency, d.rate_factor, d.phase.value) == \
            (g["max_concurrency"], g["rate_factor"], g["phase"]), i


def test_lat_test_runner_equals_the_reference():
    got = des.run_lat_test(dm.platform_a(), op=ll.OpClass.LOAD, tier="cxl",
                           sim_ns=50_000.0)
    want = ref_des.run_lat_test(ref_dm.platform_a(), op=ref_ll.OpClass.LOAD, tier="cxl",
                                sim_ns=50_000.0)
    assert_same_result(got, want)


# -- the exported state ----------------------------------------------------------


@pytest.mark.parametrize("platform", ["A", "A-switch", "A-numa"])
def test_export_state_equals_the_sims_and_the_references(platform):
    """``TieredMemorySim(...).export_state()`` equals the port's
    ``export_state(...)`` (the batched lane's planning) and the reference
    sim's, with a tiering hook bound (and on A-numa a placement vector)."""
    def workloads(ns):
        wls = list(_case(ns, "tiering_miku_coordinated").workloads)
        if platform == "A-numa":
            wls += _case(ns, "numa_placement").workloads[:1]
        return wls

    exports = []
    for ns in (PORT, REF):
        sim = ns.des.TieredMemorySim(ns.dm.PLATFORMS[platform], workloads(ns), granularity=4,
                                     window_ns=10_000.0,
                                     tiering=_tiering_spec(ns, "miku_coordinated").build())
        exports.append(sim.export_state())
    port_fn = des.export_state(dm.PLATFORMS[platform], workloads(PORT), granularity=4,
                               window_ns=10_000.0,
                               tiering=_tiering_spec(PORT, "miku_coordinated").build())
    assert exports[0] == exports[1] == port_fn
    assert 0 in port_fn["w_effmlp"]  # the migration workloads gated closed
    assert port_fn["w_tier_frac"][0][0] == 0.0  # the region starts on CXL


def test_control_loop_records_and_polls():
    """The port's ControlLoop: records by default, calls ``on_window``, and
    ``poll`` fires every boundary passed; its existing users record
    nothing."""
    from repro_torch.core.offload import TransferQueue
    from repro_torch.core.substrate import ControlLoop

    class Clocked:
        now = 0.0
        clock_ns = property(lambda self: self.now)

        def counters_delta(self):
            return (ll.TierCounters(), ll.TierCounters())

        def apply(self, decision):
            pass

    class Counting:
        n = 0

        def window(self, fast, slow):
            self.n += 1
            return self.n

    seen = []
    sub = Clocked()
    loop = ControlLoop(sub, Counting(), window_ns=10.0, on_window=seen.append)
    sub.now = 35.0
    assert loop.due() and loop.poll() == [1, 2, 3]
    assert loop.next_window_ns == 40.0 and not loop.due()
    assert [r.index for r in loop.records] == [1, 2, 3] and seen == loop.records
    quiet = ControlLoop(sub, Counting(), window_ns=10.0, record=False)
    quiet.fire()
    assert quiet.records == [] and quiet.decisions == [1]
    queue = TransferQueue(controller=cal.default_miku(dm.platform_a()), window_ns=10.0)
    queue.control.fire()
    assert len(queue.control.decisions) == 1 and queue.control.records == []


def test_phase_flip_without_a_schedule_raises():
    sim = des.TieredMemorySim(dm.platform_a(), [wl.bw_test("ddr", ll.OpClass.LOAD, 1)])
    from repro_torch.core.invariants import InvariantViolation

    with pytest.raises(InvariantViolation, match="phase-schedule"):
        sim._phase_flip(0)
