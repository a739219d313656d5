"""Port parity: the control-plane surface the decision-law proofs use.

``ReplaySubstrate`` replays tests/data's four recorded counter traces
(miku_trace_des.json, miku_trace_tq.json and the two pertier_trace_*.json)
through the port's ``ControlLoop`` and ``default_miku`` / ``merged_miku``
and must reproduce every golden decision, as tests/test_substrate.py and
tests/test_pertier.py hold the reference to them.  Then the small pieces
against the reference on the same inputs: ``TierWindow``'s merge, zero,
merged_slow and pickling, ``growth_rate``, the metrics registry's snapshot
after one sequence of operations, the histogram's ``record``, the loop's
and the counters' ``reset``, ``SimResult.total_bandwidth`` and the
transfer queue's ``submit_slow`` / ``window_ns``."""

import json
import os
import pickle

import numpy as np
import pytest

import repro.core.controller as ref_ctl
import repro.core.des as ref_des
import repro.core.littles_law as ref_ll
import repro.core.offload as ref_offload
import repro.core.substrate as ref_sub
import repro.memsim.calibration as ref_cal
import repro.memsim.workloads as ref_wl
import repro.obs.histogram as ref_hist
import repro.obs.metrics as ref_metrics
from repro.core.device_model import platform_a as ref_platform_a
from repro.core.device_model import platform_a_switch as ref_platform_a_switch
from repro_torch.core import controller as ctl
from repro_torch.core import des
from repro_torch.core import littles_law as ll
from repro_torch.core import offload
from repro_torch.core import substrate as sub
from repro_torch.core.device_model import platform_a, platform_a_switch
from repro_torch.memsim import workloads as wl
from repro_torch.memsim.calibration import default_miku, merged_miku
from repro_torch.obs import histogram as hist
from repro_torch.obs import metrics

DATA = os.path.join(os.path.dirname(__file__), "data")


def _counters(d) -> ll.TierCounters:
    return ll.TierCounters(
        inserts=d["inserts"], occupancy_time=d["occupancy_time"],
        class_counts={ll.OpClass(k): v for k, v in d["class_counts"].items()})


def _load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def _replay(deltas, law):
    rs = sub.ReplaySubstrate(deltas)
    loop = sub.ControlLoop(rs, law, window_ns=1.0)
    while not rs.exhausted:
        loop.fire()
    assert rs.applied == loop.decisions  # apply() saw every decision, in order
    assert rs.clock_ns == len(deltas) == loop.windows_run
    return loop


def _same(d, g):
    return (d.max_concurrency, d.rate_factor, d.phase.value) == (
        g["max_concurrency"], g["rate_factor"], g["phase"])


@pytest.mark.parametrize("trace", ["miku_trace_des.json", "miku_trace_tq.json"])
def test_pair_trace_replays_to_its_golden_decisions(trace):
    windows = _load(trace)["windows"]
    deltas = [(_counters(w["fast"]), _counters(w["slow"])) for w in windows]
    loop = _replay(deltas, default_miku(platform_a()))
    assert len(loop.decisions) == len(windows)
    assert all(_same(d, w["decision"]) for d, w in zip(loop.decisions, windows))


@pytest.mark.parametrize("trace", ["miku_trace_des.json", "miku_trace_tq.json"])
def test_pair_trace_replays_through_the_vector_path(trace):
    """The same trace as two-tier TierWindows: one tier-addressed decision a
    window, the golden one (tests/test_pertier.py's pin, in the port)."""
    windows = _load(trace)["windows"]
    deltas = [ll.TierWindow((_counters(w["fast"]), _counters(w["slow"])), ("ddr", "cxl"))
              for w in windows]
    loop = _replay(deltas, default_miku(platform_a()))
    for d, w in zip(loop.decisions, windows):
        assert isinstance(d, ctl.TierDecisions) and d.tiers == ("cxl",)
        assert _same(d.for_tier("cxl"), w["decision"])


@pytest.mark.parametrize("law", ["pertier", "merged"])
def test_pertier_trace_replays_to_its_golden_decisions(law):
    blob = _load(f"pertier_trace_{law}.json")
    names = tuple(blob["tier_names"])
    deltas = [ll.TierWindow(tuple(_counters(w["tiers"][t]) for t in names), names)
              for w in blob["windows"]]
    build = default_miku if law == "pertier" else merged_miku
    loop = _replay(deltas, build(platform_a_switch()))
    assert len(loop.decisions) == len(blob["windows"])
    for d, w in zip(loop.decisions, blob["windows"]):
        assert d.tiers == names[1:]
        assert all(_same(d.for_tier(t), w["decision"][t]) for t in names[1:])


def test_live_corun_deltas_replay_to_its_live_decisions():
    """A live DES co-run's own window deltas, recorded, replayed through a
    fresh controller: the live decision sequence again."""
    wls = [wl.bw_test("ddr", ll.OpClass.STORE, 16, name="ddr", miku_managed=False),
           wl.bw_test("cxl", ll.OpClass.STORE, 16, name="cxl")]
    sim = des.TieredMemorySim(platform_a(), wls, seed=0, controller=default_miku(platform_a()),
                              window_ns=10_000.0, record_windows=True)
    res = sim.run(200_000.0)
    deltas = [rec.delta for rec in sim.control.records]
    assert len(deltas) == len(res.decisions) > 10
    loop = _replay(deltas, default_miku(platform_a()))
    assert [[(x.max_concurrency, x.rate_factor, x.phase) for x in d.decisions]
            for d in loop.decisions] == \
        [[(x.max_concurrency, x.rate_factor, x.phase) for x in d.decisions]
         for d in res.decisions]
    assert any(d.restricted for d in res.decisions)
    # reset() rewinds the loop and the law: a second replay is the first.
    first = [d.decisions for d in loop.decisions]
    loop.reset()
    assert loop.windows_run == 0 and loop.decisions == [] and loop.next_window_ns == 1.0
    loop.substrate = sub.ReplaySubstrate(deltas)
    while not loop.substrate.exhausted:
        loop.fire()
    assert [d.decisions for d in loop.decisions] == first


# -- the small pieces, against the reference ----------------------------------------


def _rand_counters(rng, L):
    return L.TierCounters(
        inserts=int(rng.integers(0, 500)), occupancy_time=float(rng.random() * 1e5),
        class_counts={c: int(rng.integers(0, 50)) for c in (L.OpClass.LOAD, L.OpClass.STORE,
                                                            L.OpClass.MIGRATE)})


def _tc(tc):
    counts = {c.value: n for c, n in tc.class_counts.items()}
    return (tc.inserts, tc.occupancy_time,
            [counts.get(v, 0) for v in ("load", "store", "nt_store", "migrate")])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tier_window_merge_zero_and_merged_slow(seed):
    names = ("ddr", "cxl", "cxl_sw")

    def windows(L):
        rng = np.random.default_rng(seed)
        return [L.TierWindow(tuple(_rand_counters(rng, L) for _ in names), names)
                for _ in range(2)]

    (a, b), (ra, rb) = windows(ll), windows(ref_ll)
    assert [_tc(t) for t in a.merge(b)] == [_tc(t) for t in ra.merge(rb)]
    assert _tc(a.merged_slow()) == _tc(ra.merged_slow())
    assert _tc(a.fast) == _tc(ra.fast) and a.slow_names == ra.slow_names == names[1:]
    z = ll.TierWindow.zero(names)
    assert [_tc(t) for t in a.merge(z)] == [_tc(t) for t in a]
    assert [_tc(t) for t in z] == [_tc(t) for t in ref_ll.TierWindow.zero(names)]
    with pytest.raises(ValueError, match="different tier sets"):
        a.merge(ll.TierWindow.zero(("ddr", "cxl")))
    back = pickle.loads(pickle.dumps(a))
    assert isinstance(back, ll.TierWindow) and back.names == names
    assert [_tc(t) for t in back] == [_tc(t) for t in a]
    assert ll.DEMAND_CLASSES == tuple(ll.OpClass(c.value) for c in ref_ll.DEMAND_CLASSES)


@pytest.mark.parametrize("series", [
    [10.0, 20.0, 40.0, 80.0], [50.0, 50.0, 50.0, 50.0, 50.0], [5.0, 0.0, 7.0],
    [100.0, 90.0, 70.0, 20.0, 10.0],
])
def test_growth_rate_equals_the_reference(series):
    est = ll.LittlesLawEstimator(ll.EstimatorConfig(t_fast=100.0, slow_read_threshold=300.0))
    ref = ref_ll.LittlesLawEstimator(ref_ll.EstimatorConfig(t_fast=100.0,
                                                            slow_read_threshold=300.0))
    for L, e in ((ll, est), (ref_ll, ref)):
        for t in series:
            e.history.append(L.TierEstimate(t_avg=t, alpha=0.5, t_slow=t, t_slow_raw=t,
                                            threshold=300.0, backlogged=False, valid=True))
    for n in (1, 2, 3):
        assert est.growth_rate(n) == ref.growth_rate(n)


def _registry_ops(m):
    reg = m.MetricsRegistry()
    reg.counter("a").inc()
    reg.counter("a").inc(2.5)
    reg.counter("b")
    reg.gauge("depth").set(7.0)
    reg.gauge("depth").set(3.0)
    for v in (10.0, 20.0, 35.0, 1000.0, 1e6):
        reg.histogram("lat").record(v)
    reg.histogram("empty")
    return reg


def test_metrics_snapshot_equals_the_reference():
    reg, ref = _registry_ops(metrics), _registry_ops(ref_metrics)
    got, want = reg.snapshot(), ref.snapshot()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert repr(reg.counter("a")) == repr(ref.counter("a"))
    assert repr(reg.gauge("depth")) == repr(ref.gauge("depth"))
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    prof = metrics.PhaseProfiler()
    with prof.phase("x"):
        pass
    with prof.phase("x"):
        pass
    assert prof.snapshot()["phases"]["x"]["calls"] == 2


def test_histogram_record_equals_the_reference():
    rng = np.random.default_rng(3)
    vals = rng.lognormal(5.0, 1.0, 300)
    h, r = hist.LatencyHistogram(), ref_hist.LatencyHistogram()
    assert repr(h) == repr(r) == "LatencyHistogram(empty)"
    for v in vals:
        h.record(float(v))
        r.record(float(v))
    assert h.counts == r.counts and h.n == r.n and h.total == r.total
    assert (h.vmin, h.vmax) == (r.vmin, r.vmax)
    assert repr(h) == repr(r)
    assert h == hist.LatencyHistogram.from_samples(list(vals))
    assert hash(h) != hash(hist.LatencyHistogram())


def test_counters_reset_and_merged_policy_reset():
    wc, tc = sub.WindowedCounters(), sub.TierSetWindowedCounters(("ddr", "cxl"))
    wc.fast.record(ll.OpClass.LOAD, 5.0)
    tc.tiers[1].record(ll.OpClass.STORE, 9.0)
    wc.reset()
    tc.reset()
    assert [x.inserts for x in wc.delta()] == [0, 0]
    assert [x.inserts for x in tc.delta()] == [0, 0]
    pol = merged_miku(platform_a_switch())
    names = ("ddr", "cxl", "cxl_sw")
    rng = np.random.default_rng(0)
    win = ll.TierWindow(tuple(_rand_counters(rng, ll) for _ in names), names)
    pol.window(win)
    pol.reset()
    assert pol.decisions == [] and pol.law.decisions == []
    law = default_miku(platform_a())
    ref_law = ref_cal.default_miku(ref_platform_a())
    assert law.config.levels == ref_law.config.levels
    assert law.estimator.config.t_fast == ref_law.estimator.config.t_fast
    assert isinstance(law.estimator, ll.LittlesLawEstimator)


def test_total_bandwidth_and_queue_members_equal_the_reference():
    def run(L, W, D, P):
        wls = [W.bw_test("ddr", L.OpClass.LOAD, 4, name="a"),
               W.bw_test("cxl", L.OpClass.STORE, 4, name="b")]
        return D.TieredMemorySim(P(), wls, seed=0).run(40_000.0)

    got = run(ll, wl, des, platform_a)
    want = run(ref_ll, ref_wl, ref_des, ref_platform_a)
    assert got.total_bandwidth() == want.total_bandwidth()
    assert got.total_bandwidth("cxl") == got.bandwidth("a") + got.bandwidth("b")
    q = offload.TransferQueue(window_ns=250_000.0)
    rq = ref_offload.TransferQueue(window_ns=250_000.0)
    assert q.window_ns == rq.window_ns == 250_000.0
    assert q.submit_slow(1 << 20) == rq.submit_slow(1 << 20)
    assert q.submit_slow(4096, ll.OpClass.NT_STORE) == \
        rq.submit_slow(4096, ref_ll.OpClass.NT_STORE)
    assert isinstance(ref_ctl.MikuController, type) and isinstance(ref_sub.ControlLoop, type)
