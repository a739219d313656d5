"""Port parity: open-loop arrivals (repro_torch.workload and the DES's arrival
backlog) against the reference's (repro.workload and repro.core.des) on the
CPU.

The generators draw only from a ``random.Random`` seeded from (stream seed,
spec seed, kind), and the DES is deterministic host code, so the tolerance
is 0 throughout: every stream equals the reference's bit for bit, every
open-loop simulation (built in each package from its own classes) equals the
reference's field by field through tests/test_torch_des.py's
``assert_same_result`` (``SimResult.arrival`` and the window records'
arrival blocks included), the pinned tests/data/slo_knee_trace_goldens.json
windows re-simulate exactly, and ``slo_knee``'s and ``flash_crowd``'s rows
equal the reference's."""

import dataclasses
import json
import math
import os
from types import SimpleNamespace

import pytest

import repro.core.des as ref_des
import repro.core.device_model as ref_dm
import repro.core.littles_law as ref_ll
import repro.memsim.batched.lane as ref_lane
import repro.memsim.sweep as ref_sweep
import repro.memsim.workloads as ref_wl
import repro.workload as ref_workload
import repro_torch.core.des as des
import repro_torch.core.device_model as dm
import repro_torch.core.littles_law as ll
import repro_torch.memsim.batched.lane as lane
import repro_torch.memsim.sweep as sweep
import repro_torch.memsim.workloads as wl
import repro_torch.workload as workload
from repro.scenarios import run_scenario as ref_run_scenario
from repro_torch.core.substrate import ControlLoop
from repro_torch.memsim.calibration import default_miku
from repro_torch.scenarios import plan, run_scenario
from repro_torch.workload.arrivals import KINDS
from test_torch_des import assert_same_result
from test_torch_fabric import _error, _Replay, _same_rows

DATA = os.path.join(os.path.dirname(__file__), "data")

REF = SimpleNamespace(des=ref_des, dm=ref_dm, ll=ref_ll, sweep=ref_sweep, wl=ref_wl,
                      workload=ref_workload, lane=ref_lane)
PORT = SimpleNamespace(des=des, dm=dm, ll=ll, sweep=sweep, wl=wl, workload=workload,
                       lane=lane)

_SPECS = {  # kind -> ArrivalSpec keywords
    "poisson": dict(rate=0.01),
    "zipf": dict(rate=0.01, s=1.3, n_keys=64),
    "bursty": dict(rate=0.01, period_ns=5_000.0, duty=0.3),
    "diurnal": dict(rate=0.01, period_ns=40_000.0, amplitude=0.7),
    "flash_crowd": dict(rate=0.01, t_step_ns=20_000.0, surge=3.0, surge_ns=10_000.0),
}


def _spec(ns, kind, seed=0, **over):
    return ns.workload.ArrivalSpec(kind, seed=seed, **{**_SPECS[kind], **over})


# -- the spec and the generators ---------------------------------------------------

_BAD_SPECS = [
    dict(kind="weibull", rate=1.0),
    dict(kind="poisson"),
    dict(kind="poisson", rate=-1.0),
    dict(kind="zipf", rate=1.0, s=0.0),
    dict(kind="zipf", rate=1.0, n_keys=0),
    dict(kind="bursty", rate=1.0, duty=0.0),
    dict(kind="bursty", rate=1.0, duty=1.5),
    dict(kind="bursty", rate=1.0, period_ns=0.0),
    dict(kind="diurnal", rate=1.0, period_ns=-1.0),
    dict(kind="diurnal", rate=1.0, amplitude=1.0),
    dict(kind="flash_crowd", rate=1.0, t_step_ns=-1.0),
    dict(kind="flash_crowd", rate=1.0, surge=0.0),
    dict(kind="flash_crowd", rate=1.0, surge_ns=-1.0),
    dict(kind="trace"),
    dict(kind="poisson", rate=1.0, queue_limit=0),
]


@pytest.mark.parametrize("bad", _BAD_SPECS, ids=lambda b: "-".join(map(str, b.values())))
def test_spec_validation_equals_the_reference(bad):
    assert _error(lambda: workload.ArrivalSpec(**bad)) == \
        _error(lambda: ref_workload.ArrivalSpec(**bad))


def test_kinds_and_the_times_helper_equal_the_reference():
    from repro.workload.arrivals import KINDS as REF_KINDS

    assert KINDS == REF_KINDS
    spec = workload.ArrivalSpec("poisson", rate=0.01)
    assert _error(lambda: workload.arrival_times(spec)) == \
        _error(lambda: ref_workload.arrival_times(ref_workload.ArrivalSpec("poisson",
                                                                           rate=0.01)))


@pytest.mark.parametrize("kind", list(_SPECS))
@pytest.mark.parametrize("seed,stream", [(0, 0), (3, 17), (11, 1 << 20)])
def test_streams_equal_the_reference_bit_for_bit(kind, seed, stream):
    got = workload.arrival_times(_spec(PORT, kind, seed), stream_seed=stream, limit=400)
    want = ref_workload.arrival_times(_spec(REF, kind, seed), stream_seed=stream,
                                      limit=400)
    assert got == want and len(got) == 400
    assert all(t0 <= t1 for (t0, _), (t1, _) in zip(got, got[1:]))
    horizon = got[200][0]
    assert workload.arrival_times(_spec(PORT, kind, seed), stream_seed=stream,
                                  horizon_ns=horizon) == \
        ref_workload.arrival_times(_spec(REF, kind, seed), stream_seed=stream,
                                   horizon_ns=horizon)
    if kind == "zipf":
        assert all(0.0 <= k < 1.0 for _, k in got)
    else:
        assert all(k == -1.0 for _, k in got)


def test_a_different_seed_is_a_different_stream():
    a = workload.arrival_times(_spec(PORT, "poisson", 0), stream_seed=0, limit=32)
    assert a != workload.arrival_times(_spec(PORT, "poisson", 1), stream_seed=0, limit=32)
    assert a != workload.arrival_times(_spec(PORT, "poisson", 0), stream_seed=1, limit=32)


def _write(path, text):
    path.write_text(text)
    return str(path)


def test_trace_replay_equals_the_reference(tmp_path):
    path = _write(tmp_path / "arrivals.csv",
                  "# t_ns,key\n\n100.0\n250.5,0.25\n250.5,0.5\n# pause\n4000,0.0\n")
    got = workload.arrival_times(workload.ArrivalSpec("trace", path=path), limit=10)
    want = ref_workload.arrival_times(ref_workload.ArrivalSpec("trace", path=path),
                                      limit=10)
    assert got == want == [(100.0, -1.0), (250.5, 0.25), (250.5, 0.5), (4000.0, 0.0)]


@pytest.mark.parametrize("text", ["100\nabc\n", "300\n200\n", "1,x\n"])
def test_malformed_traces_are_rejected_as_the_reference_rejects_them(tmp_path, text):
    path = _write(tmp_path / "bad.csv", text)
    assert _error(lambda: workload.arrival_times(workload.ArrivalSpec("trace", path=path),
                                                 limit=10)) == \
        _error(lambda: ref_workload.arrival_times(ref_workload.ArrivalSpec("trace", path=path),
                                                  limit=10))


# -- open-loop simulations ----------------------------------------------------------


def _job(ns, case, trace_path=None):
    """One open-loop job of the parity grid, from ``ns``'s own classes."""
    Op, W, A = ns.ll.OpClass, ns.wl, ns.workload.ArrivalSpec
    J = ns.sweep.SimJob
    P = ns.dm.PLATFORMS

    def hog():
        return W.bw_test("cxl", Op.LOAD, 16, name="hog")

    return {
        "poisson_racing": lambda: J(
            platform=P["A"], workloads=[W.serve_test(4, arrival=A("poisson", rate=0.01)),
                                        hog()],
            sim_ns=60_000.0, record_windows=True, latency_hist=True),
        "poisson_miku_split": lambda: J(
            platform=P["A"],
            workloads=[W.serve_test(4, arrival=A("poisson", rate=0.02, seed=7),
                                    ddr_fraction=0.5), hog()],
            sim_ns=60_000.0, miku=True, record_windows=True, latency_hist=True),
        "zipf_keyed_placement": lambda: J(
            platform=P["A-numa"],
            workloads=[ns.des.WorkloadSpec(
                name="keyed", op=Op.LOAD, tier="ddr", n_cores=4, mlp=8,
                placement={"ddr": 0.5, "ddr_remote": 0.3, "cxl": 0.2},
                arrival=A("zipf", rate=0.02, s=1.2, n_keys=128, seed=3))],
            sim_ns=50_000.0, record_windows=True),
        "zipf_keyed_fraction": lambda: J(
            platform=P["A"],
            workloads=[W.serve_test(4, arrival=A("zipf", rate=0.02, n_keys=32),
                                    ddr_fraction=0.25), hog()],
            sim_ns=50_000.0, miku=True, seed=5),
        "bursty": lambda: J(
            platform=P["B"], workloads=[W.serve_test(8, arrival=A("bursty", rate=0.03,
                                                                  period_ns=8_000.0,
                                                                  duty=0.25))],
            sim_ns=50_000.0, record_windows=True),
        "diurnal_granularity_1": lambda: J(
            platform=P["A"], workloads=[W.serve_test(2, arrival=A("diurnal", rate=0.004,
                                                                  period_ns=30_000.0)),
                                        hog()],
            sim_ns=40_000.0, granularity=1),
        "flash_crowd_miku": lambda: J(
            platform=P["A"],
            workloads=[W.serve_test(4, arrival=A("flash_crowd", rate=0.004, seed=7,
                                                 t_step_ns=20_000.0, surge=6.0,
                                                 surge_ns=15_000.0), ddr_fraction=0.5),
                       hog()],
            sim_ns=60_000.0, miku=True, record_windows=True, latency_hist=True),
        "shed_at_queue_limit": lambda: J(
            platform=P["A"], workloads=[W.serve_test(1, arrival=A("poisson", rate=0.5,
                                                                  queue_limit=16), mlp=1),
                                        hog()],
            sim_ns=30_000.0, record_windows=True),
        "two_open_workloads": lambda: J(
            platform=P["A-switch"],
            workloads=[W.serve_test(2, name="a", arrival=A("poisson", rate=0.01)),
                       W.serve_test(2, name="b", arrival=A("poisson", rate=0.01)),
                       W.bw_test("cxl_sw", Op.LOAD, 8, name="sw")],
            sim_ns=40_000.0, miku=True, record_windows=True),
        "trace_driven": lambda: J(
            platform=P["A"], workloads=[W.serve_test(2, arrival=A("trace", path=trace_path),
                                                     ddr_fraction=0.5)],
            sim_ns=40_000.0, record_windows=True),
    }[case]()


CASES = ("poisson_racing", "poisson_miku_split", "zipf_keyed_placement",
         "zipf_keyed_fraction", "bursty", "diurnal_granularity_1", "flash_crowd_miku",
         "shed_at_queue_limit", "two_open_workloads", "trace_driven")


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    lines = [f"{i * 300.0 + (i % 7) * 11.0},{(i * 37 % 100) / 100.0}" for i in range(150)]
    path = tmp_path_factory.mktemp("trace") / "serve.csv"
    path.write_text("# generated arrivals\n" + "\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("case", CASES)
def test_open_loop_sims_equal_the_reference_bit_for_bit(case, trace_path):
    (got,) = sweep.run_sweep([_job(PORT, case, trace_path)], lane="scalar")
    (want,) = ref_sweep.run_sweep([_job(REF, case, trace_path)], lane="scalar")
    assert_same_result(got, want)
    assert got.arrival
    for name, a in got.arrival.items():
        assert a["generated"] == a["issued"] + a["shed"] + a["backlog"], name
        assert a["issued"] > 0, name
    if case == "shed_at_queue_limit":
        a = got.arrival["serve"]
        assert a["shed"] > 0 and a["backlog"] <= 16
    if got.window_records:
        blocks = [r["arrival"] for r in got.window_records if "arrival" in r]
        assert blocks and set(blocks[0]) == set(got.arrival)
        for name, a in got.arrival.items():
            assert sum(b[name]["generated"] for b in blocks) <= a["generated"]


def test_latency_runs_from_generation():
    """A backlogged request's latency includes its wait in the backlog, so
    an overloaded tenant's mean latency exceeds a light one's."""
    A = workload.ArrivalSpec
    light, heavy = (sweep.run_job(sweep.SimJob(
        platform=dm.platform_a(), workloads=[wl.serve_test(1, arrival=A("poisson", rate=r),
                                                           mlp=1)],
        sim_ns=30_000.0)) for r in (0.001, 0.2))
    assert heavy.arrival["serve"]["backlog"] > 0
    assert heavy.stats["serve"].mean_latency_ns() > 5 * light.stats["serve"].mean_latency_ns()


def test_closed_loop_jobs_have_no_arrival_block():
    job = sweep.SimJob(platform=dm.platform_a(),
                       workloads=[wl.bw_test("cxl", ll.OpClass.LOAD, 4, name="cxl")],
                       sim_ns=20_000.0, record_windows=True, miku=True)
    res = sweep.run_job(job)
    assert res.arrival is None
    assert all("arrival" not in r for r in res.window_records)


def test_des_rejects_a_non_spec_arrival_as_the_reference_does():
    got = _error(lambda: sweep.SimJob(
        platform=dm.platform_a(), sim_ns=1.0,
        workloads=[dataclasses.replace(wl.serve_test(2), arrival="poisson")]))
    want = _error(lambda: ref_sweep.SimJob(
        platform=ref_dm.platform_a(), sim_ns=1.0,
        workloads=[dataclasses.replace(ref_wl.serve_test(2), arrival="poisson")]))
    assert got == want


def test_serve_test_equals_the_reference():
    got = dataclasses.asdict(wl.serve_test(3, name="s", ddr_fraction=0.25, mlp=4,
                                           op=ll.OpClass.STORE))
    want = dataclasses.asdict(ref_wl.serve_test(3, name="s", ddr_fraction=0.25, mlp=4,
                                                op=ref_ll.OpClass.STORE))
    assert {k: getattr(v, "value", v) for k, v in got.items()} == \
        {k: getattr(v, "value", v) for k, v in want.items()}


# -- the batched lane's fallback --------------------------------------------------------


def test_batched_lane_falls_back_with_the_arrival_reason():
    jobs = [_job(PORT, "poisson_miku_split"),
            sweep.SimJob(platform=dm.platform_a(),
                         workloads=[wl.bw_test("ddr", ll.OpClass.LOAD, 4, name="ddr",
                                               miku_managed=False),
                                    wl.bw_test("cxl", ll.OpClass.LOAD, 4, name="cxl")],
                         sim_ns=40_000.0, miku=True)]
    ref_jobs = [_job(REF, "poisson_miku_split"),
                ref_sweep.SimJob(platform=ref_dm.platform_a(),
                                 workloads=[ref_wl.bw_test("ddr", ref_ll.OpClass.LOAD, 4,
                                                           name="ddr", miku_managed=False),
                                            ref_wl.bw_test("cxl", ref_ll.OpClass.LOAD, 4,
                                                           name="cxl")],
                                 sim_ns=40_000.0, miku=True)]
    assert [lane.can_batch(j) for j in jobs] == [ref_lane.can_batch(j) for j in ref_jobs] \
        == ["arrival", None]
    plans, fallbacks = lane.partition_jobs(jobs)
    assert fallbacks == ref_lane.partition_jobs(ref_jobs)[1] == [(0, "arrival")]
    assert plans[0] is None and plans[1] is not None
    batched = sweep.run_sweep(jobs, lane="batched", device="cpu")
    (scalar,) = sweep.run_sweep(jobs[:1], lane="scalar")
    assert_same_result(batched[0], scalar)


# -- the pinned golden and the scenarios ---------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "slo_knee_trace_goldens.json")) as f:
        return json.load(f)


def test_golden_slo_knee_windows_replayed_law_only(golden):
    names = tuple(golden["tier_names"])
    deltas = []
    for w in golden["windows"]:
        deltas.append(ll.TierWindow(tuple(
            ll.TierCounters(inserts=w["tiers"][t]["inserts"],
                            occupancy_time=w["tiers"][t]["occupancy_time"],
                            class_counts={ll.OpClass(k): v for k, v in
                                          w["tiers"][t]["class_counts"].items()})
            for t in names), names))
    loop = ControlLoop(_Replay(deltas), default_miku(dm.platform_a()), window_ns=1.0)
    for _ in deltas:
        loop.fire()
    assert len(loop.decisions) == len(golden["windows"])
    for d, w in zip(loop.decisions, golden["windows"]):
        g, dt = w["decision"]["cxl"], d.for_tier("cxl")
        assert (dt.max_concurrency, dt.rate_factor, dt.phase.value) == \
            (g["max_concurrency"], g["rate_factor"], g["phase"])


def test_golden_slo_knee_windows_resimulate_exactly(golden):
    """tests/test_workload.py's golden cell through the port's planner:
    every recorded window (tier counters, decisions, arrival blocks)."""
    ((_, _, (job,)),) = plan("slo_knee", {"placement": "cxl_heavy", "policy": "miku",
                                          "rate": 0.005})
    assert (job.window_ns, job.sim_ns) == (golden["window_ns"], golden["sim_ns"])
    res = sweep.run_job(dataclasses.replace(job, record_windows=True))
    got = [{k: v for k, v in r.items() if k != "latency_hist"} for r in res.window_records]
    assert json.loads(json.dumps(got)) == golden["windows"]
    assert all("arrival" in r for r in golden["windows"])


def test_slo_knee_rows_equal_the_reference():
    got = run_scenario("slo_knee", device="cpu").rows
    _same_rows(got, ref_run_scenario("slo_knee", {}).rows)
    assert len(got) == 20
    for r in got:
        assert r["generated"] == r["issued"] + r["shed"] + r["backlog"]

    def knee(placement, policy):
        blown = [r["rate_rpns"] for r in got if r["placement"] == placement
                 and r["policy"] == policy and r["budget_blown"]]
        return min(blown) if blown else math.inf

    assert knee("cxl_heavy", "racing") < knee("ddr", "racing")


def test_flash_crowd_rows_equal_the_reference():
    got = run_scenario("flash_crowd", device="cpu", lane="scalar").rows
    _same_rows(got, ref_run_scenario("flash_crowd", {}).rows)
    racing, miku = ({r["policy"]: r for r in got}[p] for p in ("racing", "miku"))
    assert miku["peak_queue_depth"] < racing["peak_queue_depth"]
    assert miku["backlog"] == 0 < racing["backlog"]


def test_hypothesis_streams_equal_the_reference():
    """A property over kinds and seeds: the port's stream is the
    reference's (no function-scoped fixture inside ``@given``)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(kind=st.sampled_from(sorted(_SPECS)), seed=st.integers(0, 2**31 - 1),
           stream=st.integers(0, 2**40))
    @settings(max_examples=25, deadline=None)
    def prop(kind, seed, stream):
        assert workload.arrival_times(_spec(PORT, kind, seed), stream_seed=stream,
                                      limit=64) == \
            ref_workload.arrival_times(_spec(REF, kind, seed), stream_seed=stream, limit=64)

    prop()
