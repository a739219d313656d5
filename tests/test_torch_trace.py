"""Port parity: sampled request tracing (repro_torch.obs.trace), the
TransferQueue's chunk tracer, the serving cluster's ``timeline``, the
planner's ``perfetto=True`` and the sweep CLI's ``--perfetto``, against the
reference's (repro.obs, repro.serving, repro.scenarios, benchmarks/run.py)
on the CPU.

The DES samples every Nth ToR admission keyed on the insert count, so a
traced run draws nothing and equals the plain run bit for bit; its span
payload must equal the reference's.  The spine co-run's Chrome export must
equal tests/data/spine_perfetto_golden.json, which the reference's own
test pins."""

import dataclasses
import json
import math
import os
import sys
from types import SimpleNamespace

import pytest

import repro.core.device_model as ref_dm
import repro.core.littles_law as ref_ll
import repro.core.offload as ref_offload
import repro.memsim.batched.lane as ref_lane
import repro.memsim.sweep as ref_sweep
import repro.memsim.workloads as ref_wl
import repro.obs as ref_obs
import repro.scenarios as ref_scenarios
import repro_torch.core.device_model as dm
import repro_torch.core.littles_law as ll
import repro_torch.core.offload as offload
import repro_torch.memsim.batched.lane as lane
import repro_torch.memsim.sweep as sweep
import repro_torch.memsim.workloads as wl
import repro_torch.obs as obs
import repro_torch.scenarios as scenarios
from repro_torch.core.controller import Decision, Phase
from repro_torch.launch import sweep as sweep_cli
from repro_torch.serving.engine import Timeline
from test_torch_des import assert_same_result
from test_torch_serving import _miku, jeng, mk, teng

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "spine_perfetto_golden.json")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(dm=ref_dm, ll=ref_ll, wl=ref_wl, sweep=ref_sweep, obs=ref_obs,
                      offload=ref_offload, lane=ref_lane, scenarios=ref_scenarios)
PORT = SimpleNamespace(dm=dm, ll=ll, wl=wl, sweep=sweep, obs=obs, offload=offload,
                       lane=lane, scenarios=scenarios)


def _corun_job(ns, **over):
    Op = ns.ll.OpClass
    wls = [ns.wl.bw_test("ddr", Op.LOAD, 16, name="ddr", miku_managed=False),
           ns.wl.bw_test("cxl", Op.LOAD, 16, name="cxl")]
    return ns.sweep.SimJob(platform=ns.dm.platform_a(), workloads=wls, sim_ns=150_000.0,
                           miku=True, **over)


@pytest.fixture(scope="module")
def corun_runs():
    """tests/test_obs.py's MIKU co-run, plain and fully instrumented, in the
    port, and instrumented in the reference."""
    over = dict(trace=16, latency_hist=True, profile=True, record_windows=True)
    plain = sweep.run_job(_corun_job(PORT))
    instr = sweep.run_job(_corun_job(PORT, **over))
    ref = ref_sweep.run_job(_corun_job(REF, **over))
    return plain, instr, ref


def test_observability_is_bit_identical(corun_runs):
    plain, instr, _ = corun_runs
    for w in ("ddr", "cxl"):
        assert instr.stats[w].bytes == plain.stats[w].bytes
        assert instr.stats[w].completed == plain.stats[w].completed
        assert instr.stats[w].latency_sum == plain.stats[w].latency_sum
        assert instr.stats[w].latency_samples == plain.stats[w].latency_samples
    assert (instr.tor_inserts, instr.tor_peak) == (plain.tor_inserts, plain.tor_peak)
    assert [repr(d) for d in instr.decisions] == [repr(d) for d in plain.decisions]
    assert plain.trace is None and plain.profile is None
    assert instr.trace is not None and instr.profile is not None


def test_traced_run_equals_the_reference(corun_runs):
    _, instr, ref = corun_runs
    assert_same_result(instr, ref)
    assert instr.trace == ref.trace
    assert instr.trace["sample_every"] == 16 and instr.trace["limit"] == 512


def _check_span_conservation(rec, tol=1e-6):
    assert rec["t_issue"] <= rec["t_tor"] <= rec["t_retire"]
    spans = rec["spans"]
    assert spans, rec
    t = rec["t_issue"] if spans[0]["kind"] == "irq" else rec["t_tor"]
    for sp in spans:
        # A contiguous partition: each span starts where the last ended.
        assert sp["t0"] == pytest.approx(t, abs=tol), (sp, t)
        assert sp["t1"] >= sp["t0"]
        t = sp["t1"]
    assert t == pytest.approx(rec["t_retire"], abs=tol)
    # queue + service + stall + flight == the ToR residency.
    tor = sum(sp["t1"] - sp["t0"] for sp in spans if sp["kind"] != "irq")
    assert tor == pytest.approx(rec["t_retire"] - rec["t_tor"], abs=tol)


def test_trace_spans_conserve(corun_runs):
    _, instr, _ = corun_runs
    payload = instr.trace
    assert 0 < payload["n_traced"] <= payload["limit"]
    kinds = set()
    for rec in payload["requests"]:
        _check_span_conservation(rec)
        kinds.update(sp["kind"] for sp in rec["spans"])
    assert {"service", "flight"} <= kinds
    assert payload["n_traced"] + payload["n_in_flight"] + payload["n_dropped"] == \
        (instr.tor_inserts - 1) // 16 + 1


# -- the spine co-run and the pinned Perfetto export ---------------------------------


def _spine_job(ns):
    sc = ns.scenarios.get("fabric_spine_congestion")
    cell = {"op": ns.ll.OpClass.LOAD, "law": "peredge", "n_threads": 16,
            "spine_slots": 8, "spine_service_ns": 36.0, "sim_ns": 120_000.0}
    corun = sc.build(None, cell)[2]
    return dataclasses.replace(corun, trace=ns.obs.TraceConfig(sample_every=997, limit=64))


@pytest.fixture(scope="module")
def spine_traces():
    return sweep.run_job(_spine_job(PORT)).trace, ref_sweep.run_job(_spine_job(REF)).trace


def test_spine_trace_equals_the_reference(spine_traces):
    got, want = spine_traces
    assert got == want
    assert got["n_traced"] == got["limit"] == 64


def test_fabric_spans_show_hop_ports(spine_traces):
    stations = set()
    for rec in spine_traces[0]["requests"]:
        _check_span_conservation(rec)
        stations.update(sp["station"] for sp in rec["spans"]
                        if sp["kind"] in ("queue", "service", "stall"))
    assert any("uplink" in s or "spine" in s for s in stations), stations


def test_trace_is_deterministic(spine_traces):
    assert sweep.run_job(_spine_job(PORT)).trace == spine_traces[0]


def test_perfetto_golden(spine_traces):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert obs.to_chrome(spine_traces[0]["requests"]) == golden


def test_chrome_export_schema_equals_the_reference(spine_traces):
    recs = spine_traces[0]["requests"]
    doc = obs.to_chrome(recs)
    assert doc == ref_obs.to_chrome(recs)
    assert doc["displayTimeUnit"] == "ns"
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    procs = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "process_name"}
    assert procs == {r["workload"] for r in recs}


def test_des_counts_traced_requests(spine_traces):
    reg = obs.default_registry()
    before = reg.counter("des.traced_requests").value
    res = sweep.run_job(_spine_job(PORT))
    assert reg.counter("des.traced_requests").value == before + res.trace["n_traced"]


def test_limit_drops_are_counted_in_closed_form():
    """A limit of 3 at every 4th admission: the run stops admitting once
    the budget is spent, and the dropped count is the reference's."""
    got, want = (ns.sweep.run_job(_corun_job(ns, trace=ns.obs.TraceConfig(
        sample_every=4, limit=3))).trace for ns in (PORT, REF))
    assert got == want
    assert got["n_traced"] == 3 and got["n_dropped"] > 0


def test_hypothesis_trace_configs_equal_the_reference():
    """A property over sampling rates and limits on a short flat co-run (no
    function-scoped fixture inside ``@given``)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(every=st.integers(1, 400), limit=st.integers(1, 80))
    @settings(max_examples=8, deadline=None)
    def prop(every, limit):
        got, want = (ns.sweep.run_job(ns.sweep.SimJob(
            platform=ns.dm.platform_a(),
            workloads=[ns.wl.bw_test("ddr", ns.ll.OpClass.LOAD, 4),
                       ns.wl.bw_test("cxl", ns.ll.OpClass.STORE, 4)],
            sim_ns=30_000.0, trace=ns.obs.TraceConfig(sample_every=every, limit=limit)))
            for ns in (PORT, REF))
        assert got.trace == want.trace
        assert_same_result(got, want)

    prop()


# -- the lane's screen -------------------------------------------------------------


def test_traced_jobs_fall_back_to_scalar(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    for ns in (PORT, REF):
        assert ns.lane.can_batch(_corun_job(ns, trace=16)) == "trace"
        assert ns.lane.can_batch(_corun_job(ns, latency_hist=True)) is None


# -- the tracer's pieces -----------------------------------------------------------


def test_tracer_config_validation():
    with pytest.raises(ValueError):
        obs.TraceConfig(sample_every=0)
    with pytest.raises(ValueError):
        obs.TraceConfig(limit=0)
    with pytest.raises(ValueError):
        obs.TransferTracer(sample_every=0)
    tracer = obs.RequestTracer(obs.TraceConfig(limit=1), ["w"], ["st"], ["t"])
    tracer.admit(1, 0, 0, 0.0, 1.0)
    tracer.admit(2, 0, 0, 0.0, 1.0)  # over the limit: dropped
    tracer.retire(1, 5.0)
    assert len(tracer.done) == 1 and tracer.dropped == 1


def test_request_tracer_spans_equal_the_reference():
    """The same hook sequence (a stall, a queued hop, an unnamed station)
    finalizes into the reference's record."""
    out = []
    for ns in (PORT, REF):
        tr = ns.obs.RequestTracer(ns.obs.TraceConfig(sample_every=1, limit=4),
                                  ["w0", "w1"], ["ddr", "cxl", "llc", "uplink0"],
                                  ["ddr", "cxl"])
        tr.admit(7, 1, 1, 10.0, 25.0)
        tr.stall(7, 3, 25.0)
        tr.station_enter(7, 3, 40.0)
        tr.service_done(7, 3, 70.0, 12.0)
        tr.station_enter(7, 9, 70.0)
        tr.service_done(7, 9, 95.0, 25.0)
        tr.retire(7, 130.0)
        tr.retire(8, 140.0)  # never admitted: ignored
        out.append(tr.run_payload())
    assert out[0] == out[1]
    (rec,) = out[0]["requests"]
    _check_span_conservation(rec)
    assert [sp["kind"] for sp in rec["spans"]] == \
        ["irq", "stall", "queue", "service", "service", "flight"]


def test_transfer_tracer_respects_limit():
    tr = obs.TransferTracer(sample_every=1, limit=3)
    for i in range(10):
        tr.on_chunk("slow", float(i), float(i + 2), 1.0)
    assert len(tr.records) == 3 and tr.count == 10


def test_transfer_queue_trace_records_equal_the_reference():
    out = []
    for ns in (PORT, REF):
        q = ns.offload.TransferQueue(trace=1)
        q.submit_slow_stream(8 << 20, 8, ns.ll.OpClass.LOAD)
        q.advance(5e6)
        q4 = ns.offload.TransferQueue(trace=4)
        q4.submit_slow_stream(8 << 20, 8, ns.ll.OpClass.LOAD)
        out.append((q.trace_records, q4.trace_records))
    assert out[0] == out[1]
    recs, recs4 = out[0]
    assert len(recs) == 8 and len(recs4) == 2
    for rec in recs:
        _check_span_conservation(rec)
        assert rec["workload"] == "offload:slow"
    assert any(e["ph"] == "X" for e in obs.to_chrome(recs)["traceEvents"])
    assert offload.TransferQueue().trace_records == []


# -- the serving cluster: timeline, transfer traces, the queue's sanitizer ------------


@pytest.fixture(scope="module")
def clusters():
    """tests/test_torch_serving.py's MIKU cluster (the cap engages, so chunk
    enqueues are staggered), traced at 4 and built under REPRO_SANITIZE=1,
    in both packages."""
    out = {}
    saved = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        for port in (False, True):
            probe = mk("p", "host", 0, port=port).param_bytes
            mod = teng if port else jeng
            cl = mod.TieredServingCluster(
                [mk("d", "device", 12, port=port), mk("h", "host", 6, port=port)],
                controller=_miku(port, probe), window_ns=3e4, trace=4)
            out[port] = (cl.run(20000), cl, cl.queue)
    finally:
        if saved is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = saved
    return out


def test_cluster_timeline_and_transfer_traces_equal_the_reference(clusters):
    (got_res, got, gq), (want_res, want, wq) = clusters[True], clusters[False]
    assert got_res == want_res
    assert len(got.timeline) == len(want.timeline) > 100
    assert got.timeline == want.timeline
    assert list(got.timeline) == want.timeline
    assert gq.trace_records == wq.trace_records and len(gq.trace_records) > 0
    assert gq._san.summary() == wq._san.summary()
    assert gq._san.summary()["violations"] == []
    assert any(d.restricted for d in gq.decisions)


def test_cluster_timeline_records_every_tick(clusters):
    _, cl, q = clusters[True]
    tl = cl.timeline
    assert tl[0] == next(iter(tl)) and tl[-1] == list(tl)[-1]
    assert tl[10:13] == list(tl)[10:13]
    assert tl[-1]["t_ns"] == q.now
    assert all(a["t_ns"] < b["t_ns"] for a, b in zip(tl[:200], tl[1:200]))
    assert set(tl[5]) == {"t_ns", "slow_backlog", "tok_d", "tok_h"}
    with pytest.raises(IndexError):
        tl[len(tl)]


def test_timeline_expands_runs_by_the_clock_additions():
    tl = Timeline()
    tl.add_run(1.0, 0.1, 4, 2, {"a": 3})
    tl.add_run(5.0, 3.7, 1, 0, {"a": 4})
    t = [1.0, 1.0 + 0.1, 1.0 + 0.1 + 0.1, 1.0 + 0.1 + 0.1 + 0.1]
    assert [r["t_ns"] for r in tl] == t + [5.0]
    assert tl == [{"t_ns": x, "slow_backlog": 2.0, "tok_a": 3.0} for x in t] + \
        [{"t_ns": 5.0, "slow_backlog": 0.0, "tok_a": 4.0}]
    assert len(tl) == 5 and tl[4]["tok_a"] == 4.0 and tl != tl[:4]


def test_idle_advance_runs_equal_single_steps():
    """The runs ``idle_advance`` reports are the per-step backlogs that
    single ``advance`` calls give, under a cap that staggers enqueues."""
    def setup():
        q = offload.TransferQueue(controller=_miku(True, 1 << 20), window_ns=3e4)
        q.submit_slow_stream(1 << 20, 16)
        q.apply(Decision(max_concurrency=2, rate_factor=1.0, phase=Phase.RESTRICTED))
        q.submit_slow_stream(1 << 20, 16)
        return q

    a, b = setup(), setup()
    until = a.now + 150_000.5
    runs = []
    steps = a.idle_advance(1e3, until, 10**6, on_run=lambda *r: runs.append(r))
    tl = Timeline()
    for t0, n, backlog in runs:
        tl.add_run(t0, 1e3, n, backlog, {})
    want = []
    while b.now < until:
        b.advance(1e3)
        want.append({"t_ns": b.now, "slow_backlog": float(b.slow_backlog())})
    assert steps == len(want) and tl == want
    assert len({r["slow_backlog"] for r in want}) > 2
    assert a.idle_advance(1e3, math.inf, 7) == 7


# -- the planner and the CLI --------------------------------------------------------


def test_planner_perfetto_collects_the_reference_traces():
    over = {"platform": "A", "tier": ("cxl",), "threads": (4,)}
    got = scenarios.run_scenario("fig4_latency", over, device="cpu", perfetto=True)
    rows, req = got.rows, got.request_traces
    table = ref_scenarios.run_scenario("fig4_latency", over, perfetto=True)
    assert rows == table.rows
    assert json.loads(json.dumps(req)) == json.loads(json.dumps(table.request_traces))
    payload = req[0]["jobs"][0]["trace"]
    assert payload["n_traced"] > 0 and payload["sample_every"] == 16


def test_planner_trace_and_perfetto_together():
    over = {"platform": "A", "tier": ("ddr",), "threads": (2,)}
    got = scenarios.run_scenario("fig4_latency", over, device="cpu", trace=True,
                                 perfetto=True)
    rows, traces, req = got.rows, got.traces, got.request_traces
    assert len(rows) == len(traces) == len(req) == 1
    assert "windows" in traces[0]["jobs"][0] and "trace" in req[0]["jobs"][0]


def test_planner_perfetto_rejects_run_cell():
    with pytest.raises(ValueError, match="run_cell"):
        scenarios.run_scenario("fig2_tiering", device="cpu", perfetto=True)


def test_sweep_cli_perfetto_equals_the_reference_export(tmp_path, monkeypatch, capsys):
    """``--perfetto NAME`` writes what benchmarks/run.py's ``--perfetto``
    writes for the same scenario, sanitized."""
    sys.path.insert(0, REPO)
    try:
        from benchmarks.run import _write_perfetto
    finally:
        sys.path.remove(REPO)
    monkeypatch.chdir(tmp_path)
    # "0" is off; setting it makes monkeypatch restore the variable
    # after the CLI sets it to "1".
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    args = ["fabric_spine_congestion", "--set", "law=racing", "--set", "sim_ns=60000",
            "--device", "cpu", "--sanitize", "--perfetto", "port"]
    sweep_cli.main(args)
    assert os.environ["REPRO_SANITIZE"] == "1"
    assert "wrote port.perfetto.json" in capsys.readouterr().err
    over = ref_scenarios.parse_set_args("fabric_spine_congestion",
                                        ["law=racing", "sim_ns=60000"])
    _write_perfetto(ref_scenarios.run_scenario("fabric_spine_congestion", over,
                                               perfetto=True), "ref")
    with open("port.perfetto.json") as f:
        got = json.load(f)
    with open("ref.perfetto.json") as f:
        want = json.load(f)
    assert got == want
    assert {e["args"]["name"] for e in got["traceEvents"] if e["name"] == "process_name"} \
        >= {"cell0/job2/cxl0"}


def test_sweep_cli_perfetto_with_no_spans_writes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert sweep_cli.write_perfetto([{"cell": {}, "jobs": [{"job": 0, "trace": None}]}],
                                    "none") == ""
    assert not os.path.exists("none.perfetto.json")
