"""Port parity: the runtime sanitizer (repro_torch.analysis.sanitizer), its
DES and TransferQueue hooks, the batched lane's ``"sanitize"`` and
``"trace"`` fallbacks and the scenario registry, against the reference's
(repro.analysis, repro.scenarios.registry) on the CPU.

Each fault injection of tests/test_analysis.py corrupts a live simulation
at one window through ``DesSanitizer.add_mutation``, in both packages: the
violation raised must be the reference's (check, window, station, message),
and in record mode every violation of that window must be the one check
the fault targets.  Sanitized runs must equal the unsanitized ones bit for
bit, and their summaries the reference's, on jobs that drive each of the
DES's three issue scans, its hop stations and its arrival admission."""

import dataclasses
import os
from types import SimpleNamespace

import pytest

import repro.core.controller as ref_ctl
import repro.core.des as ref_des
import repro.core.device_model as ref_dm
import repro.core.littles_law as ref_ll
import repro.core.offload as ref_offload
import repro.core.tiers as ref_tiers
import repro.fabric as ref_fabric
import repro.memsim.batched.lane as ref_lane
import repro.memsim.sweep as ref_sweep
import repro.memsim.workloads as ref_wl
import repro.scenarios.registry as ref_registry
import repro.tiering as ref_tiering
import repro.workload as ref_workload
import repro_torch.core.controller as ctl
import repro_torch.core.des as des
import repro_torch.core.device_model as dm
import repro_torch.core.littles_law as ll
import repro_torch.core.offload as offload
import repro_torch.core.tiers as tiers
import repro_torch.fabric as fabric
import repro_torch.memsim.batched.lane as lane
import repro_torch.memsim.sweep as sweep
import repro_torch.memsim.workloads as wl
import repro_torch.scenarios.registry as registry
import repro_torch.tiering as tiering
import repro_torch.workload as workload
from repro.analysis import InvariantViolation as RefViolation
from repro.obs import TraceConfig as RefTraceConfig
from repro_torch.analysis import (
    DesSanitizer,
    InvariantViolation,
    QueueSanitizer,
    sanitize_enabled,
)
from repro_torch.launch import sweep as sweep_cli
from repro_torch.obs import TraceConfig
from repro_torch.scenarios import run_scenario
from test_torch_des import assert_same_result

REF = SimpleNamespace(des=ref_des, dm=ref_dm, ll=ref_ll, wl=ref_wl, fab=ref_fabric,
                      tiering=ref_tiering, sweep=ref_sweep, lane=ref_lane,
                      offload=ref_offload, workload=ref_workload, Violation=RefViolation,
                      ctl=ref_ctl, tiers=ref_tiers, TraceConfig=RefTraceConfig)
PORT = SimpleNamespace(des=des, dm=dm, ll=ll, wl=wl, fab=fabric, tiering=tiering,
                       sweep=sweep, lane=lane, offload=offload, workload=workload,
                       Violation=InvariantViolation, ctl=ctl, tiers=tiers,
                       TraceConfig=TraceConfig)


def _violation(v):
    return (v.check, v.window, v.station, str(v), v.context)


# -- fault injection -------------------------------------------------------------


def _tiering_hook(ns):
    spec = ns.tiering.TieringSpec(
        regions=(ns.tiering.RegionSpec(
            workload="app", n_pages=256, placement={"cxl": 1.0},
            pattern=ns.tiering.HotSetPattern(hot_fraction=0.25, hot_weight=0.9)),),
        fast_capacity_pages=128)
    return spec.build()


def _stall_cycle(s):
    u, v = s._link0, s._link0 + 1
    for st in (u, v):
        s._st_q[st].clear()
        s._st_busy[st] = 1
        s._hop_occ[st] = 1
        s._hop_stall[st].clear()
    # u's lone busy server waits on v and v's on u: a frozen cycle.
    s._hop_stall[u].append((1, v))
    s._hop_stall[v].append((2, u))


def _overflow(s):
    st = s._link0
    s._hop_occ[st] = s._hop_limit[st] + 1


#: fault -> (window, platform, check, mutation); the mutations are
#: tests/test_analysis.py's.
FAULTS = {
    "retire_miscount": (1, "A", "conservation",
                        lambda s: s._stat_completed.__setitem__(0, s._stat_completed[0] + 3)),
    "double_free": (1, "A", "free-list", lambda s: s._r_free.extend([123456, 123456])),
    "negative_tokens": (1, "A", "token-bucket", lambda s: s._tokens.__setitem__(0, -1.0)),
    "past_event": (1, "A", "event-order", lambda s: s._push(s.now - 5_000.0, 3, 0)),
    "counter_rollback": (2, "A", "counter-monotone", lambda s: s._tc_ins.__setitem__(1, 0)),
    "port_overflow": (1, "spine", "entry-limit", _overflow),
    "backpressure_cycle": (1, "spine", "stall-cycle", _stall_cycle),
    "negative_credit": (2, "tiering", "migrate-debt",
                        lambda s: s._tiering.engine._credit.__setitem__(1, -1)),
}


class _Stop(Exception):
    pass


def _mutated_sim(ns, fault, mode):
    window, where, _, mutation = FAULTS[fault]
    Op = ns.ll.OpClass
    if where == "tiering":
        sim = ns.des.TieredMemorySim(
            ns.dm.platform_a(),
            [ns.des.WorkloadSpec(name="app", op=Op.LOAD, tier="cxl", n_cores=8)],
            seed=0, sanitize=mode, tiering=_tiering_hook(ns))
    else:
        pm = ns.fab.spine_leaf_platform() if where == "spine" else ns.dm.platform_a()
        sim = ns.des.TieredMemorySim(pm, [ns.wl.bw_test("cxl", Op.LOAD, 8)], seed=0,
                                     sanitize=mode)
    sim._san.add_mutation(window, mutation)
    return sim


@pytest.mark.parametrize("fault", list(FAULTS))
def test_injected_fault_raises_the_reference_violation(fault):
    got = []
    for ns in (PORT, REF):
        sim = _mutated_sim(ns, fault, True)
        with pytest.raises(ns.Violation) as ei:
            sim.run(60_000.0)
        got.append(_violation(ei.value))
    assert got[0] == got[1]
    window, _, check, _ = FAULTS[fault]
    assert got[0][0] == check and got[0][1] == window
    if fault == "backpressure_cycle":
        assert got[0][4]["cycle"]
    if fault == "port_overflow":
        assert got[0][2] is not None


@pytest.mark.parametrize("fault", list(FAULTS))
def test_injected_fault_is_named_first_by_its_check(fault):
    """Record mode: the window the fault lands in records the reference's
    violations, the first of them from the check the fault targets, and no
    check runs ahead of it.  A fault can also break an identity a later
    check reads (a port pushed past its limit no longer holds queued +
    in service), as it does in the reference: check order is the API."""
    window, _, check, _ = FAULTS[fault]
    got = []
    for ns in (PORT, REF):
        sim = _mutated_sim(ns, fault, "record")

        def stop(s):
            raise _Stop

        sim._san.add_mutation(window + 1, stop)
        try:
            sim.run(60_000.0)
        except Exception:  # a corrupted sim may fail before the next window
            pass
        got.append([_violation(v) for v in sim._san.violations if v.window == window])
    assert got[0] == got[1]
    assert got[0] and got[0][0][0] == check
    order = ["event-order", "free-list", "conservation", "issue-accounting",
             "entry-limit", "station-occupancy", "counter-monotone",
             "arrival-conservation", "token-bucket", "migrate-debt", "stall-cycle"]
    assert all(order.index(v[0]) >= order.index(check) for v in got[0])


def test_phase_flip_without_schedule_is_structured():
    for ns in (PORT, REF):
        sim = ns.des.TieredMemorySim(ns.dm.platform_a(),
                                     [ns.wl.bw_test("cxl", ns.ll.OpClass.LOAD, 8)], seed=0)
        with pytest.raises(ns.Violation) as ei:
            sim._phase_flip(0)
        assert ei.value.check == "phase-schedule"


def test_record_mode_accumulates_and_completes():
    out = []
    for ns in (PORT, REF):
        sim = ns.des.TieredMemorySim(ns.dm.platform_a(),
                                     [ns.wl.bw_test("cxl", ns.ll.OpClass.LOAD, 8)], seed=0,
                                     sanitize="record")
        sim._san.add_mutation(1, lambda s: s._tokens.__setitem__(0, -1.0))
        out.append(sim.run(60_000.0).sanitizer)
    assert out[0] == out[1]
    assert out[0]["mode"] == "record"
    assert "token-bucket" in {v["check"] for v in out[0]["violations"]}
    assert out[0]["windows_checked"] >= 1


# -- the hooks and switches ----------------------------------------------------------


def test_counter_delta_hook_flags_negative_window_delta():
    san = DesSanitizer(2, mode="record")
    bad = SimpleNamespace(inserts=-1, occupancy_time=0.0)
    ok = SimpleNamespace(inserts=3, occupancy_time=1.0)
    san.check_counter_deltas(("ddr", "cxl"), (ok, bad))
    assert [v.check for v in san.violations] == ["counter-delta"]
    assert san.violations[0].station == "cxl"
    assert san.violations[0].to_dict()["station"] == "cxl"


def test_sanitizer_mode_validation():
    with pytest.raises(ValueError, match="unknown sanitizer mode"):
        DesSanitizer(2, mode="explode")


def test_sanitize_enabled_env_parsing(monkeypatch):
    from repro.core.invariants import sanitize_enabled as ref_enabled

    for val, want in (("", None), ("0", None), ("1", "raise"), ("record", "record"),
                      ("RECORD", "record"), ("yes", "raise")):
        monkeypatch.setenv("REPRO_SANITIZE", val)
        assert sanitize_enabled() == ref_enabled() == want
    monkeypatch.delenv("REPRO_SANITIZE")
    assert sanitize_enabled() is None


def test_violation_to_dict_equals_the_reference():
    args = ("conservation", "lost a request")
    kw = dict(window=3, station="cxl", context={"tor_used": 4})
    assert InvariantViolation(*args, **kw).to_dict() == RefViolation(*args, **kw).to_dict()


# -- clean runs: bit-equal, and the reference's summaries ----------------------------


def _flat(ns):
    Op = ns.ll.OpClass
    return ns.sweep.SimJob(platform=ns.dm.platform_a(),
                           workloads=[ns.wl.bw_test("ddr", Op.LOAD, 8),
                                      ns.wl.bw_test("cxl", Op.LOAD, 8)],
                           sim_ns=200_000.0)


def _miku(ns):
    Op = ns.ll.OpClass
    return ns.sweep.SimJob(
        platform=ns.dm.platform_a(),
        workloads=[ns.wl.bw_test("ddr", Op.STORE, 16, name="ddr", miku_managed=False),
                   ns.wl.bw_test("cxl", Op.STORE, 16, name="cxl")],
        sim_ns=150_000.0, miku=True, record_windows=True)


def _spine(ns):
    Op = ns.ll.OpClass
    return ns.sweep.SimJob(
        platform=ns.fab.spine_leaf_platform(),
        workloads=[ns.wl.bw_test("ddr", Op.LOAD, 16, name="ddr", miku_managed=False,
                                 host="host0"),
                   ns.wl.bw_test("cxl", Op.LOAD, 16, name="cxl0", host="host0"),
                   ns.wl.bw_test("cxl", Op.LOAD, 16, name="cxl1", host="host1")],
        sim_ns=80_000.0, miku=True, miku_law="peredge", record_windows=True)


def _open_loop(ns):
    A = ns.workload.ArrivalSpec
    Op = ns.ll.OpClass
    return ns.sweep.SimJob(
        platform=ns.dm.platform_a(),
        workloads=[ns.wl.serve_test(4, arrival=A("poisson", rate=0.02, seed=7),
                                    ddr_fraction=0.5),
                   ns.wl.bw_test("cxl", Op.LOAD, 16, name="hog")],
        sim_ns=60_000.0, miku=True, record_windows=True)


#: One job per path the hooks sit on: the flat co-run, a MIKU-throttled
#: co-run (token refills reissue through _fill_irq), the spine co-run (hop
#: stations, per-edge law) and an open-loop job (the arrival admission).
JOBS = {"flat": _flat, "miku": _miku, "spine": _spine, "open_loop": _open_loop}


@pytest.mark.parametrize("job", list(JOBS))
def test_sanitized_and_traced_runs_equal_the_plain_and_the_reference(job):
    plain = sweep.run_job(JOBS[job](PORT))
    on = {}
    for ns in (PORT, REF):
        on[ns is PORT] = ns.sweep.run_job(dataclasses.replace(
            JOBS[job](ns), sanitize=True, trace=ns.TraceConfig(sample_every=13, limit=40)))
    got, want = on[True], on[False]
    assert_same_result(got, plain)
    assert_same_result(got, want)
    assert got.sanitizer == want.sanitizer
    assert got.trace == want.trace
    assert got.sanitizer["violations"] == []
    assert got.sanitizer["windows_checked"] >= 5
    assert sum(got.sanitizer["retired"]) == sum(s.completed for s in got.stats.values())
    assert got.trace["n_traced"] > 0
    assert plain.sanitizer is None and plain.trace is None


def test_sanitized_run_is_bit_identical_and_clean():
    wls = [wl.bw_test("ddr", ll.OpClass.LOAD, 8), wl.bw_test("cxl", ll.OpClass.LOAD, 8)]
    plain = des.TieredMemorySim(dm.platform_a(), wls, seed=0).run(200_000.0)
    checked = des.TieredMemorySim(dm.platform_a(), wls, seed=0, sanitize=True).run(200_000.0)
    assert checked.sanitizer["violations"] == []
    assert checked.sanitizer["windows_checked"] >= 10
    assert_same_result(checked, plain)
    assert plain.sanitizer is None


def test_env_switch_sanitizes_a_default_sim(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "record")
    res = des.TieredMemorySim(dm.platform_a(), [wl.bw_test("cxl", ll.OpClass.LOAD, 8)],
                              seed=0).run(60_000.0)
    assert res.sanitizer["mode"] == "record" and res.sanitizer["violations"] == []
    off = des.TieredMemorySim(dm.platform_a(), [wl.bw_test("cxl", ll.OpClass.LOAD, 8)],
                              seed=0, sanitize=False).run(60_000.0)
    assert off.sanitizer is None


def test_simjob_sanitize_plumbs_to_result():
    job = sweep.SimJob(dm.platform_a(), [wl.bw_test("cxl", ll.OpClass.LOAD, 8)],
                       sim_ns=60_000.0, sanitize=True)
    res = sweep.run_job(job)
    assert res.sanitizer is not None
    assert res.sanitizer["violations"] == []
    assert sum(res.sanitizer["retired"]) > 0


# -- the batched lane's named fallbacks ------------------------------------------------


def _screen_jobs(ns):
    Op = ns.ll.OpClass
    A = ns.workload.ArrivalSpec
    base = ns.sweep.SimJob(ns.dm.platform_a(), [ns.wl.bw_test("cxl", Op.LOAD, 8)],
                           sim_ns=60_000.0)
    spine = ns.sweep.SimJob(ns.fab.spine_leaf_platform(),
                            [ns.wl.bw_test("cxl", Op.LOAD, 8)], sim_ns=60_000.0)
    open_wl = [ns.wl.serve_test(2, arrival=A("poisson", rate=0.01))]
    return {
        "plain": base,
        "sanitize": dataclasses.replace(base, sanitize=True),
        "sanitize_off": dataclasses.replace(base, sanitize=False),
        "trace": dataclasses.replace(base, trace=16),
        "hist": dataclasses.replace(base, latency_hist=True),
        "fabric_and_sanitize": dataclasses.replace(spine, sanitize=True),
        "sanitize_and_arrival": dataclasses.replace(base, workloads=open_wl, sanitize=True),
        "arrival_and_trace": dataclasses.replace(base, workloads=open_wl, trace=4),
    }


@pytest.mark.parametrize("env", [None, "1"])
def test_can_batch_reasons_and_their_order_equal_the_reference(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("REPRO_SANITIZE", env)
    got = {k: lane.can_batch(j) for k, j in _screen_jobs(PORT).items()}
    want = {k: ref_lane.can_batch(j) for k, j in _screen_jobs(REF).items()}
    assert got == want
    expect = {"plain": None, "sanitize": "sanitize", "sanitize_off": None, "trace": "trace",
              "hist": None, "fabric_and_sanitize": "fabric_topology",
              "sanitize_and_arrival": "sanitize", "arrival_and_trace": "arrival"}
    if env is not None:  # the switch sanitizes every job that does not opt out
        expect.update({k: "sanitize" for k, v in expect.items()
                       if k != "sanitize_off" and v != "fabric_topology"})
    assert got == expect


def test_batched_lane_runs_sanitized_and_traced_jobs_on_the_scalar_des(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    jobs = _screen_jobs(PORT)
    listed = [jobs["plain"], jobs["sanitize"], jobs["trace"]]
    got = sweep.run_sweep(listed, lane="batched", device="cpu")
    scalar = sweep.run_sweep(listed[1:], lane="scalar")
    for g, s in zip(got[1:], scalar):
        assert_same_result(g, s)
    assert got[1].sanitizer == scalar[0].sanitizer and got[1].sanitizer["violations"] == []
    assert got[2].trace == scalar[1].trace and got[2].trace["n_traced"] > 0
    assert got[0].sanitizer is None and got[0].trace is None


# -- the transfer queue --------------------------------------------------------------


def test_transfer_queue_sanitized_clean_run_equals_the_reference():
    out = []
    for ns in (PORT, REF):
        q = ns.offload.TransferQueue(sanitize=True)
        q.submit_slow_stream(1 << 20, 4)
        q.advance(10_000_000.0)
        out.append(q._san.summary())
    assert out[0] == out[1]
    assert out[0]["violations"] == [] and out[0]["submitted"] == {"slow": 4}
    assert out[0]["completed"] == {"slow": 4}


def test_transfer_queue_lost_transfer_trips_link_conservation():
    got = []
    for ns in (PORT, REF):
        q = ns.offload.TransferQueue(sanitize=True)
        q.submit_slow_stream(1 << 20, 4)
        q._inflight.pop()  # a transfer vanishes without completing
        with pytest.raises(ns.Violation) as ei:
            q.advance(10_000_000.0)
        got.append(_violation(ei.value))
    assert got[0] == got[1]
    assert got[0][0] == "link-conservation" and got[0][2] == "slow"


def test_queue_sanitizer_counter_delta_hook():
    san = QueueSanitizer(mode="record")
    bad = SimpleNamespace(inserts=0, occupancy_time=-2.0)
    san.check_counter_deltas(("fast", "slow"), (bad,))
    assert [v.check for v in san.violations] == ["counter-delta"]


def test_transfer_queue_extra_slow_links_equal_the_reference():
    """tests/test_pertier.py's two-link queue: per-link caps, backlogs and
    counters, sanitized."""
    out = []
    for ns in (PORT, REF):
        kind = {} if ns is PORT else {"memory_kind": "pinned_host"}
        far = ns.tiers.TierSpec(name="far_host", bandwidth_gbps=8.0, capacity_gib=512.0,
                                parallelism=4, **kind)
        q = ns.offload.TransferQueue(extra_slow=(far,), sanitize=True)
        c = ns.ctl
        q.apply(c.TierDecisions(
            tiers=("slow", "far_host"),
            decisions=(c.Decision(max_concurrency=None, rate_factor=1.0,
                                  phase=c.Phase.UNRESTRICTED),
                       c.Decision(max_concurrency=2, rate_factor=1.0,
                                  phase=c.Phase.RESTRICTED))))
        q.submit_slow_stream(1 << 20, 32, tier="slow")
        q.submit_slow_stream(1 << 20, 32, tier="far_host")
        row = [list(q.slow_tiers), q.slow_inflight("slow"), q.slow_inflight("far_host"),
               q.slow_backlog("slow"), q.slow_backlog("far_host"), q.slow_backlog()]
        q.advance(5e8)
        row += [q.counters["slow"].inserts, q.counters["far_host"].inserts,
                q.counters_delta().names, q._san.summary()]
        out.append(row)
    assert out[0] == out[1]
    assert out[0][1:3] == [32, 2] and out[0][3] > 0
    with pytest.raises(ValueError, match="duplicate slow tier"):
        offload.TransferQueue(extra_slow=(dataclasses.replace(tiers.HOST_TIER, name="fast"),))


# -- the registry and the CLI --------------------------------------------------------


@pytest.mark.parametrize("name", ["fabric_spine_congstion", "zzzzzz", "fig5corun",
                                  "corun_sweep_1K"])
def test_unknown_scenario_error_equals_the_reference(name):
    with pytest.raises(registry.UnknownScenarioError) as got:
        registry.get(name)
    with pytest.raises(ref_registry.UnknownScenarioError) as want:
        ref_registry.get(name)
    assert isinstance(got.value, KeyError)
    assert str(got.value) == str(want.value)
    assert got.value.suggestions == want.value.suggestions
    if name == "zzzzzz":
        assert got.value.suggestions == [] and "registered scenarios:" in str(got.value)
    if name == "fabric_spine_congstion":
        assert "fabric_spine_congestion" in got.value.suggestions
        assert "did you mean" in str(got.value)


def test_registry_lists_the_reference_scenarios_in_order():
    assert registry.names() == ref_registry.names()
    assert [sc.name for sc in registry.all_scenarios()] == registry.names()
    assert registry.get("fig5_corun").name == "fig5_corun"


def test_sweep_cli_unknown_scenario_exits_2(capsys):
    with pytest.raises(SystemExit) as ei:
        sweep_cli.main(["fabric_spine_congstion", "--device", "cpu"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "unknown scenario" in err and "fabric_spine_congestion" in err


def test_sweep_cli_sanitize_sets_the_switch(monkeypatch, capsys):
    # "0" is off; setting it makes monkeypatch restore the variable
    # after the CLI sets it to "1".
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    sweep_cli.main(["fig4_latency", "--set", "tier=cxl", "--set", "threads=2",
                    "--device", "cpu", "--sanitize"])
    assert os.environ["REPRO_SANITIZE"] == "1"
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(",")[:3] == ["platform", "tier", "threads"] and len(out) == 2


# -- every scenario stays clean one cell under the sanitizer --------------------------

_HEAVY = {"fig2_tiering", "fig10_miku", "fig11_llm"}


@pytest.mark.parametrize(
    "name",
    [pytest.param(n, marks=[pytest.mark.slow] if n in _HEAVY else [])
     for n in registry.names()],
)
def test_scenario_one_cell_sanitized(name, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    sc = registry.get(name)
    overrides = {a.name: a.default[0] for a in sc.axes if a.is_grid}
    if any(a.name == "sim_ns" for a in sc.axes):
        overrides["sim_ns"] = 60_000.0
    rows = run_scenario(name, overrides, device="cpu").rows
    assert rows  # a clean sanitized run produced its rows
