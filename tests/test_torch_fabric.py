"""Port parity: the routed fabric (repro_torch.fabric, the DES's hop stations
and ``control_scope="edge"``) against the reference's (repro.fabric and
repro.core.des) on the CPU.

Everything here is deterministic host code, so the tolerance is 0: the
topologies, routes and edge schedules are compared by value, the errors by
type and message, the per-edge controllers' calibration field by field, and
every simulation (built in each package from its own classes) field by field
through tests/test_torch_des.py's ``assert_same_result``, which covers the
``fabric`` summary, the decisions and the window records.  The pinned trace
tests/data/fabric_trace_goldens.json is reproduced replayed law-only and
re-simulated live, as tests/test_fabric.py does for the reference."""

import dataclasses
import json
import math
import os
from types import SimpleNamespace

import pytest

import repro.core.des as ref_des
import repro.core.device_model as ref_dm
import repro.core.littles_law as ref_ll
import repro.fabric as ref_fabric
import repro.memsim.batched.lane as ref_lane
import repro.memsim.calibration as ref_cal
import repro.memsim.sweep as ref_sweep
import repro.memsim.workloads as ref_wl
import repro_torch.core.des as des
import repro_torch.core.device_model as dm
import repro_torch.core.littles_law as ll
import repro_torch.fabric as fabric
import repro_torch.memsim.batched.lane as lane
import repro_torch.memsim.calibration as cal
import repro_torch.memsim.sweep as sweep
import repro_torch.memsim.workloads as wl
from repro.scenarios import run_scenario as ref_run_scenario
from repro_torch.core.controller import TierDecisions
from repro_torch.core.substrate import ControlLoop
from repro_torch.scenarios import run_scenario
from test_torch_des import assert_same_result

DATA = os.path.join(os.path.dirname(__file__), "data")

REF = SimpleNamespace(des=ref_des, dm=ref_dm, ll=ref_ll, fab=ref_fabric, cal=ref_cal,
                      sweep=ref_sweep, wl=ref_wl, lane=ref_lane)
PORT = SimpleNamespace(des=des, dm=dm, ll=ll, fab=fabric, cal=cal, sweep=sweep, wl=wl,
                       lane=lane)
TIERS = ("ddr", "cxl")


# -- topology ---------------------------------------------------------------------


def _topologies(ns):
    f = ns.fab
    return {
        "direct": lambda: f.direct(TIERS),
        "direct_three": lambda: f.direct(("ddr", "cxl", "cxl_sw"), host="h"),
        "single_switch": lambda: f.single_switch(TIERS, routed=("cxl",), port_slots=8,
                                                 service_ns=36.0, queue_entries=1024),
        "single_switch_all": lambda: f.single_switch(TIERS, routed=TIERS, port_slots=2,
                                                     service_ns=10.0, queue_entries=64,
                                                     switch="swX"),
        "spine_leaf": lambda: f.spine_leaf(TIERS, routed=("cxl",)),
        "spine_leaf_asym": lambda: f.spine_leaf(TIERS, routed=("cxl",), n_hosts=3,
                                                uplink_slots=(16, 4, 8),
                                                uplink_service_ns=(18.0, 36.0, 18.0),
                                                uplink_queue=(1024, 256, 512)),
        "custom_tie": lambda: f.FabricTopology(
            hosts=("h0",), devices=("cxl",), switches=("a", "b"),
            links=(f.Link("h0-a", "h0", "a"), f.Link("h0-b", "h0", "b"),
                   f.Link("a-cxl", "a", "cxl", port_slots=2, service_ns=5.0,
                          queue_entries=8),
                   f.Link("b-cxl", "b", "cxl", port_slots=4, service_ns=5.0,
                          queue_entries=8))),
    }


def _link(link):
    return dataclasses.astuple(link)


def _topology_value(topo):
    """Every field, every resolved route and both derived queries."""
    return {
        "hosts": topo.hosts, "devices": topo.devices, "switches": topo.switches,
        "links": [_link(x) for x in topo.links],
        "station_links": [_link(x) for x in topo.station_links],
        "has_hops": topo.has_hops,
        "routes": {
            (h, d): ([_link(x) for x in topo.route(h, d).links],
                     [x.name for x in topo.route(h, d).hops], topo.route(h, d).nodes)
            for h in topo.hosts for d in topo.devices
        },
    }


@pytest.mark.parametrize("name", list(_topologies(PORT)))
def test_topologies_and_routes_equal_the_reference(name):
    got, want = _topologies(PORT)[name](), _topologies(REF)[name]()
    assert _topology_value(got) == _topology_value(want)
    routes = {k: ([_link(x) for x in r.links], r.hops == tuple(r.links))
              for k, r in fabric.resolve_routes(got).items()}
    assert routes == {k: ([_link(x) for x in r.links], r.hops == tuple(r.links))
                      for k, r in ref_fabric.resolve_routes(want).items()}


def test_custom_topology_breaks_ties_by_declaration_order():
    topo = _topologies(PORT)["custom_tie"]()
    assert [x.name for x in topo.route("h0", "cxl").links] == ["h0-a", "a-cxl"]
    assert fabric.Route("h", "t").nodes == ("h", "t")


def _bad_topologies(ns):
    f = ns.fab
    L = f.Link
    return {
        "zero_capacity_port": lambda: f.FabricTopology(
            hosts=("host0",), devices=("cxl",),
            links=(L("bad", "host0", "cxl", port_slots=4, service_ns=0.0,
                     queue_entries=0),)),
        "unreachable": lambda: f.FabricTopology(
            hosts=("host0",), devices=("ddr", "cxl"), switches=("sw0",),
            links=(L("host0-ddr", "host0", "ddr"), L("sw0-cxl", "sw0", "cxl"))),
        "cycle": lambda: f.FabricTopology(
            hosts=("host0",), devices=("cxl",), switches=("sw0", "sw1"),
            links=(L("in", "host0", "sw0"), L("a", "sw0", "sw1"), L("b", "sw1", "sw0"),
                   L("out", "sw0", "cxl"))),
        "duplicate_node": lambda: f.FabricTopology(
            hosts=("host0", "host0"), devices=("cxl",), links=(L("l", "host0", "cxl"),)),
        "dangling": lambda: f.FabricTopology(
            hosts=("host0",), devices=("cxl",), links=(L("l", "host0", "nowhere"),)),
        "duplicate_link": lambda: f.FabricTopology(
            hosts=("host0",), devices=("cxl",),
            links=(L("l", "host0", "cxl"), L("l", "host0", "cxl"))),
        "no_hosts": lambda: f.FabricTopology(hosts=(), devices=("cxl",)),
        "no_devices": lambda: f.FabricTopology(hosts=("host0",), devices=()),
        "leaves_device": lambda: f.FabricTopology(
            hosts=("host0",), devices=("cxl", "ddr"),
            links=(L("a", "host0", "cxl"), L("b", "cxl", "ddr"))),
        "enters_host": lambda: f.FabricTopology(
            hosts=("host0", "host1"), devices=("cxl",),
            links=(L("a", "host0", "host1"), L("b", "host0", "cxl"),
                   L("c", "host1", "cxl"))),
        "routed_not_a_tier": lambda: f.single_switch(TIERS, routed=("pmem",), port_slots=1,
                                                     service_ns=1.0, queue_entries=1),
        "spine_routed_not_a_tier": lambda: f.spine_leaf(TIERS, routed=("pmem",)),
        "per_host_length": lambda: f.spine_leaf(TIERS, routed=("cxl",), n_hosts=2,
                                                uplink_slots=(1, 2, 3)),
        "unknown_fabric_host": lambda: f.spine_leaf(TIERS, routed=("cxl",)).route(
            "host9", "cxl"),
        "unknown_fabric_device": lambda: f.spine_leaf(TIERS, routed=("cxl",)).route(
            "host0", "pmem"),
    }


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


@pytest.mark.parametrize("case", list(_bad_topologies(PORT)))
def test_topology_errors_equal_the_reference(case):
    got = _error(_bad_topologies(PORT)[case])
    assert got == _error(_bad_topologies(REF)[case])
    want_type = ("UnknownTierError" if case.startswith("unknown") else "TopologyError")
    assert got[0] == want_type


def _workload_errors(ns):
    spine = ns.fab.spine_leaf_platform()
    return {
        "unknown_host": lambda: ns.des.validate_workloads(
            spine, [ns.wl.bw_test("cxl", ns.ll.OpClass.LOAD, 2, host="host7")]),
        "host_without_fabric": lambda: ns.des.validate_workloads(
            ns.dm.platform_a(), [ns.wl.bw_test("cxl", ns.ll.OpClass.LOAD, 2, host="host0")]),
        "job_unknown_host": lambda: ns.sweep.SimJob(
            platform=spine, workloads=[dataclasses.replace(ns.wl.lat_test("cxl"),
                                                           host="host2")],
            sim_ns=1.0),
        "bad_control_scope": lambda: ns.des.TieredMemorySim(
            spine, [ns.wl.bw_test("cxl", ns.ll.OpClass.LOAD, 2)], control_scope="link"),
    }


@pytest.mark.parametrize("case", list(_workload_errors(PORT)))
def test_workload_host_checks_equal_the_reference(case):
    assert _error(_workload_errors(PORT)[case]) == _error(_workload_errors(REF)[case])


def test_validate_workloads_accepts_the_hosts_of_the_topology():
    pm = fabric.spine_leaf_platform()
    for host in (None, "host0", "host1"):
        des.validate_workloads(pm, [wl.bw_test("cxl", ll.OpClass.LOAD, 2, host=host)])


# -- platforms and per-edge control ------------------------------------------------


def _platforms(ns):
    f = ns.fab
    return {
        "A": lambda: ns.dm.platform_a(),
        "A-direct": lambda: ns.dm.PLATFORMS["A-direct"],
        "A-spine": lambda: ns.dm.PLATFORMS["A-spine"],
        "B-direct": lambda: f.direct_platform("B"),
        "A-switch-direct": lambda: f.direct_platform("A-switch"),
        "single_switch": lambda: f.single_switch_platform(port_queue=64),
        "spine_asym": lambda: f.spine_leaf_platform(uplink_slots=(16, 4),
                                                    uplink_service_ns=(18.0, 36.0),
                                                    spine_slots=14, spine_service_ns=18.0),
    }


def _plain(v):
    """A config field with OpClass keys read by value."""
    return {k.value: x for k, x in v.items()} if isinstance(v, dict) else v


def _miku_value(ctl):
    """Each control edge's ladder levels, class caps and estimator fields."""
    return ([(tuple(c.levels), _plain(c.class_caps)) for c in ctl._configs],
            [{k: _plain(v) for k, v in dataclasses.asdict(e).items()}
             for e in ctl._est_configs])


@pytest.mark.parametrize("name", list(_platforms(PORT)))
def test_platforms_edges_and_peredge_miku_equal_the_reference(name):
    got, want = _platforms(PORT)[name](), _platforms(REF)[name]()
    assert got.name == want.name and got.tier_names == want.tier_names
    assert (got.fabric is None) == (want.fabric is None)
    if got.fabric is not None:
        assert _topology_value(got.fabric) == _topology_value(want.fabric)
    assert fabric.edge_names(got) == ref_fabric.edge_names(want)
    for g in (4, 1):
        assert _miku_value(fabric.peredge_miku(got, g)) == \
            _miku_value(ref_fabric.peredge_miku(want, g))
    over = dict(slow_queue_markup=2.0, ewma=0.25)
    assert _miku_value(fabric.peredge_miku(got, 4, **over)) == \
        _miku_value(ref_fabric.peredge_miku(want, 4, **over))


def test_fabric_platforms_are_registered_on_import():
    assert {"A-direct", "A-spine"} <= set(dm.PLATFORMS)
    assert dm.PLATFORMS["A-direct"].fabric is not None
    assert not dm.PLATFORMS["A-direct"].fabric.has_hops
    assert fabric.edge_names(dm.PLATFORMS["A-spine"]) == ("cxl", "uplink0", "uplink1",
                                                          "spine-cxl")
    # A fabric field left at None changes no existing platform.
    assert dm.PLATFORMS["A"] == dataclasses.replace(dm.platform_a(), fabric=None)
    assert des.export_state(dm.PLATFORMS["A-direct"], [wl.bw_test("cxl", ll.OpClass.LOAD, 4)]) \
        == des.export_state(dm.PLATFORMS["A"], [wl.bw_test("cxl", ll.OpClass.LOAD, 4)])


def test_peredge_is_pertier_on_a_linkless_platform():
    per_edge = fabric.peredge_miku(dm.PLATFORMS["A-direct"], 4)
    per_tier = cal.default_miku(dm.platform_a(), 4)
    assert _miku_value(per_edge) == _miku_value(per_tier)


# -- simulations -------------------------------------------------------------------


def _sim(ns, pm, workloads, *, seed=0, law=None, sim_ns=60_000.0, record=True,
         window_ns=10_000.0):
    """One sim built from ``ns``'s classes: ``law`` None (racing),
    "pertier" or "peredge" (edge scope)."""
    ctl = None
    if law == "peredge":
        ctl = ns.fab.peredge_miku(pm, 4)
    elif law == "pertier":
        ctl = ns.cal.default_miku(pm, 4)
    sim = ns.des.TieredMemorySim(pm, workloads, seed=seed, granularity=4, controller=ctl,
                                 window_ns=window_ns, record_windows=record,
                                 control_scope="edge" if law == "peredge" else "tier")
    return sim.run(sim_ns)


def _pair(ns, op, n, host):
    return [ns.wl.bw_test("ddr", op, n, name="ddr", miku_managed=False, host=host),
            ns.wl.bw_test("cxl", op, n, name="cxl", host=host)]


@pytest.mark.parametrize("op,n,seed", [("load", 8, 0), ("store", 4, 1), ("nt_store", 16, 2),
                                       ("load", 2, 3)])
def test_direct_platform_equals_a_and_the_reference(op, n, seed):
    """tests/test_fabric.py's degenerate identity, in the port: the
    all-transparent A-direct under the per-edge law equals A under the
    per-tier law, and each equals the reference's own run."""
    runs = {}
    for key, ns in (("port", PORT), ("ref", REF)):
        Op = ns.ll.OpClass(op)
        plain = _sim(ns, ns.dm.platform_a(), _pair(ns, Op, n, None), seed=seed,
                     law="pertier")
        fab = _sim(ns, ns.fab.direct_platform(), _pair(ns, Op, n, "host0"), seed=seed,
                   law="peredge")
        runs[key] = (plain, fab)
    plain, fab = runs["port"]
    assert fab.fabric is None and fab.decisions
    assert all(isinstance(d, TierDecisions) and d.tiers == ("cxl",) for d in fab.decisions)
    assert_same_result(fab, plain)
    assert_same_result(plain, runs["ref"][0])
    assert_same_result(fab, runs["ref"][1])


@pytest.mark.parametrize("port_queue", [64, 2048])
def test_single_switch_port_equals_the_reference(port_queue):
    results = []
    for ns in (PORT, REF):
        job = ns.sweep.SimJob(
            platform=ns.fab.single_switch_platform(port_slots=8, port_service_ns=36.0,
                                                   port_queue=port_queue),
            workloads=[ns.wl.bw_test("cxl", ns.ll.OpClass.LOAD, 8, name="cxl",
                                     host="host0")],
            sim_ns=60_000.0, record_windows=True)
        results.append(ns.sweep.run_job(job))
    got, want = results
    assert_same_result(got, want)
    port = got.fabric["sw0-cxl"]
    assert port["entry_limit"] == port_queue // 4
    if port_queue == 64:
        assert port["peak_occupancy"] == port["entry_limit"] and port["stall_events"] > 0
    else:
        assert port["peak_occupancy"] < port["entry_limit"] and port["stall_events"] == 0
    assert all(set(r["fabric"]) == {"sw0-cxl"} for r in got.window_records)


def _spine_workloads(ns, op, n=16):
    Op = ns.ll.OpClass(op)
    return [ns.wl.bw_test("ddr", Op, n, name="ddr", miku_managed=False, host="host0"),
            ns.wl.bw_test("cxl", Op, n, name="cxl0", host="host0"),
            ns.wl.bw_test("cxl", Op, n, name="cxl1", host="host1")]


@pytest.mark.parametrize("law", [None, "pertier", "peredge"])
@pytest.mark.parametrize("op", ["load", "store"])
def test_spine_corun_equals_the_reference(law, op):
    """The two-host spine co-run under racing and both laws, with the
    window records under edge scope (per-edge counters, decisions, the
    ports' blocks) compared whole."""
    got, want = (_sim(ns, ns.fab.spine_leaf_platform(), _spine_workloads(ns, op),
                      law=law, sim_ns=80_000.0) for ns in (PORT, REF))
    assert_same_result(got, want)
    assert set(got.fabric) == {"uplink0", "uplink1", "spine-cxl"}
    if law == "peredge":
        names = ("cxl", "uplink0", "uplink1", "spine-cxl")
        assert list(got.tier_counters) == ["ddr", *names]
        assert all(d.tiers == names for d in got.decisions)
        assert set(got.window_records[0]["decision"]) == set(names)


def test_asymmetric_spine_with_a_phased_workload_equals_the_reference():
    """A narrow uplink, a phased workload flipping between the routed and
    the direct tier, and a placement vector on the spine: the hop paths
    follow each request's tier."""
    got, want = [], []
    for ns, out in ((PORT, got), (REF, want)):
        pm = ns.fab.spine_leaf_platform(uplink_slots=(16, 4), uplink_service_ns=(18.0, 36.0),
                                        uplink_queue=(1024, 128), spine_slots=14,
                                        spine_service_ns=18.0)
        Op = ns.ll.OpClass
        wls = [ns.des.WorkloadSpec(name="alt", op=Op.LOAD, tier="cxl", n_cores=8,
                                   phases=[(15_000.0, "cxl"), (15_000.0, "ddr")],
                                   host="host1"),
               ns.des.WorkloadSpec(name="striped", op=Op.STORE, tier="ddr", n_cores=8,
                                   ddr_fraction=0.5, host="host0"),
               ns.wl.bw_test("cxl", Op.LOAD, 8, name="cxl", host="host1")]
        out.append(_sim(ns, pm, wls, law="peredge", sim_ns=60_000.0))
    assert_same_result(got[0], want[0])


def _golden():
    with open(os.path.join(DATA, "fabric_trace_goldens.json")) as f:
        return json.load(f)


class _Replay:
    """A substrate that hands recorded counter windows to a ControlLoop."""

    def __init__(self, deltas):
        self._deltas, self._i = list(deltas), 0

    @property
    def clock_ns(self):
        return float(self._i)

    @property
    def exhausted(self):
        return self._i >= len(self._deltas)

    def counters_delta(self):
        self._i += 1
        return self._deltas[self._i - 1]

    def apply(self, decision):
        pass


def _assert_edge_decisions(decisions, windows, names):
    assert len(decisions) == len(windows)
    for i, (d, w) in enumerate(zip(decisions, windows)):
        assert isinstance(d, TierDecisions) and d.tiers == names, i
        for e in names:
            de, ge = d.for_tier(e), w["decision"][e]
            assert (de.max_concurrency, de.rate_factor, de.phase.value) == \
                (ge["max_concurrency"], ge["rate_factor"], ge["phase"]), (i, e)


def test_golden_trace_replayed_law_only():
    blob = _golden()
    cnames = tuple(blob["counter_names"])
    deltas = []
    for w in blob["windows"]:
        counters = []
        for n in cnames:
            d = w["tiers"][n]
            counters.append(ll.TierCounters(
                inserts=d["inserts"], occupancy_time=d["occupancy_time"],
                class_counts={ll.OpClass(k): v for k, v in d["class_counts"].items()}))
        deltas.append(ll.TierWindow(tuple(counters), cnames))
    sub = _Replay(deltas)
    loop = ControlLoop(sub, fabric.peredge_miku(fabric.spine_leaf_platform(), 4),
                       window_ns=1.0)
    while not sub.exhausted:
        loop.fire()
    _assert_edge_decisions(loop.decisions, blob["windows"], tuple(blob["edge_names"]))


def test_golden_trace_resimulated_live():
    blob = _golden()
    pm = fabric.spine_leaf_platform()
    assert pm.name == blob["platform"]
    Op = ll.OpClass
    op, n = Op(blob["op"]), blob["n_threads"]
    wls = [wl.bw_test("ddr", op, n, name="ddr", miku_managed=False, host="host0"),
           wl.bw_test("cxl", op, n, name="cxl0", host="host0"),
           wl.bw_test("cxl", op, n, name="cxl1", host="host1")]
    sim = des.TieredMemorySim(pm, wls, seed=0, granularity=4,
                              controller=fabric.peredge_miku(pm, 4),
                              window_ns=blob["window_ns"], record_windows=True,
                              control_scope="edge")
    res = sim.run(blob["sim_ns"])
    _assert_edge_decisions(res.decisions, blob["windows"], tuple(blob["edge_names"]))
    assert res.fabric == blob["fabric"]
    assert res.window_records == blob["windows"]
    for name, bw in blob["bandwidths"].items():
        assert res.bandwidth(name) == bw


# -- the batched lane's fallback -------------------------------------------------------


def _lane_jobs(ns):
    Op = ns.ll.OpClass
    two = [ns.wl.bw_test("ddr", Op.LOAD, 4, name="ddr", miku_managed=False),
           ns.wl.bw_test("cxl", Op.LOAD, 4, name="cxl")]
    J = ns.sweep.SimJob
    return [
        J(platform=ns.fab.single_switch_platform(port_queue=1024),
          workloads=[ns.wl.bw_test("cxl", Op.LOAD, 8, name="cxl", host="host0")],
          sim_ns=40_000.0),
        J(platform=ns.dm.PLATFORMS["A-direct"], workloads=list(two), sim_ns=40_000.0,
          miku=True, miku_law="peredge"),
        J(platform=ns.dm.PLATFORMS["A-direct"], workloads=list(two), sim_ns=40_000.0,
          miku=True),
        J(platform=ns.dm.PLATFORMS["A-spine"], workloads=list(two), sim_ns=40_000.0),
        J(platform=ns.dm.platform_a(), workloads=list(two), sim_ns=40_000.0, miku=True,
          miku_law="peredge"),
        J(platform=ns.dm.platform_a(), workloads=list(two), sim_ns=40_000.0, miku=True),
    ]


def test_can_batch_and_partition_name_the_reference_reasons():
    got, want = _lane_jobs(PORT), _lane_jobs(REF)
    reasons = [lane.can_batch(j) for j in got]
    assert reasons == [ref_lane.can_batch(j) for j in want]
    assert reasons == ["fabric_topology", "fabric_topology", None, "fabric_topology",
                       "fabric_topology", None]
    plans, fallbacks = lane.partition_jobs(got)
    ref_plans, ref_fallbacks = ref_lane.partition_jobs(want)
    assert fallbacks == ref_fallbacks
    assert [p is None for p in plans] == [p is None for p in ref_plans]
    # A-direct batches normally: its plan equals A's.
    assert plans[2].export == plans[5].export
    assert len(plans[2].units) == len(plans[5].units) == 1


def test_batched_lane_runs_fabric_jobs_on_the_scalar_des():
    jobs = _lane_jobs(PORT)
    batched = sweep.run_sweep(jobs, lane="batched", device="cpu")
    scalar = sweep.run_sweep(jobs, lane="scalar")
    ref = ref_sweep.run_sweep(_lane_jobs(REF), lane="scalar")
    for i in (0, 1, 3, 4):
        assert_same_result(batched[i], scalar[i])
        assert_same_result(batched[i], ref[i])
    assert batched[0].fabric == scalar[0].fabric and batched[0].fabric is not None
    # The A-direct and A cells ran batched, to the same numbers.
    assert batched[2].stats["cxl"].bytes == batched[5].stats["cxl"].bytes


# -- the scenarios ---------------------------------------------------------------------


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            same = g[k] == w[k] or (isinstance(g[k], float) and math.isnan(g[k])
                                    and math.isnan(w[k]))
            assert same, (k, g[k], w[k])


@pytest.mark.parametrize("name", ["fabric_spine_congestion", "fabric_port_overflow",
                                  "fabric_miku"])
def test_fabric_scenario_rows_equal_the_reference(name):
    got = run_scenario(name, device="cpu").rows
    _same_rows(got, ref_run_scenario(name, {}).rows)
    rows = {r.get("law", r.get("port_queue")): r for r in got}
    if name == "fabric_spine_congestion":
        racing, peredge = rows["racing"], rows["peredge"]
        assert racing["ddr_pct_of_alone"] < 10.0 < 60.0 < peredge["ddr_pct_of_alone"]
        assert peredge["spine_restricted_windows"] > 0
        assert racing["spine_stall_events"] > peredge["spine_stall_events"]
    elif name == "fabric_port_overflow":
        assert [rows[q]["port_limited"] for q in (64, 256, 1024, 2048)] == [1, 1, 1, 0]
    else:
        assert rows["peredge"]["cxl0_pct_of_alone"] > rows["pertier"]["cxl0_pct_of_alone"]
        assert rows["peredge"]["uplink1_restricted_windows"] > 0


def test_fabric_scenario_on_the_scalar_lane_equals_the_batched_lane():
    overrides = {"port_queue": "64,2048"}
    _same_rows(run_scenario("fabric_port_overflow", overrides, device="cpu",
                            lane="scalar").rows,
               run_scenario("fabric_port_overflow", overrides, device="cpu").rows)


def test_hypothesis_direct_routes_match_the_flat_chain():
    """A property over (op, threads, seed): A-direct under the per-edge law
    equals A under the per-tier law in the port (tests/test_fabric.py's
    property, no function-scoped fixture inside ``@given``)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(op=st.sampled_from(["load", "store", "nt_store"]), n=st.integers(1, 12),
           seed=st.integers(0, 2**16))
    @settings(max_examples=4, deadline=None)
    def prop(op, n, seed):
        Op = ll.OpClass(op)
        plain = _sim(PORT, dm.platform_a(), _pair(PORT, Op, n, None), seed=seed,
                     law="pertier", sim_ns=30_000.0)
        fab = _sim(PORT, fabric.direct_platform(), _pair(PORT, Op, n, "host0"),
                   seed=seed, law="peredge", sim_ns=30_000.0)
        assert_same_result(fab, plain)

    prop()
