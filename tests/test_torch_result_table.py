"""Port parity: the scenario result API (repro_torch.scenarios.spec's
ResultTable, the planner's resolve_platform / resolve_axes / expand_cells,
``run_scenario``'s meta and the ``--set`` parsing) against the reference's
(repro.scenarios) on the CPU.

On the scalar lane the two packages run the same DES, so the tables are
equal byte for byte (rows, params, columns, CSV and JSON).  On the batched
lane the port's meta must equal the reference's, fallbacks included, and
its rows stay within tests/test_torch_batched.py's rel 1e-6 of the
reference's batched lane."""

import dataclasses
import enum
import json

import pytest
import torch

import repro.scenarios as R
import repro.scenarios.planner as ref_planner
from repro.core.device_model import platform_a as ref_platform_a
from repro.core.littles_law import OpClass as RefOp
from repro.memsim.sweep import SimJob as RefJob
from repro.memsim.workloads import bw_test as ref_bw_test
from repro.tiering import HotSetPattern as RefPattern
from repro.tiering import RegionSpec as RefRegion
from repro.tiering import TieringSpec as RefSpec
from repro.tiering.policies import POLICIES as REF_POLICIES
from repro_torch import scenarios as P
from repro_torch.core.device_model import platform_a
from repro_torch.core.littles_law import OpClass
from repro_torch.memsim.sweep import SimJob
from repro_torch.memsim.workloads import bw_test
from repro_torch.scenarios import planner
from repro_torch.tiering import HotSetPattern, RegionSpec, TieringSpec
from repro_torch.tiering.policies import POLICIES
from test_torch_scalar_lane import FrozenPolicy, _corun_job, _frozen_job

torch.set_num_threads(1)

#: Four cheap grid scenarios at short horizons (exact-lane shapes and a
#: co-run grid), each a handful of jobs.
CHEAP = {
    "fig3_bandwidth": {"platform": "A", "threads": (1,)},
    "fig4_latency": {"threads": (1, 4)},
    "fig8_sync": {"bg_threads": (0, 4)},
    "corun_sweep": {"platform": ("A",), "threads": (2,), "mlp": (160,),
                    "sim_ns": 30_000.0, "op": "load,store"},
}

#: A grid whose A-spine cells fall back ("fabric_topology") beside A's.
MIXED = {"platform": ("A", "A-spine"), "threads": (2,), "mlp": (160,), "sim_ns": 20_000.0,
         "op": "load"}


def _plain(v):
    """Axis values as comparable plain data (enums by value, platform models
    by name, sequences as lists)."""
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if hasattr(v, "tier_names"):
        return v.name
    return v


def _same_rows(port, ref, rel=0.0):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert list(p) == list(r)
        for k in r:
            if isinstance(r[k], float) and rel:
                assert p[k] == pytest.approx(r[k], rel=rel), k
            else:
                assert p[k] == r[k], k


@pytest.mark.parametrize("name", sorted(CHEAP))
def test_scalar_lane_table_equals_the_reference(name):
    over = CHEAP[name]
    got = P.run_scenario(name, over, device="cpu", lane="scalar")
    want = R.run_scenario(name, over, lane="scalar")
    assert isinstance(got, P.ResultTable) and got.scenario == want.scenario == name
    assert got.rows == want.rows
    assert got.columns == want.columns
    assert _plain(list(got.params.values())) == _plain(list(want.params.values()))
    assert list(got.params) == list(want.params)
    assert got.to_csv() == want.to_csv()
    assert got.to_json() == want.to_json()
    assert got.meta == want.meta == {"lane": "scalar"}
    assert got.traces is got.request_traces is None
    assert got.to_csv().count("\n") == len(got.rows) + 1
    assert json.loads(got.to_json())["rows"] == got.rows


@pytest.mark.parametrize("name", sorted(CHEAP))
def test_batched_lane_meta_and_rows_match_the_reference(name, monkeypatch):
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    over = CHEAP[name]
    got = P.run_scenario(name, over, device="cpu")
    want = R.run_scenario(name, over, lane="batched")
    assert got.meta == want.meta
    assert got.meta["batched_jobs"] == sum(len(js) for _, _, js in P.plan(name, over))
    _same_rows(got.rows, want.rows, rel=1e-6)


def test_fallback_grid_meta_equals_the_reference():
    got = P.run_scenario("corun_sweep", MIXED, device="cpu")
    want = R.run_scenario("corun_sweep", MIXED, lane="batched")
    assert got.meta == want.meta == {
        "lane": "batched", "batched_jobs": 2, "scalar_fallback_jobs": 2,
        "fallback_reasons": ["fabric_topology"],
        "fallback_reason_counts": {"fabric_topology": 2}}
    _same_rows(got.rows, want.rows, rel=1e-6)


@pytest.mark.parametrize("value", [None, "1", "7", "2048", "0", "-3", "junk"])
def test_batch_block_reads_the_environment_as_the_reference(value, monkeypatch):
    from repro.memsim.batched.lane import batch_block as ref_batch_block
    from repro_torch.memsim.batched.lane import batch_block

    if value is None:
        monkeypatch.delenv("REPRO_BATCH_BLOCK", raising=False)
    else:
        monkeypatch.setenv("REPRO_BATCH_BLOCK", value)
    assert batch_block() == ref_batch_block()


def test_batch_block_chunks_the_lane_and_changes_no_result(monkeypatch):
    """``REPRO_BATCH_BLOCK=1`` runs every fluid cell as a group of its own,
    and K3 (its plain version here) is called once a window for each
    group: a group of n cells and w windows at the default block becomes n
    groups of w windows.  Rows and meta stay those of the default block bit
    for bit, and the reference's under the same setting."""
    from repro_torch.memsim.batched import fluid

    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_BATCH_BLOCK", raising=False)
    run_fluid, groups = fluid.run_fluid, []

    def counted(group, *args):
        before = fluid.COUNTS.windows
        out = run_fluid(group, *args)
        groups.append((len(group.plans), fluid.COUNTS.windows - before))
        return out

    monkeypatch.setattr(fluid, "run_fluid", counted)
    over = CHEAP["corun_sweep"]
    whole = P.run_scenario("corun_sweep", over, device="cpu")
    whole_groups, groups[:] = list(groups), []
    monkeypatch.setenv("REPRO_BATCH_BLOCK", "1")
    chunked = P.run_scenario("corun_sweep", over, device="cpu")
    assert whole.meta["batched_jobs"] == 4
    assert any(n > 1 for n, _ in whole_groups) and all(w > 0 for _, w in whole_groups)
    assert all(n == 1 for n, _ in groups)
    assert sorted(w for _, w in groups) == sorted(w for n, w in whole_groups
                                                  for _ in range(n))
    assert chunked.rows == whole.rows and chunked.meta == whole.meta
    want = R.run_scenario("corun_sweep", over, lane="batched")
    assert chunked.meta == want.meta
    _same_rows(chunked.rows, want.rows, rel=1e-6)


def _frozen_scenario(Scenario, Job, Pf, bw, Op, Spec, Region, Pattern, corun):
    """A grid of one cell: a tiering job whose policy the vector twin cannot
    run (it falls back only when its group fails to stack, during the run)
    beside two co-runs that stay batched."""
    def build(pm, cell):
        del pm, cell
        return [_frozen_job(Job, Pf, bw, Op, Spec, Region, Pattern),
                corun(Job, Pf, bw, Op.LOAD, True, sim_ns=30_000.0),
                corun(Job, Pf, bw, Op.STORE, True, sim_ns=30_000.0)]

    def reduce(pm, cell, jobs, results):
        del pm, cell, jobs
        return [{"job": i, "gbps": sum(r.bandwidth(w) for w in r.stats)}
                for i, r in enumerate(results)]

    return Scenario(name="frozen_grid", title="dynamic fallback", build=build, reduce=reduce)


def test_dynamic_fallback_is_counted_after_the_run(monkeypatch):
    monkeypatch.setitem(POLICIES, FrozenPolicy.name, FrozenPolicy)
    monkeypatch.setitem(REF_POLICIES, FrozenPolicy.name, FrozenPolicy)
    port_sc = _frozen_scenario(P.Scenario, SimJob, platform_a, bw_test, OpClass,
                               TieringSpec, RegionSpec, HotSetPattern, _corun_job)
    ref_sc = _frozen_scenario(R.Scenario, RefJob, ref_platform_a, ref_bw_test, RefOp,
                              RefSpec, RefRegion, RefPattern, _corun_job)
    got = P.run_scenario(port_sc, device="cpu")
    want = R.run_scenario(ref_sc, lane="batched")
    assert got.meta["batched_jobs"] == want.meta["batched_jobs"] == 2
    assert got.meta["scalar_fallback_jobs"] == want.meta["scalar_fallback_jobs"] == 1
    (reason,) = got.meta["fallback_reasons"]
    assert reason.startswith("group stacking failed") and "frozen_test_policy" in reason
    assert got.meta["fallback_reason_counts"] == {reason: 1}
    assert got.rows[0] == want.rows[0]  # the fallback ran on the scalar DES


def test_profile_fills_meta(monkeypatch):
    over = {"platform": ("A",), "threads": (2,), "mlp": (160,), "sim_ns": 20_000.0,
            "op": "load"}
    from repro_torch.obs.metrics import default_registry

    before = default_registry().counter("sweep.jobs").value
    got = P.run_scenario("corun_sweep", over, device="cpu", lane="scalar", profile=True)
    phases = got.meta["profile"]["phases"]
    assert set(phases) == {"plan", "sweep", "reduce"}
    assert all(p["calls"] == 1 and p["seconds"] >= 0.0 for p in phases.values())
    # Each scalar job's own profile: setup, event loop and window passes.
    assert len(got.meta["profile"]["jobs"]) == 2
    assert {"setup", "event_loop"} <= set(got.meta["profile"]["jobs"][0]["phases"])
    snap = got.meta["metrics"]
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert snap["counters"]["sweep.jobs"] == before + 2
    assert got.rows == P.run_scenario("corun_sweep", over, device="cpu",
                                      lane="scalar").rows
    batched = P.run_scenario("corun_sweep", over, device="cpu", profile=True)
    assert batched.meta["profile"]["jobs"] == []  # no scalar job ran
    assert batched.meta["batched_jobs"] == 2


def test_resolution_equals_the_reference_over_every_scenario():
    assert P.names() == R.names()
    for name in R.names():
        rv = R.resolve_axes(name)
        pv = P.resolve_axes(name)
        assert list(pv) == list(rv)
        assert _plain(list(pv.values())) == _plain(list(rv.values())), name
        rc, pc = R.expand_cells(name, rv), P.expand_cells(name, pv)
        assert len(pc) == len(rc)
        for a, b in zip(pc, rc):
            assert list(a) == list(b) and _plain(list(a.values())) == _plain(list(b.values()))
        for cell in pc:
            if "platform" not in cell:
                continue
            (pl, pm), (rl, rm) = (P.resolve_platform(cell["platform"]),
                                  R.resolve_platform(cell["platform"]))
            assert pl == rl and pm.name == rm.name and pm.tier_names == rm.tier_names
            assert [dataclasses.astuple(d) for d in pm.tiers] == \
                [dataclasses.astuple(d) for d in rm.tiers]
        if name in ("fig3_bandwidth", "corun_sweep"):
            assert P.resolve_axes(name, {"threads": 4})["threads"] == (4,)
            assert P.resolve_axes(name, {"threads": "1,2"})["threads"] == (1, 2)


def test_resolve_platform_accepts_models_and_lists_names():
    pm = platform_a()
    assert P.resolve_platform(pm) == (pm.name, pm)
    with pytest.raises(KeyError) as ex:
        P.resolve_platform("Z")
    with pytest.raises(KeyError) as ref_ex:
        R.resolve_platform("Z")
    assert str(ex.value) == str(ref_ex.value)
    with pytest.raises(KeyError, match="no axis 'nope'"):
        P.resolve_axes("fig3_bandwidth", {"nope": 1})


def _token(axis):
    """A ``--set`` token for ``axis``: its default as text (grids joined)."""
    def one(v):
        return str(v.value) if isinstance(v, enum.Enum) else str(v)
    return ",".join(one(v) for v in axis.default) if axis.is_grid else one(axis.default)


def test_set_parsing_equals_the_reference_for_every_axis():
    n = 0
    for name in R.names():
        ref_sc, sc = R.get(name), P.get(name)
        for ra, pa in zip(ref_sc.axes, sc.axes):
            tok = _token(ra)
            assert _plain(pa.parse_text(tok)) == _plain(ra.parse_text(tok)), (name, ra.name)
            got = P.parse_set_args(name, [f"{pa.name}={tok}"])
            want = R.parse_set_args(name, [f"{ra.name}={tok}"])
            assert _plain(list(got.values())) == _plain(list(want.values()))
            if not ra.is_grid:
                with pytest.raises(ValueError, match="scalar knob"):
                    pa.parse_text("1,2")
            n += 1
    assert n == sum(len(s.axes) for s in R.all_scenarios())
    assert P.get("corun_sweep").axis("miku").parse_text("true,off") == (True, False)
    with pytest.raises(ValueError, match="not a boolean"):
        P.get("corun_sweep").axis("miku").parse_text("maybe")
    with pytest.raises(ValueError, match="axis=value"):
        P.parse_set_args("corun_sweep", ["threads"])


def _quick_run_cell(Scenario):
    return Scenario(name="quick_cell", title="", run_cell=lambda pm, cell, arg: [{"x": 1}])


def test_run_cell_errors_and_note_equal_the_reference():
    for kw in ({"trace": True}, {"perfetto": True}):
        with pytest.raises(ValueError) as got:
            P.run_scenario("fig2_tiering", device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            R.run_scenario("fig2_tiering", **kw)
        assert str(got.value) == str(want.value)
    got = P.run_scenario(_quick_run_cell(P.Scenario), device="cpu")
    want = R.run_scenario(_quick_run_cell(R.Scenario), lane="batched")
    assert got.meta == want.meta and got.meta["lane"] == "scalar" and "note" in got.meta
    assert got.rows == want.rows == [{"x": 1}]
    scalar = P.run_scenario(_quick_run_cell(P.Scenario), device="cpu", lane="scalar")
    assert scalar.meta == R.run_scenario(_quick_run_cell(R.Scenario), lane="scalar").meta
    with pytest.raises(ValueError) as got:
        P.plan("fig11_llm")
    with pytest.raises(ValueError) as want:
        ref_planner.plan("fig11_llm")
    assert str(got.value) == str(want.value)


def test_register_refuses_a_duplicate_name():
    with pytest.raises(ValueError, match="already registered"):
        P.register(P.get("fig3_bandwidth"))
    sc = _quick_run_cell(P.Scenario)
    try:
        assert P.register(sc) is sc and P.get("quick_cell") is sc
        assert P.names()[-1] == "quick_cell"
    finally:
        P.SCENARIOS.pop("quick_cell")
    assert P.names() == R.names()


def test_traces_fill_the_table():
    over = {"platform": "A", "tier": ("ddr",), "threads": (2,)}
    got = planner.run_scenario("fig4_latency", over, device="cpu", trace=True)
    assert got.request_traces is None and len(got.traces) == 1
    assert "windows" in got.traces[0]["jobs"][0]
    assert "traces" not in json.loads(got.to_json())
