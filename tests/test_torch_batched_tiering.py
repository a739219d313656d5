"""Port parity: vector tiering on the port's batched lane against the
reference's, on the CPU.

* plan_cell's exports (migration workloads gated closed, PageMap-derived
  routing) equal the reference's bound sim's, key by key, for every job of
  migrate_interference and tiering_policies, on a merged-law A-switch job,
  and with the reference's three-tier routing;
* the golden replay: the reference's scalar run, recorded as
  tests/test_batched_tiering.py records it, feeds its window inputs to the
  port's VectorTiering, whose window log must equal
  tests/data/migrate_trace_goldens.json key for key;
* the port's VectorTiering against the reference's on seeded random
  windows over A, A-switch and merged cells: every state array equal
  after every step;
* both scenarios' rows, jobs and tiering summaries equal the reference's
  batched lane's; a merged-law A-switch tiering job (the restricted-bit
  broadcast) likewise; record_windows' tiering blocks record for record;
* run_scenario(trace=True)'s schema, the --trace CLI, a run_cell scenario
  refusing trace, and a foreign policy refused by name."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.memsim.batched as ref_batched
from repro.core.device_model import PLATFORMS as REF_PLATFORMS
from repro.core.littles_law import OpClass as RefOp
from repro.memsim.batched.stacking import BatchGroup as RefGroup
from repro.memsim.batched.stacking import plan_cell as ref_plan_cell
from repro.memsim.batched.tiering import build_tiering as ref_build_tiering
from repro.memsim.sweep import SimJob as RefJob
from repro.memsim.sweep import run_sweep as ref_run_sweep
from repro.memsim.workloads import bw_test as ref_bw_test
from repro.scenarios import plan as ref_plan
from repro.scenarios import run_scenario as ref_run_scenario
from repro.tiering import HotSetPattern as RefPattern
from repro.tiering import RegionSpec as RefRegion
from repro.tiering import TieringSpec as RefSpec
from repro.tiering.hook import TieringHook as RefHook
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.littles_law import OpClass
from repro_torch.launch import sweep as sweep_cli
from repro_torch.memsim.batched.fluid import COUNTS
from repro_torch.memsim.batched.lane import run_sweep_batched
from repro_torch.memsim.batched.stacking import BatchGroup, plan_cell
from repro_torch.memsim.batched.tiering import build_tiering
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.memsim.workloads import bw_test
from repro_torch.scenarios import plan, run_scenario
from repro_torch.tiering import HotSetPattern, RegionSpec, TieringSpec
from repro_torch.tiering.policies import POLICIES, HotnessLRUPolicy
from test_torch_fig13_14 import _same_record
from test_torch_figures import _assert_job, _run_both

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
TIERING = ("migrate_interference", "tiering_policies")
_GOLDEN_KEYS = ("promoted", "demoted", "enqueued", "deferred", "backlog_pages",
                "migrated_bytes")
#: VectorTiering's state, compared after every step.
_STATE = ("tier", "hotness", "queued", "hot_start", "credit", "qlen", "q_promo", "q_demo",
          "promoted", "demoted", "migrated_bytes", "deferred", "windows", "page_act",
          "region_wi", "region_rank", "mig_wi", "mig_act", "rpp", "mig_base", "pol",
          "promote_pw", "demote_pw", "high_wm", "low_wm", "min_hot", "jpbu", "fast_cap",
          "decay", "home_slow")


def _merged_jobs(Job, P, bw, Op, Spec, Region, Pattern, record=False):
    """Three-tier co-runs on A-switch under the merged law with a tracked
    CXL region spread over both slow tiers: miku_coordinated (the merged
    cell reads the broadcast restricted bit, no budgets) and hotness_lru."""
    wls = [bw(t, Op("load"), 16, name=t, miku_managed=t != "ddr")
           for t in ("ddr", "cxl", "cxl_sw")]

    def spec(policy):
        return Spec(regions=(Region(workload="cxl", n_pages=512,
                                    placement={"cxl": 0.5, "cxl_sw": 0.5},
                                    pattern=Pattern(drift_pages=16.0)),),
                    policy=policy, fast_capacity_pages=96, mig_cores=8, mig_mlp=160)

    return [Job(platform=P["A-switch"], workloads=wls, sim_ns=150_000.0, miku=True,
                miku_law="merged", tiering=spec(pol), record_windows=record)
            for pol in ("miku_coordinated", "hotness_lru")]


def _port_merged(record=False):
    return _merged_jobs(SimJob, PLATFORMS, bw_test, OpClass, TieringSpec, RegionSpec,
                        HotSetPattern, record)


def _ref_merged(record=False):
    return _merged_jobs(RefJob, REF_PLATFORMS, ref_bw_test, RefOp, RefSpec, RefRegion,
                        RefPattern, record)


def _job_pairs():
    """(reference job, port job) for every job of both scenarios and the
    merged-law jobs."""
    pairs = []
    for name in TIERING:
        ref_jobs = [j for _, _, js in ref_plan(name) for j in js]
        port_jobs = [j for _, _, js in plan(name) for j in js]
        pairs += list(zip(ref_jobs, port_jobs))
    return pairs + list(zip(_ref_merged(), _port_merged()))


def test_plan_cell_exports_equal_the_reference_bound_sims():
    for r_job, p_job in _job_pairs():
        r, p = ref_plan_cell(r_job), plan_cell(p_job)
        assert p.export.keys() == r.export.keys()
        for key, want in r.export.items():
            assert p.export[key] == want, key
        assert (p.tiering is None) == (r.tiering is None)
        if r.tiering is None:
            continue
        h, rh = p.tiering, r.tiering
        assert h.engine.reqs_per_page == rh.engine.reqs_per_page
        assert h._region_wi == rh._region_wi and h._mig_wi == rh._mig_wi
        assert h._mig_effmlp == rh._mig_effmlp
        assert all(p.export["w_effmlp"][wi] == 0 for wi in h._mig_wi.values())
        assert h.policy.name == rh.policy.name
        for name, reg in rh.pagemap.regions.items():
            assert np.array_equal(h.pagemap.regions[name].tier, reg.tier)
        assert h.summary() == rh.summary()


def test_three_tier_routing_export_equals_the_reference():
    """A tracked region over all three tiers, with a ddr_fraction and a
    placement workload beside it: the cumulative routing the reference's
    bound sim exports."""
    def jobs(Job, P, bw, Op, Spec, Region):
        wls = [bw("cxl", Op("load"), 8, name="app"),
               dataclasses.replace(bw("ddr", Op("load"), 4, name="frac"), ddr_fraction=0.3),
               dataclasses.replace(bw("ddr", Op("store"), 4, name="place"),
                                   placement={"ddr": 0.2, "cxl_sw": 0.8})]
        spec = Spec(regions=(Region(workload="app", n_pages=999,
                                    placement={"ddr": 0.1, "cxl": 0.45, "cxl_sw": 0.45}),),
                    policy="hotness_lru")
        return Job(platform=P["A-switch"], workloads=wls, sim_ns=20_000.0, tiering=spec)

    r = ref_plan_cell(jobs(RefJob, REF_PLATFORMS, ref_bw_test, RefOp, RefSpec, RefRegion))
    p = plan_cell(jobs(SimJob, PLATFORMS, bw_test, OpClass, TieringSpec, RegionSpec))
    assert p.export == r.export
    assert p.export["w_names"][-2:] == ["mig-cxl", "mig-cxl_sw"]


# -- the golden replay -----------------------------------------------------------


class _RecordingHook(RefHook):
    """The reference's scalar hook, recording its per-window inputs before
    acting (tests/test_batched_tiering.py's pattern)."""

    def __init__(self, spec) -> None:
        super().__init__(spec)
        self.inputs = []

    def on_window(self, sim):
        deltas = {w.name: c - m for w, c, m in
                  zip(sim.workloads, sim._stat_completed, self._stat_mark)}
        budgets = self._budgets(sim)
        dec = self._latest_decisions(sim)
        restricted = (None if dec is None
                      else {t: d.restricted for t, d in dec.items()})
        self.inputs.append((deltas, None if budgets is None else dict(budgets),
                            restricted))
        return super().on_window(sim)


class _RecordingSpec(RefSpec):
    hooks = []  # run_sweep builds the hook out of our hands

    def build(self):
        hook = _RecordingHook(self)
        _RecordingSpec.hooks.append(hook)
        return hook


def test_port_vector_tiering_replays_the_goldens_exactly():
    """The reference's scalar run of the pinned migrate_interference jobs,
    its per-window inputs replayed through the port's VectorTiering: the
    window log equals the golden traces field for field."""
    with open(os.path.join(DATA, "migrate_trace_goldens.json")) as f:
        golden = json.load(f)
    ((_, _, ref_jobs),) = ref_plan("migrate_interference", golden["overrides"])
    ((_, _, port_jobs),) = plan("migrate_interference", golden["overrides"])
    for variant, blob in golden["variants"].items():
        ref_job, job = ref_jobs[blob["job"]], port_jobs[blob["job"]]
        _RecordingSpec.hooks.clear()
        spec = _RecordingSpec(**{f.name: getattr(ref_job.tiering, f.name)
                                 for f in dataclasses.fields(RefSpec)})
        ref_run_sweep([dataclasses.replace(ref_job, tiering=spec)], lane="scalar")
        (hook,) = _RecordingSpec.hooks
        assert len(hook.inputs) == len(blob["windows"]), variant

        group = BatchGroup([(0, plan_cell(job))])
        vt = build_tiering(group)
        w_names = group.plans[0].export["w_names"]
        slow = vt.tier_names[0][1:]
        frac_live, effmlp_live = group.tier_frac.copy(), group.effmlp.copy()
        for k, (deltas, budgets, restricted) in enumerate(hook.inputs):
            vt.step(np.array([True]),
                    np.array([[float(deltas.get(nm, 0)) for nm in w_names]]),
                    np.array([[float((budgets or {}).get(t, 0)) for t in slow]]),
                    np.array([[bool((restricted or {}).get(t, False)) for t in slow]]),
                    np.array([budgets is not None]), np.array([restricted is not None]),
                    float(k + 1) * group.window_ns, frac_live, effmlp_live)
        log = vt.window_log[0]
        assert len(log) == len(blob["windows"]), variant
        for got, want in zip(log, blob["windows"]):
            assert got["window"] == want["window"], variant
            for key in _GOLDEN_KEYS:
                assert got[key] == want["tiering"][key], (variant, want["window"], key)


# -- the twin against the reference's twin ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_vector_tiering_state_equals_the_reference_on_random_windows(seed):
    """One group of every job of both scenarios and the merged-law jobs
    (A, A-switch, merged cells; W and T padded), fed the same seeded
    random windows: every state array, the live tables and the window logs
    equal after every step."""
    rng = np.random.default_rng(seed)
    pairs = _job_pairs()
    ref_group = RefGroup([(i, ref_plan_cell(r)) for i, (r, _) in enumerate(pairs)])
    group = BatchGroup([(i, plan_cell(p)) for i, (_, p) in enumerate(pairs)])
    ref_vt, vt = ref_build_tiering(ref_group), build_tiering(group)
    assert (vt.C, vt.R, vt.P, vt.U) == (ref_vt.C, ref_vt.R, ref_vt.P, ref_vt.U)
    merged = np.array([p.merged for p in group.plans])
    has_ctl = np.array([bool(p.units) for p in group.plans])
    live = [group.tier_frac.copy(), group.effmlp.copy()]
    ref_live = copy.deepcopy(live)
    C, W, U = vt.C, group.n_wl, vt.U
    for k in range(40):
        fire = rng.random(C) < 0.9
        ins_w = rng.uniform(0, 3000, (C, W)) * (rng.random((C, W)) < 0.8)
        ins_w[:, -U:] = np.floor(ins_w[:, -U:] / 40.0) * rng.choice([1.0, 1.5], (C, U))
        budgets = rng.choice([0.0, 1.0, 2.0, 4.0], (C, U))
        restr = rng.random((C, U)) < 0.4
        args = (fire, ins_w, budgets, restr, has_ctl & ~merged, has_ctl, (k + 1) * 1e4)
        ref_vt.step(*args, *ref_live)
        vt.step(*args, *live)
        for name in _STATE:
            assert np.array_equal(getattr(vt, name), getattr(ref_vt, name)), (k, name)
        for a, b in zip(live, ref_live):
            assert np.array_equal(a, b), k
        assert vt.window_log == ref_vt.window_log
        assert [[list(q) for q in row] for row in vt._queues] == \
            [[list(q) for q in row] for row in ref_vt._queues]
    assert vt.promoted.sum() > 0 and vt.deferred.sum() > 0
    assert [vt.summary(ci) for ci in range(C)] == [ref_vt.summary(ci) for ci in range(C)]


# -- the lane against the reference's lane ------------------------------------------


def _same_tiering_job(job, r, p):
    _assert_job(job, r, p)
    assert p.tiering == r.tiering


@pytest.mark.parametrize("name", TIERING)
def test_tiering_scenarios_match_the_reference_batched_lane(name, monkeypatch):
    ref_rows, rows, jobs = _run_both(name, monkeypatch)
    for job, r, p in jobs:
        _same_tiering_job(job, r, p)
    assert rows == ref_rows and len(rows) > 0
    if name == "migrate_interference":
        by = {r["variant"]: r for r in rows}
        assert by["naive"]["ddr_pct_of_demand_only"] < 90.0
        assert by["miku"]["ddr_pct_of_demand_only"] > 97.0
        assert by["miku"]["deferred_jobs"] > 0
    else:
        for r in rows:
            assert (r["pages_promoted"] == 0) == (r["policy"] == "static")


def test_merged_law_tiering_job_matches_the_reference_lane(monkeypatch):
    """The merged law's restricted bit, broadcast to both slow tiers, gates
    miku_coordinated (no per-ladder budgets for a merged cell); results,
    tiering summaries and the recorded windows' blocks equal the
    reference's."""
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    ref = ref_batched.run_sweep_batched(_ref_merged(record=True))
    got = run_sweep_batched(_port_merged(record=True), device="cpu")
    for job, r, p in zip(_port_merged(), ref, got):
        _same_tiering_job(job, r, p)
        assert len(p.window_records) == len(r.window_records) == 15
        for pr, rr in zip(p.window_records, r.window_records):
            _same_record(pr, rr)
    coord, lru = got
    # Restricted in every window, the merged ladder defers every copy the
    # coordinated policy wants; the same co-run without coordination copies.
    assert coord.tiering["deferred_jobs"] > 0 and coord.tiering["pages_promoted"] == 0
    assert all(d.restricted for d in coord.decisions[1:])
    assert lru.tiering["deferred_jobs"] == 0 and lru.tiering["pages_promoted"] > 0


def test_record_windows_tiering_blocks_match_the_reference(monkeypatch):
    """migrate_interference traced through both lanes: every record, the
    tiering block included, equal record for record; the traces' schema is
    the reference's (tests/test_batched_tiering.py's check) and
    serializes."""
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    over = {"sim_ns": 60_000.0}
    ref = ref_run_scenario("migrate_interference", over, trace=True, lane="batched")
    rows, traces = run_scenario("migrate_interference", over, device="cpu", trace=True)
    assert rows == ref.rows
    assert len(traces) == len(ref.traces) == 1
    for cp, cr in zip(traces, ref.traces):
        assert cp["cell"] == cr["cell"]
        assert len(cp["jobs"]) == len(cr["jobs"]) == 3
        for jp, jr in zip(cp["jobs"], cr["jobs"]):
            assert jp["job"] == jr["job"] and jp["workloads"] == jr["workloads"]
            assert len(jp["windows"]) == len(jr["windows"]) == 6
            for rp, rr in zip(jp["windows"], jr["windows"]):
                assert list(rp) == list(rr)
                _same_record(rp, rr)
    tiered = [j for j in traces[0]["jobs"] if any("tiering" in w for w in j["windows"])]
    assert len(tiered) == 2
    for j in tiered:
        for rec in j["windows"]:
            assert set(_GOLDEN_KEYS) <= set(rec["tiering"])
    assert any(rec["tiering"]["promoted"] or rec["tiering"]["migrated_bytes"]
               for j in tiered for rec in j["windows"])
    json.dumps(traces)


def test_trace_cli_writes_the_traces(tmp_path, capsys):
    path = tmp_path / "trace.json"
    sweep_cli.main(["tiering_policies", "--set", "platform=A", "--set", "sim_ns=40000",
                    "--device", "cpu", "--trace", str(path)])
    traces = json.loads(path.read_text())
    assert [t["cell"]["policy"] for t in traces] == ["static", "hotness_lru"]
    for t in traces:
        (job,) = t["jobs"]
        assert job["workloads"] == ["app"]
        assert len(job["windows"]) == 4 and all("tiering" in w for w in job["windows"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("platform,policy") and len(out) == 3


def test_trace_is_for_grid_scenarios_only():
    with pytest.raises(ValueError, match="run_cell"):
        run_scenario("fig11_llm", device="cpu", trace=True)
    rows = run_scenario("tiering_policies", {"platform": "A", "sim_ns": 20_000.0},
                        device="cpu")
    assert isinstance(rows, list) and len(rows) == 2


def test_host_traffic_counts_of_a_tiering_group():
    """One tiering pass per fired window; the window's completions come
    with the ladder's outputs (one copy a fired window), and the live
    tables go back only in windows where the pass changed them."""
    COUNTS.reset()
    run_scenario("migrate_interference", {"sim_ns": 60_000.0}, device="cpu")
    assert COUNTS.windows == 6 and COUNTS.tiering_steps == 6
    assert COUNTS.host_copies == 6 + 1  # one a window, one at the end
    assert 0 < COUNTS.uploads <= 6 and COUNTS.tiering_s > 0.0
    COUNTS.reset()
    run_scenario("tiering_policies", {"platform": "A", "policy": "static",
                                      "sim_ns": 60_000.0}, device="cpu")
    # No ladder: a copy of its own a window.  The static placement moves no
    # page and keeps the migration workloads gated: the routing changes
    # only where the drifting hot set's weights sum differently.
    assert COUNTS.tiering_steps == 6 and COUNTS.host_copies == 6 + 1
    assert COUNTS.uploads < 6


def test_a_foreign_policy_is_refused_by_name(monkeypatch):
    class Foreign:
        name = "foreign"

        def decide(self, pagemap, ctx):
            return []

    class Chasing(HotnessLRUPolicy):
        name = "chasing"

    monkeypatch.setitem(POLICIES, "foreign", Foreign)
    monkeypatch.setitem(POLICIES, "chasing", Chasing)
    wls = [bw_test("ddr", OpClass.LOAD, 4, name="app")]

    def job(policy):
        spec = TieringSpec(regions=(RegionSpec("app", 64, {"cxl": 1.0}),), policy=policy)
        return SimJob(platform=PLATFORMS["A"], workloads=wls, sim_ns=20_000.0,
                      tiering=spec)

    # The scalar DES runs it (the reference's fallback), bit for bit.
    (fell,) = run_sweep_batched([job("foreign")], device="cpu")
    (scalar,) = run_sweep([job("foreign")], lane="scalar")
    assert fell.tiering == scalar.tiering and fell.tiering["policy"] == "foreign"
    assert fell.stats["app"].latency_samples == scalar.stats["app"].latency_samples
    with pytest.raises(ValueError, match="foreign"):
        build_tiering(BatchGroup([(0, plan_cell(job("foreign")))]))
    # A subclass of a vectorized policy runs as that policy, as in the
    # reference's twin.
    (res,) = run_sweep_batched([job("chasing")], device="cpu")
    assert res.tiering["policy"] == "chasing" and res.tiering["pages_promoted"] > 0
    with pytest.raises(ValueError, match="unknown tiering policy"):
        plan_cell(job("bogus"))
