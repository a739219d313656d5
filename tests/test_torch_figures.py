"""Port parity: the paper's grid figures (fig3-fig10 and loaded_latency) on
the port's batched lane against the reference's batched lane, on the CPU.

Each scenario runs at its defaults through both registries (the reference
with REPRO_BATCH_BACKEND unset: its numpy lane, every job batched).  Job
by job, a cell on the exact lane (the closed form) must give the same
bandwidth, completed counts, ToR inserts and timeline buckets, and its
occupancy and latency integrals within rel 1e-9 (tests/test_batched.py's
bound); a fluid cell must stay within rel 1e-6 with the same restricted
windows; a p95 read from a latency histogram within the histogram's 1/16
bucket width.  Also here: the exact regime routes the reference's cells,
the histogram and MVA copies, the registry and the scenario CLI."""

import math
import pathlib
import sys

import pytest
import torch

import repro.memsim.batched as ref_batched
from repro.core.device_model import PLATFORMS as REF_PLATFORMS
from repro.core.littles_law import OpClass as RefOp
from repro.core.mva import analyze as ref_analyze
from repro.memsim.batched.exact import exact_regime as ref_exact_regime
from repro.memsim.batched.stacking import plan_cell as ref_plan_cell
from repro.obs.histogram import LatencyHistogram as RefHistogram
from repro.scenarios import plan as ref_plan
from repro.scenarios import run_scenario as ref_run_scenario
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.littles_law import OpClass
from repro_torch.core.mva import analyze
from repro_torch.memsim.batched.exact import exact_regime
from repro_torch.memsim.batched.stacking import plan_cell
from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.scenarios import SCENARIOS, plan, planner, run_scenario

# Tiny tensors: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

GRID = ("fig3_bandwidth", "fig4_latency", "loaded_latency", "fig5_corun",
        "fig6_tor_correlation", "fig7_llc", "fig8_sync", "fig9_service", "fig10_miku")
HIST_REL = 1 / 16  # a histogram bucket's relative width


def _restricted(res):
    return sum(1 for d in res.decisions if d.restricted)


def _run_both(name, monkeypatch):
    """(reference rows, port rows, [(port job, reference result, port
    result)]) of one scenario at its defaults."""
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    got = {}
    ref_lane, port_sweep = ref_batched.run_sweep_batched, planner.run_sweep

    def ref_record(jobs, *args, **kwargs):
        got["ref"] = ref_lane(jobs, *args, **kwargs)
        return got["ref"]

    def port_record(jobs, **kwargs):
        got["jobs"], got["port"] = jobs, port_sweep(jobs, **kwargs)
        return got["port"]

    monkeypatch.setattr(ref_batched, "run_sweep_batched", ref_record)
    monkeypatch.setattr(planner, "run_sweep", port_record)
    table = ref_run_scenario(name, lane="batched")
    assert table.meta["scalar_fallback_jobs"] == 0
    rows = run_scenario(name, device="cpu").rows
    assert len(got["ref"]) == len(got["port"]) == len(got["jobs"])
    return table.rows, rows, list(zip(got["jobs"], got["ref"], got["port"]))


def _assert_hist(p, r):
    if r is None:
        assert p is None
        return
    assert p.n == pytest.approx(r.n, rel=1e-9)
    for q in (0.5, 0.95, 0.99):
        assert p.percentile(q) == pytest.approx(r.percentile(q), rel=HIST_REL, nan_ok=True)


def _assert_job(job, r, p):
    exact = exact_regime(plan_cell(job)) is not None
    rel = 1e-9 if exact else 1e-6
    assert p.stats.keys() == r.stats.keys()
    for w, rs in r.stats.items():
        ps = p.stats[w]
        if exact:
            assert ps.completed == rs.completed and ps.bytes == rs.bytes
            assert p.bandwidth(w) == r.bandwidth(w)
            assert ps.timeline == rs.timeline
        else:
            assert p.bandwidth(w) == pytest.approx(r.bandwidth(w), rel=rel)
            assert [t for t, _ in ps.timeline] == [t for t, _ in rs.timeline]
        assert ps.latency_sum == pytest.approx(rs.latency_sum, rel=rel)
        _assert_hist(ps.latency_hist, rs.latency_hist)
    assert p.tor_inserts == r.tor_inserts and p.tor_peak == r.tor_peak
    assert p.tor_occupancy_integral == pytest.approx(r.tor_occupancy_integral, rel=rel)
    for t, rc in r.tier_counters.items():
        assert p.tier_counters[t].inserts == rc.inserts
        assert p.tier_counters[t].occupancy_time == pytest.approx(rc.occupancy_time, rel=rel)
        assert p.per_tier_occupancy_integral[t] == pytest.approx(
            r.per_tier_occupancy_integral[t], rel=rel)
    assert _restricted(p) == _restricted(r) and len(p.decisions) == len(r.decisions)
    if r.tier_latency_hist is None:
        assert p.tier_latency_hist is None
    else:
        for t, h in r.tier_latency_hist.items():
            _assert_hist(p.tier_latency_hist[t], h)
    return exact


def check_grid_scenario(name, monkeypatch):
    """Every job and every row of ``name`` against the reference."""
    ref_rows, rows, jobs = _run_both(name, monkeypatch)
    n_exact = sum(_assert_job(*j) for j in jobs)
    if name == "fig4_latency":
        assert n_exact == len(jobs)  # every lat-test cell is closed form
    assert len(rows) == len(ref_rows) > 0
    for r, p in zip(ref_rows, rows):
        assert list(p) == list(r)
        for key, want in r.items():
            if not isinstance(want, float):
                assert p[key] == want, key
            elif key == "p95_ns":
                assert p[key] == pytest.approx(want, rel=HIST_REL), key
            else:
                assert p[key] == pytest.approx(want, rel=1e-6), key
            assert not isinstance(p[key], float) or math.isfinite(p[key])


# fig10_miku, the heaviest, runs from tests/test_torch_fig10.py so that
# parallel workers share the load.
@pytest.mark.parametrize("name", [n for n in GRID if n != "fig10_miku"])
def test_grid_scenario_matches_reference_batched_lane(name, monkeypatch):
    check_grid_scenario(name, monkeypatch)


@pytest.mark.parametrize("name", GRID)
def test_exact_regime_routes_the_reference_cells(name):
    ref_jobs = [j for _, _, js in ref_plan(name) for j in js]
    jobs = [j for _, _, js in plan(name) for j in js]
    assert len(jobs) == len(ref_jobs)
    want = [ref_exact_regime(ref_plan_cell(j)) for j in ref_jobs]
    assert [exact_regime(plan_cell(j)) for j in jobs] == want


def test_histogram_copy_matches_reference():
    vals = [float(x) for x in torch.rand(3000, generator=torch.Generator().manual_seed(4))
            * 900.0 + 40.0]
    for sample in (vals, vals[:300]):  # the numpy road and the loop
        h, rh = LatencyHistogram.from_samples(sample), RefHistogram.from_samples(sample)
        assert h.counts == rh.counts and (h.n, h.total, h.vmin, h.vmax) == (
            rh.n, rh.total, rh.vmin, rh.vmax)
        for q in (0.0, 0.3, 0.5, 0.95, 0.99, 1.0):
            assert h.percentile(q) == rh.percentile(q)
    h, rh = LatencyHistogram(), RefHistogram()
    for v, n in ((120.5, 3.25), (88.0, 0.5), (4000.0, 12.0), (0.0, 1.0)):
        h.record_weighted(v, n)
        rh.record_weighted(v, n)
    assert h.counts == rh.counts and h.percentile(0.95) == rh.percentile(0.95)
    assert math.isnan(LatencyHistogram().percentile(0.5))


def test_platforms_of_the_figures_match_reference():
    for name in ("A-1to1", "B-1to1"):
        p, r = PLATFORMS[name], REF_PLATFORMS[name]
        assert p.name == r.name and p.tor_entries == r.tor_entries
        for tier in ("ddr", "cxl"):
            for op in OpClass:
                assert p.device_for(tier).peak_bandwidth_gbps(op) == \
                    r.device_for(tier).peak_bandwidth_gbps(RefOp(op.value))


MVA_CASES = ([(op, 16, 0) for op in ("load", "store", "nt_store")] + [("load", 0, 16)]
             + [("load", n, 0) for n in (1, 2, 5, 17, 32, 33)]
             + [("load", 0, n) for n in (1, 3, 9, 24, 33)] + [("store", 8, 8)])


@pytest.mark.parametrize("op,fast,slow", MVA_CASES)
def test_mva_analyze_matches_reference(op, fast, slow):
    """tests/test_mva.py's inputs: the saturated 16-thread cases of every op,
    and the thread ladders of its monotonicity properties."""
    r = ref_analyze(REF_PLATFORMS["A"], RefOp(op), fast, slow)
    p = analyze(PLATFORMS["A"], OpClass(op), fast, slow, device="cpu")
    for key in ("throughput_fast", "throughput_slow", "residency_fast", "residency_slow",
                "bandwidth_fast_gbps", "bandwidth_slow_gbps"):
        got = getattr(p, key)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert float(got) == pytest.approx(float(getattr(r, key)), rel=1e-5, abs=1e-30), key


def test_registry_refuses_what_it_cannot_plan():
    with pytest.raises(ValueError, match="run_cell"):
        plan("fig11_llm")
    with pytest.raises(KeyError, match="unknown platform"):
        plan("slo_knee", {"platform": "A-fabricated"})
    with pytest.raises(KeyError, match="unknown scenario"):
        plan("fig99")


def test_sweep_cli_lists_every_scenario(capsys):
    """``--list`` prints benchmarks/run.py's listing: each scenario's name,
    figure, slow mark and title, then its axes (``*`` on a grid axis,
    defaults through ``format_default``) and metrics."""
    from repro_torch.launch.sweep import main

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        from benchmarks.run import _list_scenarios
    finally:
        sys.path.remove(repo)
    main(["--list"])
    out = capsys.readouterr().out
    _list_scenarios()
    assert out == capsys.readouterr().out
    heads = [line for line in out.splitlines() if not line.startswith("    ")]
    assert len(heads) == len(SCENARIOS) == 25
    assert [line.split()[0] for line in heads] == list(SCENARIOS)
    assert heads[0].startswith("fig2_tiering [Fig. 2] — ")
    assert heads[-1].startswith("flash_crowd — ")
    assert "    axes: arch=llama31-8b, " in out


def test_sweep_cli_prints_fig9_rows_on_cpu(capsys):
    from repro_torch.launch.sweep import main

    main(["fig9_service", "--set", "threads=1,2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "platform,tier,threads,service_time_ns,bandwidth_gbps"
    assert len(lines) == 5 and lines[1].startswith("A,ddr,1,")
