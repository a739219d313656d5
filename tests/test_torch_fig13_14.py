"""Port parity: fig13_spark and fig14_kv on the port's batched lane against
the reference's, on the CPU, with tests/test_torch_corun3.py's checks; and
the fluid lane's per-window telemetry (``record_windows``) against the
reference batched lane's records on three-tier MIKU cells under each law:
integers equal, floats within rel 1e-6."""

import numpy as np
import pytest
import torch

import repro.memsim.batched as ref_batched
from repro.core.controller import Decision as RefDecision
from repro.core.controller import Phase as RefPhase
from repro.core.controller import TierDecisions as RefTierDecisions
from repro.core.device_model import PLATFORMS as REF_PLATFORMS
from repro.core.littles_law import OpClass as RefOp
from repro.core.littles_law import TierCounters as RefCounters
from repro.core.littles_law import TierEstimate as RefEstimate
from repro.core.littles_law import TierWindow as RefWindow
from repro.core.substrate import WindowRecord as RefRecord
from repro.core.substrate import window_record_jsonable as ref_jsonable
from repro.memsim.sweep import SimJob as RefJob
from repro.memsim.workloads import bw_test as ref_bw_test
from repro_torch.core.controller import Decision, Phase, TierDecisions
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.littles_law import OpClass, TierCounters, TierEstimate, TierWindow
from repro_torch.core.substrate import WindowRecord, window_record_jsonable
from repro_torch.memsim.batched.lane import run_sweep_batched
from repro_torch.memsim.sweep import SimJob
from repro_torch.memsim.workloads import bw_test
from test_torch_corun3 import check_scenario

torch.set_num_threads(1)


def test_fig13_spark_matches_reference_batched_lane(monkeypatch):
    rows = check_scenario("fig13_spark", monkeypatch)
    assert [r["variant"] for r in rows] == ["opt", "racing", "miku"]


def test_fig14_kv_matches_reference_batched_lane(monkeypatch):
    rows = check_scenario("fig14_kv", monkeypatch)
    assert [r["ratio"] for r in rows] == [0, 1, 4]


def _same_record(p, r, path=""):
    """Records equal key for key: integers, strings, bools and None equal,
    floats within rel 1e-6."""
    if isinstance(r, dict):
        assert list(p) == list(r), path
        for k in r:
            _same_record(p[k], r[k], f"{path}/{k}")
    elif isinstance(r, float):
        assert isinstance(p, float), path
        assert p == pytest.approx(r, rel=1e-6, abs=1e-9), path
    else:
        assert type(p) is type(r) and p == r, path


def _telemetry_jobs(Job, P, bw, Op, law, hist):
    """A three-tier MIKU co-run under ``law`` beside a two-tier one and a
    controller-free cell, all recording; one group on the fluid lane."""
    three = [bw(t, Op("store"), 16, name=t, miku_managed=t != "ddr")
             for t in ("ddr", "cxl", "cxl_sw")]
    two = [bw(t, Op("load"), 8, name=t, miku_managed=t != "ddr") for t in ("ddr", "cxl")]
    kw = dict(sim_ns=55_000.0, record_windows=True, latency_hist=hist)
    return [
        Job(platform=P["A-switch"], workloads=three, miku=True, miku_law=law, **kw),
        Job(platform=P["A"], workloads=two, miku=True, miku_law=law, **kw),
        Job(platform=P["A-switch"], workloads=three, **kw),
        Job(platform=P["A-switch"], workloads=three, miku=True, miku_law=law,
            sim_ns=55_000.0),
    ]


@pytest.mark.parametrize("law,hist", [("pertier", False), ("merged", False),
                                      ("pertier", True), ("merged", True)])
def test_record_windows_match_reference_batched_lane(law, hist, monkeypatch):
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    ref = ref_batched.run_sweep_batched(
        _telemetry_jobs(RefJob, REF_PLATFORMS, ref_bw_test, RefOp, law, hist))
    got = run_sweep_batched(_telemetry_jobs(SimJob, PLATFORMS, bw_test, OpClass, law, hist),
                            device="cpu")
    # 5 fired windows of 10 µs (the last 5 µs fire none); the controller-
    # free cell records only with histograms, the fourth asks for none.
    assert [len(r.window_records) for r in got] == [len(r.window_records) for r in ref] \
        == [5, 5, 5 if hist else 0, 0]
    for p, r in zip(got, ref):
        for pr, rr in zip(p.window_records, r.window_records):
            _same_record(pr, rr)
    first = got[0].window_records[3]
    assert list(first["tiers"]) == ["ddr", "cxl", "cxl_sw"]
    if law == "merged":
        assert first["decision"]["cxl"] == first["decision"]["cxl_sw"]


def _window_record(seed, port: bool):
    rng = np.random.default_rng(seed)
    Counters = TierCounters if port else RefCounters
    Op = OpClass if port else RefOp
    tiers = []
    for _ in range(3):
        n = [int(x) for x in rng.integers(0, 400, 4)]
        tiers.append(Counters(sum(n), float(rng.uniform(0, 1e6)), dict(zip(Op, n))))
    est = (TierEstimate if port else RefEstimate)(
        *[float(x) for x in rng.uniform(0, 900, 5)], bool(rng.random() < 0.5), True)
    d = (Decision if port else RefDecision)(
        int(rng.integers(1, 17)), float(rng.uniform(0.1, 1)),
        (Phase if port else RefPhase).RESTRICTED, est)
    td = (TierDecisions if port else RefTierDecisions)(("cxl", "cxl_sw"), (d, d))
    names = ("ddr", "cxl", "cxl_sw")
    window = (TierWindow if port else RefWindow)(tiers, names)
    return [(WindowRecord if port else RefRecord)(seed, 1e4 * seed, delta, dec)
            for delta, dec in ((window, td), (tuple(tiers), d), ("opaque", None))]


@pytest.mark.parametrize("seed", range(3))
def test_window_record_jsonable_matches_reference(seed):
    for p, r in zip(_window_record(seed, True), _window_record(seed, False)):
        assert window_record_jsonable(p) == ref_jsonable(r)
