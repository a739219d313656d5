"""The port's scalar lane in use: the batched lane's fallback to it, the
batched lane held within the reference's bounds of it, ``fig2_tiering`` on
it, and its process pool.  Every comparison is against the reference's own
scalar lane or the port's, on the CPU."""

import pytest
import torch

from repro.core.device_model import platform_a as ref_platform_a
from repro.core.littles_law import OpClass as RefOp
from repro.memsim.sweep import SimJob as RefJob
from repro.memsim.sweep import run_sweep as ref_run_sweep
from repro.memsim.workloads import bw_test as ref_bw_test
from repro.scenarios import run_scenario as ref_run_scenario
from repro.tiering import HotSetPattern as RefPattern
from repro.tiering import RegionSpec as RefRegion
from repro.tiering import TieringSpec as RefSpec
from repro.tiering.policies import POLICIES as REF_POLICIES
from repro_torch.core.device_model import platform_a
from repro_torch.core.littles_law import OpClass
from repro_torch.memsim.batched import fluid
from repro_torch.memsim.batched.lane import partition_jobs, run_sweep_batched
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.memsim.workloads import bw_test
from repro_torch.scenarios import run_scenario
from repro_torch.tiering import HotSetPattern, RegionSpec, TieringSpec
from repro_torch.tiering.policies import POLICIES
from test_torch_des import assert_same_result

torch.set_num_threads(1)

_OPS = (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE)


class FrozenPolicy:
    """tests/test_batched.py's policy outside the vectorized hierarchy: the
    scalar hook runs it, the vector twin cannot."""

    name = "frozen_test_policy"

    def decide(self, pagemap, ctx):
        del pagemap, ctx
        return []


def _frozen_job(Job, P, bw, Op, Spec, Region, Pattern):
    spec = Spec(regions=(Region(workload="cxl", n_pages=128, placement={"cxl": 1.0},
                                pattern=Pattern()),),
                policy=FrozenPolicy.name)
    return Job(platform=P(), workloads=[bw("cxl", Op.LOAD, 4, name="cxl")],
               sim_ns=60_000.0, tiering=spec)


def _corun_job(Job, P, bw, op, miku, sim_ns=300_000.0, threads=16):
    wls = [bw("ddr", op, threads, name="ddr", miku_managed=False),
           bw("cxl", op, threads, name="cxl")]
    return Job(platform=P(), workloads=wls, sim_ns=sim_ns, miku=miku)


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setitem(POLICIES, FrozenPolicy.name, FrozenPolicy)
    monkeypatch.setitem(REF_POLICIES, FrozenPolicy.name, FrozenPolicy)


def test_unstackable_policy_falls_back_to_the_scalar_des(frozen):
    """tests/test_batched.py::test_dynamic_stacking_failure_is_recorded_and_runs_scalar
    on the port: the fallback is recorded with the policy's name and its
    result is the scalar DES's, bit for bit, and the reference's."""
    job = _frozen_job(SimJob, platform_a, bw_test, OpClass, TieringSpec, RegionSpec,
                      HotSetPattern)
    plans, fallbacks = partition_jobs([job])
    assert not fallbacks  # the plan itself is fine
    (b,) = run_sweep_batched([job], device="cpu", partition=(plans, fallbacks))
    assert [i for i, _ in fallbacks] == [0]
    assert "frozen_test_policy" in fallbacks[0][1]
    (s,) = run_sweep([job], lane="scalar")
    assert_same_result(b, s)
    (r,) = ref_run_sweep([_frozen_job(RefJob, ref_platform_a, ref_bw_test, RefOp, RefSpec,
                                      RefRegion, RefPattern)], lane="scalar")
    assert_same_result(b, r)
    assert b.tiering["policy"] == "frozen_test_policy"


def test_group_mates_of_a_fallback_stay_batched(frozen):
    jobs = [_frozen_job(SimJob, platform_a, bw_test, OpClass, TieringSpec, RegionSpec,
                        HotSetPattern),
            _corun_job(SimJob, platform_a, bw_test, OpClass.LOAD, True, sim_ns=30_000.0),
            _corun_job(SimJob, platform_a, bw_test, OpClass.STORE, True, sim_ns=30_000.0)]
    plans, fallbacks = partition_jobs(jobs)
    fluid.COUNTS.reset()
    mixed = run_sweep_batched(jobs, device="cpu", partition=(plans, fallbacks))
    assert [i for i, _ in fallbacks] == [0]
    assert fluid.COUNTS.windows > 0
    alone = run_sweep_batched(jobs[1:], device="cpu")
    scalar = run_sweep(jobs, lane="scalar")
    assert_same_result(mixed[0], scalar[0])
    for m, a, s in zip(mixed[1:], alone, scalar[1:]):
        assert m.stats["ddr"].bytes == a.stats["ddr"].bytes
        assert m.stats["cxl"].bytes == a.stats["cxl"].bytes
        assert m.stats["cxl"].bytes != s.stats["cxl"].bytes  # fluid, not the DES
    assert all(r is not None for r in mixed)


def test_peredge_is_refused_on_both_lanes():
    wls = [bw_test(t, OpClass.LOAD, 4, name=t) for t in ("ddr", "cxl")]
    job = SimJob(platform=platform_a(), workloads=wls, sim_ns=20_000.0, miku=True,
                 miku_law="peredge")
    for lane in ("scalar", "batched"):
        with pytest.raises(NotImplementedError, match="A.4.2"):
            run_sweep([job], lane=lane, device="cpu")


# -- the batched lane within the reference's bounds of the scalar DES ------------


@pytest.fixture(scope="module")
def lanes():
    """tests/test_batched.py:172-206's five jobs (racing co-runs of the three
    ops, MIKU co-runs of load and store) on the port's scalar DES and on its
    batched lane (one stacked call: two groups)."""
    jobs = ([_corun_job(SimJob, platform_a, bw_test, op, False) for op in _OPS]
            + [_corun_job(SimJob, platform_a, bw_test, op, True)
               for op in (OpClass.LOAD, OpClass.STORE)])
    return dict(zip(["racing_" + op.value for op in _OPS] + ["miku_load", "miku_store"],
                    zip(run_sweep(jobs, lane="scalar"), run_sweep(jobs, device="cpu"))))


@pytest.mark.parametrize("op", _OPS)
def test_racing_corun_batched_within_bounds_of_scalar(lanes, op):
    """tests/test_batched.py::test_corun_racing_equivalence's bounds, the
    port's batched lane against the port's DES."""
    s, b = lanes["racing_" + op.value]
    for w in ("ddr", "cxl"):
        assert b.bandwidth(w) == pytest.approx(s.bandwidth(w), rel=0.05)
    assert b.tier_counters["cxl"].mean_service_time == pytest.approx(
        s.tier_counters["cxl"].mean_service_time, rel=0.1)


@pytest.mark.parametrize("op", ["load", "store"])
def test_miku_corun_batched_within_bounds_of_scalar(lanes, op):
    """tests/test_batched.py::test_corun_miku_equivalence's bounds."""
    s, b = lanes["miku_" + op]
    assert b.bandwidth("ddr") == pytest.approx(s.bandwidth("ddr"), rel=0.05)
    assert b.bandwidth("cxl") == pytest.approx(s.bandwidth("cxl"), rel=0.10)
    assert len(b.decisions) == len(s.decisions)
    rs = sum(1 for d in s.decisions if d.restricted)
    rb = sum(1 for d in b.decisions if d.restricted)
    assert abs(rs - rb) <= 3 and rs > 0


# -- fig2_tiering, the grid scenarios on the scalar lane, the pool -----------------


def test_fig2_rows_equal_the_reference():
    overrides = {"op": "load"}
    rows = run_scenario("fig2_tiering", overrides, device="cpu")
    assert rows == ref_run_scenario("fig2_tiering", overrides).rows
    (row,) = rows
    assert (row["upper_ddr_only"], row["lower_cxl_only"]) == (255.5904, 49.6384)
    assert row["ideal_combined"] > row["os_managed"] > row["native"]


def test_grid_scenario_on_the_scalar_lane_equals_the_reference():
    overrides = {"threads": (2,), "mlp": (160,), "sim_ns": 60_000.0}
    rows = run_scenario("corun_sweep", overrides, device="cpu", lane="scalar")
    assert rows == ref_run_scenario("corun_sweep", overrides, lane="scalar").rows


def test_pool_equals_serial():
    jobs = [_corun_job(SimJob, platform_a, bw_test, op, miku, sim_ns=40_000.0, threads=8)
            for op, miku in ((OpClass.LOAD, True), (OpClass.STORE, False),
                             (OpClass.NT_STORE, True))]
    serial = run_sweep(jobs, lane="scalar")
    pooled = run_sweep(jobs, lane="scalar", processes=2)
    for p, s in zip(pooled, serial):
        assert_same_result(p, s)
