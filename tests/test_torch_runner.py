"""Port parity: the figure runners (repro_torch.memsim.runner) against the
reference's (repro.memsim.runner) on the CPU.

The reference's wrappers run its scalar DES (REPRO_SWEEP_LANE unset), so
the port's ``lane="scalar"`` must return the same rows bit for bit; on its
batched lane each wrapper returns what ``run_scenario(...).rows`` gives
with the wrapper's dropped keys.  Small grids and short horizons keep the
file to a few seconds."""

import dataclasses

import pytest
import torch

import repro.memsim.runner as ref_runner
import repro.scenarios as R
import repro_torch.memsim as memsim
import repro_torch.memsim.runner as runner
from repro.core.device_model import platform_a as ref_platform_a
from repro.core.littles_law import OpClass as RefOp
from repro_torch.core.device_model import platform_a
from repro_torch.core.littles_law import OpClass
from repro_torch.scenarios import run_scenario

torch.set_num_threads(1)

#: wrapper -> (its scenario, the wrapper's arguments, the same run as
#: scenario overrides); each drops the platform from the scenario's rows.
CASES = {
    "bandwidth_matrix": ("fig3_bandwidth", {"threads": (1,)}, {"threads": (1,)}),
    "latency_matrix": ("fig4_latency", {"threads": (1, 4)}, {"threads": (1, 4)}),
    "corun_matrix": ("fig5_corun", {"n_threads": 2}, {"n_threads": 2}),
    "llc_partition_sweep": ("fig7_llc", {"wss_mb": 60.0, "allocs": (0.5,)},
                            {"wss_mb": (60.0,), "ddr_share": (0.5,)}),
    "sync_interference": ("fig8_sync", {"bg_threads": (0,)}, {"bg_threads": (0,)}),
    "service_time_curve": ("fig9_service", {"threads": (1, 2)}, {"threads": (1, 2)}),
}


@pytest.fixture(autouse=True)
def _scalar_reference(monkeypatch):
    monkeypatch.delenv("REPRO_SWEEP_LANE", raising=False)
    monkeypatch.delenv("REPRO_SWEEP_PROCS", raising=False)
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_equals_the_reference(name):
    _, kw, _ = CASES[name]
    want = getattr(ref_runner, name)(ref_platform_a(), **kw)
    got = getattr(runner, name)(platform_a(), **kw, device="cpu", lane="scalar")
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_wrapper_returns_the_scenario_rows(name):
    scenario, kw, over = CASES[name]
    got = getattr(runner, name)(platform_a(), **kw, device="cpu")
    rows = run_scenario(scenario, {"platform": platform_a(), **over}, device="cpu").rows
    assert got == [{k: v for k, v in r.items() if k != "platform"} for r in rows]


def test_tiering_schemes_equals_the_reference():
    want = ref_runner.tiering_schemes(ref_platform_a(), RefOp.LOAD)
    got = runner.tiering_schemes(platform_a(), OpClass.LOAD, device="cpu", lane="scalar")
    assert got == want and "platform" not in got and "op" not in got


def test_tor_correlation_equals_the_reference():
    want = ref_runner.tor_insert_bandwidth_correlation(ref_platform_a())
    got = runner.tor_insert_bandwidth_correlation(platform_a(), device="cpu", lane="scalar")
    assert got == want
    assert runner.tor_insert_bandwidth_correlation(platform_a(), device="cpu") == \
        pytest.approx(want, abs=1e-3)


def test_miku_comparison_equals_the_reference_field_by_field():
    kw = dict(n_threads=2, period_ns=20_000.0, cycles=1)
    want = ref_runner.miku_comparison(ref_platform_a(), RefOp.LOAD, **kw)
    got = runner.miku_comparison(platform_a(), OpClass.LOAD, **kw, device="cpu",
                                 lane="scalar")
    assert isinstance(got, runner.MikuComparison)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.miku_ddr_frac_of_opt == want.miku_ddr_frac_of_opt
    batched = runner.miku_comparison(platform_a(), OpClass.LOAD, **kw, device="cpu")
    (row,) = run_scenario("fig10_miku", {"platform": platform_a(), "op": "load", **kw},
                          device="cpu").rows
    assert dataclasses.asdict(batched) == {k: v for k, v in row.items() if k != "platform"}


def test_pertier_comparison_equals_the_reference_scenario():
    """The reference's wrapper passes ``op=(op,)`` to corun3_pertier, whose op
    axis is scalar, and its DES raises on the tuple; the port's passes the
    op itself, so it is held to the reference's scenario rows."""
    kw = dict(laws=("racing", "pertier"), n_threads=2, sim_ns=20_000.0)
    with pytest.raises(KeyError):
        ref_runner.pertier_comparison(**kw)
    want = R.run_scenario("corun3_pertier", {"law": kw["laws"], "n_threads": 2,
                                             "sim_ns": 20_000.0}).rows
    got = runner.pertier_comparison(**kw, device="cpu", lane="scalar")
    assert got == want and [r["law"] for r in got] == ["racing", "pertier"]


def test_package_exports_the_reference_names():
    import repro.memsim as ref_memsim

    assert memsim.__all__ == ref_memsim.__all__
    for name in memsim.__all__:
        assert callable(getattr(memsim, name)) or isinstance(getattr(memsim, name), type)
