"""Port parity: the reference's simulated TPU host (``PLATFORMS["TPU"]``, in
512 B bursts), the device-model helpers, and the tier layout and placement
of repro_torch.core.tiers, against repro.core on the CPU.

``fig3_bandwidth`` and ``fig5_corun`` at ``platform=TPU`` run the same DES
in both packages, so the scalar lane's rows are equal bit for bit; the
port's batched lane equals the reference's batched lane at rel 1e-6 and
stays within the reference's bounds of the scalar DES (tests/test_batched.py:
worst 15 %, mean 3 % over the bandwidth columns)."""

import dataclasses

import pytest
import torch

import repro.core.device_model as ref_dm
import repro.core.tiers as ref_tiers
import repro.scenarios as R
from repro.core.littles_law import OpClass as RefOp
from repro_torch.core import device_model as dm
from repro_torch.core import tiers
from repro_torch.core.littles_law import OpClass
from repro_torch.scenarios import run_scenario

torch.set_num_threads(1)

WORST, MEAN = 0.15, 0.03


def _fields(pm):
    out = {f.name: getattr(pm, f.name) for f in dataclasses.fields(pm)}
    for k in ("ddr", "cxl"):
        out[k] = dataclasses.astuple(out[k])
    out["extra_tiers"] = [dataclasses.astuple(d) for d in out["extra_tiers"]]
    return out


def test_tpu_platform_equals_the_reference_field_by_field():
    got, want = dm.PLATFORMS["TPU"], ref_dm.PLATFORMS["TPU"]
    assert _fields(got) == _fields(want)
    assert _fields(dm.tpu_host_platform(8)) == _fields(ref_dm.tpu_host_platform(8))
    for d, r in ((dm.TPU_HBM, ref_dm.TPU_HBM), (dm.TPU_HOST, ref_dm.TPU_HOST)):
        assert dataclasses.astuple(d) == dataclasses.astuple(r)
        assert d.access_bytes == dm.TPU_BURST == ref_dm.TPU_BURST == 512
    assert list(dm.PLATFORMS)[:7] == list(ref_dm.PLATFORMS)[:7]


@pytest.mark.parametrize("name", ["A", "B", "A-switch", "A-numa", "TPU"])
def test_device_helpers_equal_the_reference(name):
    got, want = dm.PLATFORMS[name], ref_dm.PLATFORMS[name]
    for d, r in zip(got.tiers, want.tiers):
        for op, rop in zip(OpClass, RefOp):
            assert d.unloaded_latency_ns(op) == r.unloaded_latency_ns(rop)
        assert got.tier_index(d.tier) == want.tier_index(r.tier)
    with pytest.raises(dm.UnknownTierError) as ex:
        got.tier_index("nvme")
    with pytest.raises(ref_dm.UnknownTierError) as ref_ex:
        want.tier_index("nvme")
    assert str(ex.value) == str(ref_ex.value)


def _bandwidths(rows):
    return [v for r in rows for k, v in r.items() if k.endswith("_gbps")]


@pytest.mark.parametrize("name", ["fig3_bandwidth", "fig5_corun"])
def test_tpu_platform_scenarios_equal_the_reference(name, monkeypatch):
    monkeypatch.delenv("REPRO_BATCH_BACKEND", raising=False)
    over = {"platform": "TPU"}
    scalar = run_scenario(name, over, device="cpu", lane="scalar")
    assert scalar.rows == R.run_scenario(name, over, lane="scalar").rows
    assert {r["platform"] for r in scalar.rows} == {"TPU"}
    batched = run_scenario(name, over, device="cpu")
    ref = R.run_scenario(name, over, lane="batched")
    assert batched.meta == ref.meta and batched.meta["scalar_fallback_jobs"] == 0
    for p, r in zip(batched.rows, ref.rows):
        assert p == pytest.approx(r, rel=1e-6)
    errs = [abs(b - s) / max(s, 1e-9)
            for b, s in zip(_bandwidths(batched.rows), _bandwidths(scalar.rows))]
    assert max(errs) < WORST and sum(errs) / len(errs) < MEAN


@pytest.mark.parametrize("total,hot,page", [
    (10_000, 2_000, 1024), (4096, 4096, 2048), (32_768, 1, 2048), (5_000, 1_000, 7),
])
def test_tiered_layout_equals_the_reference(total, hot, page):
    got = tiers.TieredLayout(total, hot, page)
    want = ref_tiers.TieredLayout(total, hot, page)
    assert (got.cold_tokens, got.n_cold_pages) == (want.cold_tokens, want.n_cold_pages)
    assert [got.page_slice(i) for i in range(got.n_cold_pages)] == \
        [want.page_slice(i) for i in range(want.n_cold_pages)]
    for heads, dh, layers, nbytes in ((8, 128, 32, 2), (2, 64, 4, 4)):
        assert got.bytes_per_token(heads, dh, layers, nbytes) == \
            want.bytes_per_token(heads, dh, layers, nbytes)
        assert got.cold_bytes(heads, dh, layers, nbytes) == \
            want.cold_bytes(heads, dh, layers, nbytes)
    with pytest.raises(AssertionError):
        tiers.TieredLayout(total, 0, page)


def test_tier_helpers_equal_the_reference():
    for t, r in ((tiers.HBM_TIER, ref_tiers.HBM_TIER), (tiers.HOST_TIER, ref_tiers.HOST_TIER)):
        assert t.memory_kind == r.memory_kind
        assert (t.name, t.bandwidth_gbps, t.capacity_gib, t.parallelism) == \
            (r.name, r.bandwidth_gbps, r.capacity_gib, r.parallelism)
        for n in (0, 4096, 1 << 30):
            assert tiers.estimate_fetch_ns(n, t) == ref_tiers.estimate_fetch_ns(n, r)
    x = torch.zeros(3, 5, dtype=torch.bfloat16)
    assert tiers.np_bytes(x) == 30 == ref_tiers.np_bytes(x.float().numpy()) // 2
    assert (tiers.DEVICE, tiers.PINNED_HOST) == (ref_tiers.DEVICE, ref_tiers.PINNED_HOST)


def test_put_on_tier_on_the_cpu_keeps_a_plain_tensor():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for tier in (tiers.HBM_TIER, tiers.HOST_TIER):
        y = tiers.put_on_tier(x, tier, "cpu")
        assert y.device.type == "cpu" and not y.is_pinned()
        assert torch.equal(y, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiers.put_on_tier(x, tiers.HOST_TIER)  # the card by default; none here
