"""The port's roofline (``repro_torch.roofline``) against the reference's.

* ``count_costs`` counts a product's FLOPs exactly (2·M·N·K, as
  ``tests/test_roofline.py``), and a sharded product at its local shapes
  (where ``FlopCounterMode`` over DTensors counts the global product), with
  each collective's result buffer times the ring factor, by kind and by
  mesh axis.
* K1's and K4's counts are their bound formulas; K1's fake rule counts
  every position the window admits.
* ``roofline_from_cell`` with ``V5E`` and the reference ``HloCost``'s
  numbers gives the reference's terms; ``model_flops`` equals the
  reference's for every arch and shape; the H100 model divides collective
  bytes by their mesh axis's link.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.roofline import analysis as ref_analysis
from repro.roofline.hlo_costs import HloCost
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distributed.autosharding import distribute_local
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.analysis import H100_SXM, V5E, model_flops, roofline_from_cell
from repro_torch.roofline.op_costs import (
    OpCost,
    count_costs,
    decode_attention_cost,
    ssd_scan_cost,
)


@pytest.fixture
def mesh():
    """A (2, 2) mesh over a fake process group of 4 ranks (this process is
    rank 0); fake collectives move no data, so only shapes are read."""
    with fake_process_group(4):
        yield make_mesh((2, 2), ("data", "model"), "cpu")


def test_product_flops_exact():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    with count_costs() as c:
        a @ b
    assert c.flops == 2 * 64 * 128 * 32
    assert c.bytes_min == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert c.bytes == c.bytes_min


def test_batched_product_and_elementwise_bytes():
    a, b = torch.zeros(3, 8, 16), torch.zeros(3, 16, 4)
    with count_costs() as c:
        y = torch.bmm(a, b)
        torch.relu(y)
    assert c.flops == 2 * 3 * 8 * 16 * 4
    # relu moves its input and output; only the product is in bytes_min
    assert c.bytes - c.bytes_min == 2 * 3 * 8 * 4 * 4


def test_sharded_product_counts_local_shapes(mesh):
    a = distribute_local(torch.zeros(8, 16), mesh, (Shard(0), Replicate()))
    b = distribute_local(torch.zeros(16, 32), mesh, (Replicate(), Shard(1)))
    with FlopCounterMode(display=False) as global_count:
        a @ b
    with count_costs(mesh) as c:
        y = a @ b
    assert y.to_local().shape == (4, 16)
    # FlopCounterMode sees the global product; the device runs a quarter.
    assert global_count.get_total_flops() == 2 * 8 * 16 * 32
    assert c.flops == 2 * 4 * 16 * 16 == global_count.get_total_flops() / 4


def test_collectives_by_kind_and_axis(mesh):
    y = distribute_local(torch.zeros(8, 32), mesh, (Shard(0), Shard(1)))
    with count_costs(mesh) as c:
        y.redistribute(mesh, (Replicate(), Replicate()))
    # all-gather over model: [4, 32] f32; then over data: [8, 32] f32
    assert c.collective_bytes["all-gather"] == (4 * 32 + 8 * 32) * 4
    assert c.axis_bytes == {"model": 4 * 32 * 4, "data": 8 * 32 * 4}
    p = DTensor.from_local(torch.zeros(4, 16), mesh, (Replicate(), Partial()), run_check=False)
    with count_costs(mesh) as c:
        p.redistribute(mesh, (Replicate(), Replicate()))
    # all-reduce over model: ring factor 2 on the [4, 16] f32 buffer
    assert c.collective_bytes["all-reduce"] == 2 * 4 * 16 * 4
    assert c.axis_bytes == {"model": 2 * 4 * 16 * 4}
    assert c.total_collective == 2 * 4 * 16 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_counts_its_bound_formula(dtype):
    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, dh, s = 3, 8, 2, 32, 64
    q = torch.randn(b, hq, dh, generator=gen).to(dtype)
    k = torch.randn(b, s, hkv, dh, generator=gen).to(dtype)
    lengths = torch.tensor([64, 5, 30], dtype=torch.int32)
    with count_costs() as c:
        out = ops.decode_attention(q, k, k, lengths, window=20)
    nbytes, flops = decode_attention_cost((b, hkv, hq // hkv, dh), (b, hkv, s, dh),
                                          k.element_size(), [64, 5, 30], 20)
    assert (c.flops, c.bytes, c.bytes_min) == (flops, nbytes, nbytes)
    assert c.kernel_calls == {"decode_attention": 1}
    valid = 20 + 5 + 20
    assert flops == 4 * valid * hkv * (hq // hkv) * dh
    assert out.shape == (b, hq, dh)


def test_k1_fake_rule_counts_every_admitted_position():
    with FakeTensorMode():
        q = torch.empty(4, 32, 128, dtype=torch.bfloat16)
        k = torch.empty(4, 1024, 8, 128, dtype=torch.bfloat16)
        with count_costs() as c:
            out = ops.decode_attention(q, k, k, torch.empty(4, dtype=torch.int32))
    assert out.shape == (4, 32, 128)
    assert c.flops == decode_attention_cost((4, 8, 4, 128), (4, 8, 1024, 128), 2, None)[1]
    assert c.flops == 4 * 4 * 1024 * 8 * 4 * 128


@pytest.mark.parametrize("s, chunk", [(64, 16), (50, 16), (8, 128)])
def test_k4_counts_its_bound_formula(s, chunk):
    gen = torch.Generator().manual_seed(1)
    b, h, p, n = 2, 3, 16, 16
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen)
    bm, cm = torch.randn(b, s, n, generator=gen), torch.randn(b, s, n, generator=gen)
    a = -torch.rand(h, generator=gen)
    with count_costs() as c:
        y, state = ops.ssd_scan(x, dt, bm, cm, a, chunk=chunk)
    nbytes, flops = ssd_scan_cost(b, s, h, p, n, chunk, 4)
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert c.kernel_calls == {"ssd_scan": 1}
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)


def test_k4_fake_rule_shapes():
    with FakeTensorMode():
        x = torch.empty(2, 4096, 80, 64, dtype=torch.bfloat16)
        bm = torch.empty(2, 4096, 128, dtype=torch.bfloat16)
        y, state = ops.ssd_scan(x, torch.empty(2, 4096, 80), bm, bm, torch.empty(80))
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert state.shape == (2, 80, 64, 128) and state.dtype == torch.float32


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_terms_equal_reference(arch, shape):
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    assert model_flops(spec, SHAPES[shape]) == ref_analysis.model_flops(ref_spec,
                                                                        REF_SHAPES[shape])
    numbers = dict(flops=3.1e14, bytes=2.2e12)
    coll = {"all-reduce": 1e9, "all-gather": 2e9, "reduce-scatter": 5e8, "all-to-all": 0.0,
            "collective-permute": 0.0}
    want = ref_analysis.roofline_from_cell(ref_spec, REF_SHAPES[shape], "pod16x16", 256,
                                           HloCost(collective_bytes=dict(coll), **numbers))
    got = roofline_from_cell(spec, SHAPES[shape], "pod16x16", 256,
                             OpCost(collective_bytes=dict(coll), **numbers), hw=V5E)
    for field in ("compute_s", "memory_s", "collective_s", "model_flops", "hlo_flops_per_dev",
                  "n_devices"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=1e-12), field
    for prop in ("dominant", "bound_s", "useful_flops_ratio", "roofline_fraction"):
        assert getattr(got, prop) == pytest.approx(getattr(want, prop), rel=1e-12), prop


def test_h100_links_by_mesh_axis():
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.peak_flops_f32) == \
        (989e12, 3.35e12, 67e12)
    cost = OpCost(flops=989e12, bytes=3.35e12,
                  collective_bytes={"all-gather": 500e9, "all-reduce": 0.0},
                  axis_bytes={"model": 450e9, "data": 50e9})
    terms = roofline_from_cell(get_arch("llama31-8b"), SHAPES["decode_32k"], "32x8", 256,
                               cost, hw=H100_SXM)
    assert (terms.compute_s, terms.memory_s) == (1.0, 1.0)
    assert terms.collective_s == pytest.approx(2.0)  # 1 s on NVLink + 1 s on InfiniBand
    assert terms.dominant == "collective"
    # The fraction divides by the chosen hardware's peak, not the v5e's.
    ideal = terms.model_flops / (256 * H100_SXM.peak_flops)
    assert terms.roofline_fraction == pytest.approx(ideal / 2.0)
    assert np.isclose(terms.useful_flops_ratio, terms.model_flops / (989e12 * 256))


def test_fake_process_group_moves_no_data():
    """Pins the private ``fake`` backend's behaviour the dry run relies on:
    collectives return buffers of the right shape without communicating,
    and the group can be destroyed and made again at another size."""
    for world in (8, 16):
        with fake_process_group(world):
            assert dist.get_world_size() == world and dist.get_rank() == 0
            out = torch.empty(world * 3)
            dist.all_gather_into_tensor(out, torch.ones(3))
            assert out.shape == (world * 3,)
        assert not dist.is_initialized()
