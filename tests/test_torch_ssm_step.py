"""The SSM decode step's state update in place (``models/ssm.py:ssm_step``,
``kernels/ops.py:ssm_step``, ``kernels/ssm_step.py``), on the CPU.

* ``ssm_step`` updates ``state["h"]`` in place and returns it as the new
  state's ``"h"``; its output and the new state equal the out-of-place step
  the model ran before (restated here), bit for bit, at one group and at
  several, N = 16 and 128.
* The plain version against the recurrence written out in float64.
* A CPU tensor, and a fake tensor (the dry run's), take the plain version
  and launch nothing.
* DTensors, on a one-rank mesh: one layer of a stacked state placed by
  batch, by head (one group and two), by head dim or replicated steps on
  its shard, the stacked state written in place for that layer alone;
  a state sharded along N is refused.  (Four ranks, every leaf sharded:
  ``tests/test_torch_distributed.py``.)
* The kernel's launcher refuses a wrong dtype, a non-contiguous or
  misaligned state, P off the multiples of 16, N not a power of two from
  16 to 128, G not dividing H, and, with everything else right, a CPU
  tensor.

The kernel against the plain version on the card:
``tests/test_torch_ssm_step_card.py``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.invariants import InvariantViolation
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_step as kernel_mod
from repro_torch.models import ssm as ssm_lib

#: (heads, head_dim, state, groups): one group and several, N = 16 and 128.
SHAPES = [(4, 16, 16, 1), (4, 32, 128, 1), (8, 16, 16, 2), (8, 16, 128, 4)]


def _out_of_place_step(params, x, state, dims, eps=1e-6):
    """The decode step as the model ran it before the state was updated in
    place: a new ``h`` out of place, the inputs left as they were."""
    b = x.shape[0]
    rep = dims["n_heads"] // dims["n_groups"]
    z, xbc, dt_raw = ssm_lib._split_proj(params, x, dims)
    window = torch.cat([state["conv"], xbc], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]
    xs, bmat, cmat, dt, a = ssm_lib._prep_inputs(params, conv_out, dt_raw, dims)
    dt1 = dt[:, 0]
    da = torch.exp(dt1 * a)
    b1 = bmat[:, 0].repeat_interleave(rep, dim=1).float()
    c1 = cmat[:, 0].repeat_interleave(rep, dim=1).float()
    x1 = xs[:, 0].float()
    new_h = state["h"] * da[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", dt1[:, :, None] * x1, b1)
    y = torch.einsum("bhpn,bhn->bhp", new_h, c1)
    y = y + params["D"][None, :, None] * x1
    y = y.reshape(b, 1, dims["d_inner"]).to(x.dtype)
    y = ssm_lib._gated_norm(y, z, params["norm"], dims["n_groups"], eps)
    return y @ params["out_proj"], {"h": new_h, "conv": window[:, 1:, :]}


def _layer(heads, head_dim, state, groups, seed):
    dims = ssm_lib.ssm_dims(64, head_dim=head_dim, d_state=state, n_groups=groups,
                            n_heads=heads)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v[0] for k, v in ssm_lib.ssm_init(64, dims, torch.float32, gen,
                                                   torch.device("cpu"), stacked=1).items()}
    # Nonzero norm, bias and per-head values, so every input reaches the output.
    params["norm"] = 1.0 + 0.1 * torch.randn(params["norm"].shape, generator=gen)
    params["conv_b"] = 0.1 * torch.randn(params["conv_b"].shape, generator=gen)
    params["D"] = torch.randn(heads, generator=gen)
    params["dt_bias"] = params["dt_bias"] + torch.randn(heads, generator=gen)
    return dims, params, gen


@pytest.mark.parametrize("heads, head_dim, state, groups", SHAPES)
def test_step_updates_the_state_in_place_as_the_step_out_of_place(heads, head_dim, state,
                                                                  groups):
    dims, params, gen = _layer(heads, head_dim, state, groups, 3)
    b = 3
    st = ssm_lib.init_ssm_state(b, dims, torch.float32)
    st["h"].normal_(generator=gen)
    st["conv"].normal_(generator=gen)
    want_state = {k: v.clone() for k, v in st.items()}
    h = st["h"]
    for t in range(4):
        x = torch.randn(b, 1, 64, generator=gen)
        want, want_state = _out_of_place_step(params, x, want_state, dims)
        out, new = ssm_lib.ssm_step(params, x, st, dims)
        assert new["h"] is h  # the same tensor, written
        assert torch.equal(out, want)
        assert torch.equal(h, want_state["h"])
        assert torch.equal(new["conv"], want_state["conv"])
        st = {"h": new["h"], "conv": new["conv"].clone()}


@pytest.mark.parametrize("heads, head_dim, state, groups", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_recurrence(heads, head_dim, state, groups, dtype):
    """h <- h exp(dt a) + dt x B, y = h C + D x per head, with dt =
    softplus(dt_raw + dt_bias), a = -exp(A_log) and B, C of the head's
    group, computed in float64 one (slot, head) at a time."""
    gen = torch.Generator().manual_seed(5)
    b = 2
    h = torch.randn(b, heads, head_dim, state, generator=gen)
    x = torch.randn(b, heads, head_dim, generator=gen).to(dtype)
    dt_raw = torch.randn(b, heads, generator=gen).to(dtype)
    bm = torch.randn(b, groups, state, generator=gen).to(dtype)
    cm = torch.randn(b, groups, state, generator=gen).to(dtype)
    dt_bias, a_log, d = (torch.randn(heads, generator=gen) for _ in range(3))
    want_h = h.double().clone()
    want_y = torch.empty(b, heads, head_dim, dtype=torch.float64)
    for i in range(b):
        for j in range(heads):
            g = j // (heads // groups)
            dt = F.softplus(dt_raw[i, j].double() + dt_bias[j].double())
            da = torch.exp(-dt * torch.exp(a_log[j].double()))
            want_h[i, j] = (want_h[i, j] * da
                            + dt * x[i, j].double()[:, None] * bm[i, g].double()[None, :])
            want_y[i, j] = want_h[i, j] @ cm[i, g].double() + d[j] * x[i, j].double()
    y = kernel_mod.ssm_step_ref(h, x, dt_raw, bm, cm, dt_bias, a_log, d)
    assert y.dtype == dtype and y.shape == (b, heads, head_dim)
    torch.testing.assert_close(h, want_h.float(), rtol=1e-5, atol=1e-5)
    tol = 1e-5 if dtype == torch.float32 else 1e-2  # bf16: y rounded once on output
    torch.testing.assert_close(y.double(), want_y, rtol=tol, atol=tol)


def _step_inputs(b=2, heads=4, head_dim=16, state=16, groups=1, dtype=torch.float32):
    gen = torch.Generator().manual_seed(7)
    return (torch.randn(b, heads, head_dim, state, generator=gen),
            torch.randn(b, heads, head_dim, generator=gen).to(dtype),
            torch.randn(b, heads, generator=gen).to(dtype),
            torch.randn(b, groups, state, generator=gen).to(dtype),
            torch.randn(b, groups, state, generator=gen).to(dtype),
            *(torch.randn(heads, generator=gen) for _ in range(3)))


def test_cpu_and_fake_tensors_take_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel launcher called off the card")

    monkeypatch.setattr(ops, "ssm_step_cuda", boom)
    before = kernel_mod.LAUNCHES.count
    args = _step_inputs(heads=8, groups=2)
    want_h = args[0].clone()
    want_y = kernel_mod.ssm_step_ref(want_h, *args[1:])
    y = ops.ssm_step(*args)
    assert torch.equal(y, want_y) and torch.equal(args[0], want_h)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in _step_inputs(b=4, heads=8, head_dim=64,
                                                         state=128, groups=8)]
        y = ops.ssm_step(*fake)
    assert y.shape == (4, 8, 64) and y.dtype == torch.float32
    assert kernel_mod.LAUNCHES.count == before


#: The state's placement on a one-rank mesh, groups: each plan of
#: ``ops.ssm_step_placements``.
DTENSOR_PLANS = [("batch", 1, 1), ("heads", 2, 1), ("heads", 2, 2), ("head_dim", 3, 1),
                 ("replicated", None, 1)]


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("plan, dim, groups", DTENSOR_PLANS,
                         ids=[f"{p[0]}_g{p[2]}" for p in DTENSOR_PLANS])
def test_dtensors_step_on_their_shards_in_place(one_rank_mesh, plan, dim, groups):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh = one_rank_mesh
    layers, layer = 3, 1
    stacked = torch.randn(layers, 2, 4, 16, 16, generator=torch.Generator().manual_seed(9))
    args = _step_inputs(heads=4, groups=groups)[1:]
    want = stacked.clone()
    want_y = kernel_mod.ssm_step_ref(want[layer], *args)
    place = [Replicate()] if dim is None else [Shard(dim)]
    state = distribute_tensor(stacked.clone(), mesh, place)
    dargs = [distribute_tensor(t, mesh, [Replicate()]) for t in args]
    y = ops.ssm_step(state[layer], *dargs)
    assert isinstance(y, DTensor) and y.shape == want_y.shape
    assert torch.equal(y.full_tensor(), want_y)
    assert torch.equal(state.full_tensor(), want)
    assert not torch.equal(want[layer], stacked[layer])


def test_dtensor_state_sharded_along_n_is_refused(one_rank_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    args = _step_inputs()
    state = distribute_tensor(args[0], one_rank_mesh, [Shard(3)])
    with pytest.raises(NotImplementedError):
        ops.ssm_step(state, *(distribute_tensor(t, one_rank_mesh, [Replicate()])
                              for t in args[1:]))


#: (what is wrong, the inputs' changes, the rule it breaks)
REFUSED = [
    ("state_f64", dict(h=lambda t: t.double()), "ssm-step-dtype"),
    ("x_f16", dict(x=lambda t: t.half(), dt=lambda t: t.half(), b=lambda t: t.half(),
                   c=lambda t: t.half()), "ssm-step-dtype"),
    ("mixed_dtypes", dict(x=lambda t: t.bfloat16()), "ssm-step-dtype"),
    ("d_bf16", dict(d=lambda t: t.bfloat16()), "ssm-step-dtype"),
    ("state_not_contiguous", dict(h=lambda t: t.transpose(2, 3).contiguous().transpose(2, 3)),
     "ssm-step-layout"),
    ("state_misaligned", dict(h=lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:]
                              .view(t.shape)), "ssm-step-layout"),
    ("head_dim_24", "p24", "ssm-step-shape"),
    ("state_20", "n20", "ssm-step-shape"),
    ("state_48", "n48", "ssm-step-shape"),
    ("head_dim_128", "p128", "ssm-step-shape"),
    ("groups_not_dividing_heads", "g3", "ssm-step-shape"),
    ("x_shape", dict(x=lambda t: t[:, :-1]), "ssm-step-shape"),
    ("cpu_tensors", dict(), "ssm-step-device"),
]


@pytest.mark.parametrize("case, change, rule", REFUSED, ids=[c[0] for c in REFUSED])
def test_launcher_refuses_what_the_kernel_does_not_take(case, change, rule):
    if isinstance(change, str):
        sizes = dict(p24=dict(head_dim=24), n20=dict(state=20), n48=dict(state=48),
                     p128=dict(head_dim=128),
                     g3=dict(heads=4, groups=3))[change]
        args = list(_step_inputs(**sizes))
    else:
        args = list(_step_inputs())
        names = ("h", "x", "dt", "b", "c", "dt_bias", "a_log", "d")
        for i, name in enumerate(names):
            if name in change:
                args[i] = change[name](args[i])
    with pytest.raises(InvariantViolation) as err:
        kernel_mod.ssm_step_cuda(*args)
    assert err.value.check == rule
