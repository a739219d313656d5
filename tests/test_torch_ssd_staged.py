"""The SSD scan kernels' staged decomposition and launch plan, on the CPU.

``ssd_scan_staged_ref`` is the plain version of what the scan kernels
compute on the card: chunk states, the state pass, chunk outputs.  It is
held here to the reference's Pallas kernel in interpret mode and to its
token recurrence (y), and to the reference's chunked scan and the
recurrence (final state), at tests/test_kernels.py's tolerances: 1e-4 with
f32 inputs, 5e-2 with bf16 inputs.  Its bf16-operand variant (the kernels'
tensor-core roundings) is held to the f32 one.  ``launch_plan`` and the
alignment the kernels' 16-byte copies need are checked from shapes alone.
Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_scan as pallas_ssd_scan
from repro.kernels.ref import ssd_scan_ref as jax_scan_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_arch as port_arch
from repro_torch.kernels import ssd_scan as k4
from repro_torch.kernels.ref import ssd_scan_chunked_ref, ssd_scan_staged_ref
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

SWEEP = [  # b, s, h, p, n, chunk (tests/test_kernels.py::test_ssd_scan_sweep)
    (1, 64, 2, 32, 16, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 128, 64),  # mamba2-class state
]
EXTRA = [  # ragged last chunks, a single chunk, many chunks
    (1, 200, 2, 32, 16, 128),
    (2, 37, 3, 16, 16, 16),
    (1, 8, 3, 64, 128, 128),
    (1, 96, 2, 16, 32, 8),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, 5e-2)}
#: The bf16-operand variant against the f32 one, both on the same bf16
#: inputs: y is bf16 in both, so they may differ by an ulp of y (2^-8 of
#: |y|, |y| < 8 here) beyond the operand roundings (W', x tail dt and h_in,
#: each 2^-9 relative).
BF16_OPERAND_TOL = 2e-2


def _inputs(seed, b, s, h, p, n, np_dtype=np.float32):
    """Model-layout scan inputs in the distribution of the reference's
    kernel tests, x, B and C rounded to the working dtype once in numpy."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((b, s, h, p)) * 0.5).astype(np_dtype)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    bm = (r.standard_normal((b, s, n)) * 0.3).astype(np_dtype)
    cm = (r.standard_normal((b, s, n)) * 0.3).astype(np_dtype)
    a = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    return x, dt, bm, cm, a


def _t(v, dtype=torch.float32):
    return torch.from_numpy(np.asarray(v).astype(np.float32)).to(dtype)


def _j(v, dtype=jnp.float32):
    return jnp.asarray(np.asarray(v).astype(np.float32), dtype)


def _staged(x, dt, bm, cm, a, t_dt, chunk, operand_dtype=None):
    """The staged plain version on model-layout inputs: (y f32, state)."""
    y, state = ssd_scan_staged_ref(_t(x, t_dt).transpose(1, 2), _t(dt).transpose(1, 2),
                                   torch.stack([_t(bm, t_dt), _t(cm, t_dt)], dim=2), _t(a),
                                   chunk=chunk, operand_dtype=operand_dtype)
    assert y.dtype == t_dt and state.dtype == torch.float32
    return y.transpose(1, 2).float().numpy(), state.numpy()


def _jax_recurrence(x, dt, bm, cm, a):
    """The reference's token recurrence, model layout, f32 (y only)."""
    y = jax_scan_ref(jnp.moveaxis(_j(x), 2, 1), jnp.moveaxis(_j(dt), 2, 1),
                     jnp.stack([_j(bm), _j(cm)], 2), _j(a))
    return np.asarray(jnp.moveaxis(y, 1, 2))


@pytest.mark.parametrize("oracle", ["pallas", "recurrence"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_staged_y_matches_reference(oracle, dtype, b, s, h, p, n, chunk):
    """y of the staged plain version (f32 inside) against the reference's
    Pallas kernel in interpret mode and against its token recurrence."""
    np_dt, jnp_dt, t_dt, tol = DTYPES[dtype]
    x, dt, bm, cm, a = _inputs(2, b, s, h, p, n, np_dt)
    y, _ = _staged(x, dt, bm, cm, a, t_dt, chunk)
    if oracle == "pallas":
        want = np.asarray(pallas_ssd_scan(_j(x, jnp_dt), _j(dt), _j(bm), _j(cm), _j(a),
                                          chunk=chunk).astype(jnp.float32))
    else:
        want = _jax_recurrence(x, dt, bm, cm, a)
    np.testing.assert_allclose(y, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP + EXTRA)
def test_staged_matches_reference_chunked_scan(dtype, b, s, h, p, n, chunk):
    """y and the final state against the reference model's chunked scan
    (which pads a ragged S itself) and y against the token recurrence:
    ragged last chunks, one chunk (S = 8) and many chunks included."""
    np_dt, _, t_dt, tol = DTYPES[dtype]
    x, dt, bm, cm, a = _inputs(3, b, s, h, p, n, np_dt)
    y, state = _staged(x, dt, bm, cm, a, t_dt, chunk)
    jy, jstate = jssm.ssd_chunked(_j(x), _j(bm)[:, :, None], _j(cm)[:, :, None], _j(dt),
                                  _j(a), chunk=min(chunk, s))
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    np.testing.assert_allclose(y, np.asarray(jy, dtype=np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(state, np.asarray(jstate), atol=tol, rtol=tol)
    np.testing.assert_allclose(y, _jax_recurrence(x, dt, bm, cm, a), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP + EXTRA)
def test_staged_equals_chunked_plain_version_in_f32(b, s, h, p, n, chunk):
    """The staged decomposition and the chunk-serial plain version the
    CPU path runs are the same function: f32 summation order apart."""
    x, dt, bm, cm, a = _inputs(4, b, s, h, p, n)
    y, state = _staged(x, dt, bm, cm, a, torch.float32, chunk)
    yc, sc = ssd_scan_chunked_ref(_t(x).transpose(1, 2), _t(dt).transpose(1, 2),
                                  torch.stack([_t(bm), _t(cm)], dim=2), _t(a), chunk=chunk)
    np.testing.assert_allclose(y, yc.transpose(1, 2).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state, sc.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP + EXTRA)
def test_bf16_operand_roundings_stay_near_f32(b, s, h, p, n, chunk):
    """The kernels' tensor-core roundings (W', x tail dt, h_in to bf16) on
    bf16 inputs, against the same inputs f32 inside, and against the
    reference's recurrence at the bf16 gate."""
    x, dt, bm, cm, a = _inputs(5, b, s, h, p, n, ml_dtypes.bfloat16)
    y32, s32 = _staged(x, dt, bm, cm, a, torch.bfloat16, chunk)
    y16, s16 = _staged(x, dt, bm, cm, a, torch.bfloat16, chunk, torch.bfloat16)
    np.testing.assert_allclose(y16, y32, atol=BF16_OPERAND_TOL, rtol=BF16_OPERAND_TOL)
    np.testing.assert_allclose(s16, s32, atol=BF16_OPERAND_TOL, rtol=BF16_OPERAND_TOL)
    np.testing.assert_allclose(y16, _jax_recurrence(x, dt, bm, cm, a), atol=5e-2, rtol=5e-2)
    assert np.abs(y16 - y32).max() > 0  # the roundings are really applied


MAMBA2 = (80, 64, 128)  # heads, head_dim, state of mamba2-2.7b
#: Resident Stage C blocks an SM that the kernels are designed for (the
#: library reports what it compiled to: ``ssd_scan_blocks_per_sm``).
BLOCKS_PER_SM = {torch.bfloat16: 2, torch.float32: 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", [(1, 8), (1, 128), (1, 129), (1, 200), (1, 2048), (4, 2048),
                                 (1, 8192), (3, 1)])
def test_launch_plan_kernels_and_blocks(dtype, b, s):
    """One device kernel for one chunk, three above; Stage C has at least
    one block an SM wherever there are that many (chunk, head, batch row)
    units, and one head a block where they all fit one wave."""
    h, p, n = MAMBA2
    sm = 132
    plan = k4.launch_plan(b, s, h, p, n, 128, dtype, sm, BLOCKS_PER_SM[dtype])
    nc = -(-s // 128)
    assert plan["n_chunks"] == nc
    assert plan["device_kernels_per_call"] == (1 if nc == 1 else 3)
    hpb = plan["heads_per_block"]
    assert 1 <= hpb <= h and plan["head_groups"] == -(-h // hpb)
    assert plan["blocks_chunk"] == nc * plan["head_groups"] * b
    units = nc * h * b
    assert plan["blocks_chunk"] >= min(sm, units)
    wave = BLOCKS_PER_SM[dtype] * sm
    assert plan["wave_blocks"] == wave
    if units <= wave:  # everything fits one wave at one head a block
        assert hpb == 1
    if nc == 1:
        assert plan["scratch_bytes"] == 0 and plan["blocks_state"] == plan["blocks_pass"] == 0
    else:
        states = b * h * nc * p * n
        assert plan["blocks_state"] == plan["blocks_chunk"]
        assert plan["scratch_bytes"] >= 4 * states * (1 if dtype == torch.float32 else 1.5)
        assert plan["scratch_bytes"] % 16 == 0


@pytest.mark.parametrize("dtype,b,s,want", [
    (torch.bfloat16, 1, 2048, (16, 5, 256)),  # 1280 units: one wave of 264
    (torch.float32, 1, 2048, (16, 5, 256)),   # two waves of 132 (10 a block: 128 < 132)
    (torch.bfloat16, 1, 8192, (64, 20, 256)),
    (torch.bfloat16, 4, 2048, (16, 20, 256)),
    (torch.bfloat16, 1, 200, (2, 1, 160)),
    (torch.bfloat16, 1, 8, (1, 1, 80)),       # the serve prompt
    (torch.bfloat16, 4, 8, (1, 2, 160)),      # 320 units: one wave at two heads
])
def test_launch_plan_at_mamba2_shapes(dtype, b, s, want):
    """(chunks, heads a block, Stage C blocks) on 132 SMs, as the cost
    model of waves x (heads + 1) picks them."""
    plan = k4.launch_plan(b, s, *MAMBA2, 128, dtype, 132, BLOCKS_PER_SM[dtype])
    assert (plan["n_chunks"], plan["heads_per_block"], plan["blocks_chunk"]) == want


def test_plan_is_cached_per_shape(monkeypatch):
    """The wrapper's plan is looked up once per shape, number of chunks and
    device, and is the pure plan for the device's SM count and blocks an
    SM: prompts of other lengths with as many chunks share one entry."""
    monkeypatch.setattr(k4, "_device_consts", {(0, torch.bfloat16): (132, 2)})
    monkeypatch.setattr(k4, "_plans", {})
    dev = torch.device("cuda", 0)
    first = k4.plan_for(1, 2048, *MAMBA2, 128, torch.bfloat16, dev)
    assert k4.plan_for(1, 2048, *MAMBA2, 128, torch.bfloat16, dev) is first
    assert first == k4.launch_plan(1, 2048, *MAMBA2, 128, torch.bfloat16, 132, 2)
    assert len(k4._plans) == 1
    for s in (1921, 2000, 2047):  # 16 chunks of 128, as 2048
        assert k4.plan_for(1, s, *MAMBA2, 128, torch.bfloat16, dev) is first
        assert first == k4.launch_plan(1, s, *MAMBA2, 128, torch.bfloat16, 132, 2)
    assert len(k4._plans) == 1
    k4.plan_for(1, 8, *MAMBA2, 8, torch.bfloat16, dev)
    assert len(k4._plans) == 2


@pytest.mark.parametrize("s", [8, 300])
def test_mamba2_views_are_16_byte_aligned(s):
    """The model's x, B and C views of its conv output (mamba2-2.7b: conv
    dim 5376 in bf16, 10,752-byte rows, B at element 5120, C at 5248) start
    and step on 16-byte boundaries, as the kernels' cp.async copies need."""
    cfg = port_arch("mamba2-2.7b").config
    dims = cfg.ssm_dims
    assert dims["conv_dim"] == 5376 and dims["d_inner"] == 5120
    xbc = torch.zeros(1, s, dims["conv_dim"], dtype=cfg.dtype)
    params = {"dt_bias": torch.zeros(dims["n_heads"]), "A_log": torch.zeros(dims["n_heads"])}
    xs, bmat, cmat, dt, a = tssm._prep_inputs(params, xbc, torch.zeros(1, s, dims["n_heads"]),
                                              dims)
    assert xs.shape == (1, s, 80, 64) and bmat.shape == (1, s, 1, 128)
    for view in (xs, bmat[:, :, 0], cmat[:, :, 0]):
        assert k4.rows_aligned(view), view.stride()
    assert (bmat.data_ptr() - xbc.data_ptr()) == 5120 * 2
    assert (cmat.data_ptr() - xbc.data_ptr()) == 5248 * 2


def test_misaligned_rows_are_detected():
    base = torch.zeros(2, 10, 40, dtype=torch.bfloat16)
    assert k4.rows_aligned(base[..., :32])
    assert not k4.rows_aligned(base[..., 4:36])  # 8-byte offset
    assert not k4.rows_aligned(torch.zeros(2, 10, 36, dtype=torch.bfloat16)[..., :32])

