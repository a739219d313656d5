"""Port parity: the flash-decode kernel's plain version and its model-layout
wrapper against the reference's oracle (repro.kernels.ref) and the Pallas
kernel run in interpret mode (repro.kernels.ops), on the cases and with the
tolerances of tests/test_kernels.py: 1e-5 in f32, 2e-2 in bf16.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it against
this plain version there); on the CPU the wrapper takes the plain path.  The
kernel's split road (per-split partials and their combine) has a plain
version of its own, held here to the oracle and to the Pallas kernel."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ops import decode_attention as pallas_decode_attention
from repro.kernels.ref import decode_attention_ref as jax_ref
from repro_torch.core.invariants import InvariantViolation
from repro_torch.kernels import decode_attention as kernel_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    decode_attention_ref,
    decode_attention_split_ref,
    split_bounds,
)

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

SWEEP = [
    (1, 4, 4, 64, 128, 64),  # MHA
    (2, 8, 2, 64, 256, 64),  # GQA 4:1
    (2, 16, 2, 128, 512, 128),  # qwen-like 8:1
    (1, 25, 5, 64, 128, 32),  # hymba: 25 heads, G=5
    (2, 20, 20, 64, 128, 64),  # whisper MHA-20
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, hq, hkv, dh, s, np_dtype, lengths=None):
    """Model-layout inputs, rounded to the working dtype once in numpy so
    both frameworks see identical values."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hq, dh)).astype(np_dtype)
    k = r.standard_normal((b, s, hkv, dh)).astype(np_dtype)
    v = r.standard_normal((b, s, hkv, dh)).astype(np_dtype)
    if lengths is None:
        lengths = r.integers(1, s + 1, (b,))
    return q, k, v, np.asarray(lengths, np.int32)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)


def _port(q, k, v, lengths, dtype, **kw):
    out = ops.decode_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                               torch.from_numpy(lengths), **kw)
    return out.float().numpy()


def _jax_oracle(q, k, v, lengths, **kw):
    b, hq, dh = q.shape
    hkv = k.shape[2]
    out = jax_ref(jnp.asarray(q).reshape(b, hkv, hq // hkv, dh),
                  jnp.swapaxes(jnp.asarray(k), 1, 2), jnp.swapaxes(jnp.asarray(v), 1, 2),
                  jnp.asarray(lengths), **kw)
    return np.asarray(out.astype(jnp.float32)).reshape(b, hq, dh)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,dh,s,block", SWEEP)
def test_decode_attention_sweep(oracle, dtype, b, hq, hkv, dh, s, block):
    np_dt, jnp_dt, t_dt, tol = DTYPES[dtype]
    q, k, v, lengths = _inputs(0, b, hq, hkv, dh, s, np_dt)
    out = _port(q, k, v, lengths, t_dt)
    if oracle == "ref":
        want = _jax_oracle(q, k, v, lengths)
    else:
        want = np.asarray(pallas_decode_attention(
            jnp.asarray(q, jnp_dt), jnp.asarray(k, jnp_dt), jnp.asarray(v, jnp_dt),
            jnp.asarray(lengths), block_s=block).astype(jnp.float32))
    np.testing.assert_allclose(out, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("window,softcap", [(64, None), (1 << 30, 50.0), (32, 30.0)])
def test_decode_attention_window_softcap(oracle, window, softcap):
    b, hq, hkv, dh, s = 2, 8, 4, 64, 256
    q, k, v, lengths = _inputs(1, b, hq, hkv, dh, s, np.float32, lengths=[s, s // 3])
    out = _port(q, k, v, lengths, torch.float32, window=window, softcap=softcap)
    if oracle == "ref":
        want = _jax_oracle(q, k, v, lengths, window=window, softcap=softcap)
    else:
        want = np.asarray(pallas_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
            window=window, softcap=softcap, block_s=64))
    np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lengths", [[0, 3], [300, 7], [5, 1]])
def test_decode_attention_edge_lengths(lengths):
    """No valid token (uniform average, as the reference softmax gives), a
    count beyond the cache (an idle slot past max_len: all valid), a
    single token."""
    q, k, v, lens = _inputs(2, 2, 8, 2, 64, 96, np.float32, lengths=lengths)
    np.testing.assert_allclose(_port(q, k, v, lens, torch.float32, window=40),
                               _jax_oracle(q, k, v, lens, window=40), atol=1e-5, rtol=1e-5)


def test_plain_version_in_kernel_layout_matches_reference_oracle():
    r = np.random.default_rng(3)
    q = r.standard_normal((2, 2, 4, 64)).astype(np.float32)
    k = r.standard_normal((2, 2, 80, 64)).astype(np.float32)
    v = r.standard_normal((2, 2, 80, 64)).astype(np.float32)
    lengths = np.array([80, 17], np.int32)
    out = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lengths), scale=0.3, softcap=20.0)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                   scale=0.3, softcap=20.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_the_plain_path(monkeypatch):
    """A CPU tensor never reaches the kernel launcher, and launches nothing."""
    def boom(*a, **k):
        raise AssertionError("kernel launcher called for a CPU tensor")

    monkeypatch.setattr(ops, "decode_attention_cuda", boom)
    before = kernel_mod.LAUNCHES.count
    q, k, v, lengths = _inputs(4, 2, 8, 2, 64, 64, np.float32)
    out = _port(q, k, v, lengths, torch.float32)
    assert out.shape == (2, 8, 64)
    assert kernel_mod.LAUNCHES.count == before


def test_kernel_launcher_rejects_cpu_tensors_and_bad_shapes():
    q = torch.zeros(1, 2, 4, 64)
    k = torch.zeros(1, 2, 16, 64)
    with pytest.raises(InvariantViolation, match="CUDA"):
        kernel_mod.decode_attention_cuda(q, k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="group"):
        ops.decode_attention(torch.zeros(1, 6, 64), torch.zeros(1, 16, 4, 64),
                             torch.zeros(1, 16, 4, 64), torch.ones(1, dtype=torch.int32))


# -- the split road: per-split (m, l, acc) partials and their combine ---------

#: (case, (b, hq, hkv, dh, s), lengths, kwargs): ragged rows, one of them
#: shorter than any split count (so most of its splits are empty); a row
#: with nothing valid; a window whose first valid position is not a tile
#: boundary; softcap at head_dim 128.
SPLIT_CASES = [
    ("ragged", (3, 8, 2, 64, 512), [512, 2, 137], {}),
    ("nothing_valid", (2, 8, 2, 64, 256), [0, 3], {}),
    ("window_mid_split", (2, 8, 4, 64, 512), [512, 300], dict(window=100)),
    ("softcap", (2, 8, 4, 128, 256), [256, 85], dict(softcap=30.0)),
]


def _split_port(q, k, v, lengths, n_split, **kw):
    """The split plain version on model-layout numpy inputs (f32)."""
    b, hq, dh = q.shape
    hkv = k.shape[2]
    out = decode_attention_split_ref(
        torch.from_numpy(q).reshape(b, hkv, hq // hkv, dh),
        torch.from_numpy(k).transpose(1, 2), torch.from_numpy(v).transpose(1, 2),
        torch.from_numpy(lengths), n_split, **kw)
    return out.reshape(b, hq, dh).numpy()


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("case,shape,lengths,kw", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_plain_version_matches_oracles(oracle, n_split, case, shape, lengths, kw):
    b, hq, hkv, dh, s = shape
    q, k, v, lens = _inputs(5, b, hq, hkv, dh, s, np.float32, lengths=lengths)
    out = _split_port(q, k, v, lens, n_split, **kw)
    if oracle == "ref":
        want = _port(q, k, v, lens, torch.float32, **kw)
    else:
        want = np.asarray(pallas_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            block_s=64, **kw))
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=1e-6)


def test_split_cases_cover_empty_and_partial_splits():
    """The cases above reach the combine's edge cases: empty splits beside
    non-empty ones, and a walked range that starts off a tile boundary."""
    assert split_bounds(2, 512, 3)[1:] == [(2, 2), (2, 2)]
    assert split_bounds(0, 256, 7)[0] == (0, 64)  # nothing valid: all of S
    assert split_bounds(3, 256, 64)[4:] == [(3, 3)] * 60
    first, second = split_bounds(512, 512, 2, window=100)
    assert first == (412, 476) and second == (476, 512)
    assert sum(e - b for b, e in split_bounds(137, 512, 7)) == 137


@pytest.mark.parametrize("n_split", [1, 7])
def test_bf16_probabilities_fit_the_bf16_tolerance(n_split):
    """The kernel rounds P to bf16 as the operand of its value product; on
    f32 inputs that rounding alone stays inside the bf16 tolerance."""
    q, k, v, lens = _inputs(6, 2, 16, 2, 128, 512, np.float32, lengths=[512, 77])
    out = decode_attention_split_ref(
        *(torch.from_numpy(a) for a in (q.reshape(2, 2, 8, 128), k.transpose(0, 2, 1, 3),
                                        v.transpose(0, 2, 1, 3), lens)),
        n_split, p_dtype=torch.bfloat16)
    want = _port(q, k, v, lens, torch.float32)
    np.testing.assert_allclose(out.reshape(2, 16, 128).numpy(), want, atol=2e-2, rtol=2e-2)


def test_split_count_fills_one_wave_and_never_splits_the_serve_cache():
    resident = 132 * 2  # an H100's SMs x the bf16 kernel's blocks per SM
    assert kernel_mod.split_count(96, 4 * 8, resident) == 1  # serve shape
    assert kernel_mod.split_count(32768, 8 * 8, resident) == 4  # long cache, B=8
    assert kernel_mod.split_count(32768, 8, resident) == 16  # B=1: splits of 2048
    assert kernel_mod.split_count(4096, 2 * 8, resident) == 2
    assert kernel_mod.split_count(2048, 8, resident) == 1
    assert kernel_mod.split_count(32768, 1000, resident) == 1


# -- head_dim 32: the smoke configs' (fig11, the serve CLI's default) ----------

#: (case, (b, hq, hkv, dh, s), lengths, kwargs): the smoke serve shape (4
#: slots, 4 q / 2 kv heads, max_len 96), then a longer cache with a window
#: that starts off a tile boundary, a softcap, and both.
DH32_CASES = [
    ("smoke_serve", (4, 4, 2, 32, 96), [9, 96, 1, 40], {}),
    ("window", (2, 8, 2, 32, 512), [512, 300], dict(window=100)),
    ("softcap", (2, 8, 4, 32, 256), [256, 85], dict(softcap=30.0)),
    ("window_softcap", (2, 8, 2, 32, 512), [512, 77], dict(window=64, softcap=50.0)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("case,shape,lengths,kw", DH32_CASES, ids=[c[0] for c in DH32_CASES])
def test_split_plain_version_at_head_dim_32_matches_reference(dtype, n_split, case, shape,
                                                              lengths, kw):
    """The plain version of the kernel's split road at Dh 32, in the dtype's
    road (bf16 rounds P as the value product's operand), against the
    reference's oracle at tests/test_kernels.py's bounds."""
    np_dt, _, t_dt, tol = DTYPES[dtype]
    b, hq, hkv, dh, s = shape
    q, k, v, lens = _inputs(7, b, hq, hkv, dh, s, np_dt, lengths=lengths)
    out = decode_attention_split_ref(
        _torch(q, t_dt).reshape(b, hkv, hq // hkv, dh), _torch(k, t_dt).transpose(1, 2),
        _torch(v, t_dt).transpose(1, 2), torch.from_numpy(lens), n_split,
        p_dtype=torch.bfloat16 if dtype == "bf16" else None, **kw)
    want = _jax_oracle(q, k, v, lens, **kw)
    np.testing.assert_allclose(out.float().reshape(b, hq, dh).numpy(), want,
                               atol=tol, rtol=tol)



# -- head_dim 80 (h2o-danube) and 160 (stablelm) at full width ----------------

#: (case, (b, hq, hkv, dh, s), lengths, kwargs): a window whose first valid
#: position is not a tile boundary, a softcap, and both, at each head dim.
DH80_160_CASES = [
    (f"dh{dh}_{name}", (b, hq, hkv, dh, s), lengths, kw)
    for dh in (80, 160)
    for name, (b, hq, hkv, s), lengths, kw in (
        ("window", (2, 8, 2, 512), [512, 300], dict(window=100)),
        ("softcap", (2, 8, 4, 256), [256, 85], dict(softcap=30.0)),
        ("window_softcap", (2, 8, 2, 512), [512, 77], dict(window=64, softcap=50.0)),
    )
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,shape,lengths,kw", DH80_160_CASES,
                         ids=[c[0] for c in DH80_160_CASES])
def test_plain_versions_at_head_dim_80_and_160_match_pallas_kernel(dtype, case, shape,
                                                                    lengths, kw):
    """decode_attention_ref (the wrapper's CPU path) and the split road's
    plain version (n_split 1 and 3, bf16 rounding P where the kernel does)
    against the reference's K1 run in interpret mode, at
    tests/test_kernels.py's bounds."""
    np_dt, jnp_dt, t_dt, tol = DTYPES[dtype]
    b, hq, hkv, dh, s = shape
    q, k, v, lens = _inputs(8, b, hq, hkv, dh, s, np_dt, lengths=lengths)
    want = np.asarray(pallas_decode_attention(
        jnp.asarray(q, jnp_dt), jnp.asarray(k, jnp_dt), jnp.asarray(v, jnp_dt),
        jnp.asarray(lens), block_s=128, **kw).astype(jnp.float32))
    np.testing.assert_allclose(_port(q, k, v, lens, t_dt, **kw), want, atol=tol, rtol=tol)
    for n_split in (1, 3):
        out = decode_attention_split_ref(
            _torch(q, t_dt).reshape(b, hkv, hq // hkv, dh), _torch(k, t_dt).transpose(1, 2),
            _torch(v, t_dt).transpose(1, 2), torch.from_numpy(lens), n_split,
            p_dtype=torch.bfloat16 if dtype == "bf16" else None, **kw)
        np.testing.assert_allclose(out.float().reshape(b, hq, dh).numpy(), want,
                                   atol=tol, rtol=tol)


def test_kernel_takes_every_ported_head_dim():
    """Each head dim of the port's configs, full and smoke, is one the
    kernel is instantiated for; no other is."""
    from repro_torch.configs import ARCH_IDS, get_arch

    dims = {cfg.head_dim for a in ARCH_IDS for cfg in (get_arch(a).config, get_arch(a).smoke)
            if cfg.uses_attention}
    assert dims == set(kernel_mod._HEAD_DIMS) == {32, 64, 80, 128, 160}
    src = kernel_mod.SOURCE.path.read_text()
    for dh in kernel_mod._HEAD_DIMS:
        for t in ("float", "__nv_bfloat16"):
            assert f"K1_LAUNCH({t}, {dh})" in src and f"blocks_per_sm<{t}, {dh}>" in src
