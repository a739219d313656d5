"""Port parity: the flash-decode kernel's plain version and its model-layout
wrapper against the reference's oracle (repro.kernels.ref) and the Pallas
kernel run in interpret mode (repro.kernels.ops), on the cases and with the
tolerances of tests/test_kernels.py: 1e-5 in f32, 2e-2 in bf16.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it against
this plain version there); on the CPU the wrapper takes the plain path."""

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
from repro_torch.kernels.ref import decode_attention_ref

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
