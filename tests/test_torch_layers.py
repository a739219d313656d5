"""Port parity: repro_torch.models.layers against repro.models.layers (f32, CPU).

The same numpy-seeded inputs go through both; the bound 1e-5 (abs and rel)
covers f32 rounding of differently ordered reductions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_rmsnorm_matches_reference(shape):
    r = _rng(1)
    x = r.standard_normal(shape).astype(np.float32) * 3
    scale = r.standard_normal(shape[-1:]).astype(np.float32) * 0.1
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_layernorm_matches_reference(shape, bias):
    """stablelm's norm: f32 inside, eps 1e-5, ``1 + scale`` applied once."""
    r = _rng(11)
    x = r.standard_normal(shape).astype(np.float32) * 3 + 1.5
    scale = r.standard_normal(shape[-1:]).astype(np.float32) * 0.1
    b = r.standard_normal(shape[-1:]).astype(np.float32) * 0.1 if bias else None
    _close(tl.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                        None if b is None else torch.from_numpy(b)),
           jl.layernorm(jnp.asarray(x), jnp.asarray(scale),
                        None if b is None else jnp.asarray(b)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tl.layernorm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_reference(theta):
    r = _rng(2)
    x = r.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = r.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=2e-5, rtol=2e-5)
    _close(tl.rope_frequencies(32, theta), jl.rope_frequencies(32, theta))


def test_mlp_apply_matches_reference():
    r = _rng(3)
    d, f = 64, 96
    p = {k: r.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = r.standard_normal((2, 3, d)).astype(np.float32)
    out = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    ref = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close(out, ref)
    with pytest.raises(ValueError):
        tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                     activation="relu")


def test_mlp_apply_gelu_matches_reference():
    """gemma2's GeGLU: the tanh-approximate GELU of the reference."""
    r = _rng(12)
    d, f = 64, 96
    p = {k: r.standard_normal(s).astype(np.float32) * 0.3
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = r.standard_normal((2, 3, d)).astype(np.float32)
    out = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                       activation="gelu")
    ref = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                       activation="gelu")
    _close(out, ref)
    silu = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    assert not torch.allclose(out, silu)


# -- attention: QK-norm and the blocked prefill ---------------------------------


def _attn_params(seed, d, hq, hkv, dh, bias=False, qk_norm=False):
    """Numpy attention weights with nonzero biases and QK-norm scales."""
    r = _rng(seed)
    p = {"wq": r.standard_normal((d, hq, dh)) * d**-0.5,
         "wk": r.standard_normal((d, hkv, dh)) * d**-0.5,
         "wv": r.standard_normal((d, hkv, dh)) * d**-0.5,
         "wo": r.standard_normal((hq, dh, d)) * (hq * dh)**-0.5}
    if bias:
        p.update(bq=r.standard_normal((hq, dh)) * 0.1, bk=r.standard_normal((hkv, dh)) * 0.1,
                 bv=r.standard_normal((hkv, dh)) * 0.1)
    if qk_norm:
        p.update(q_norm=r.standard_normal(dh) * 0.1, k_norm=r.standard_normal(dh) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("bias", [False, True])
def test_project_qkv_with_qk_norm_matches_reference(bias):
    """stablelm's per-head QK-norm: RMSNorm after the bias, before RoPE."""
    p = _attn_params(13, 32, 4, 2, 16, bias=bias, qk_norm=True)
    r = _rng(14)
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    got = tattn.project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), torch.from_numpy(pos), rope_theta=10_000.0)
    want = jattn.project_qkv({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             jnp.asarray(pos), rope_theta=10_000.0)
    for g, w in zip(got, want):
        _close(g, w, atol=2e-5, rtol=2e-5)
    plain = tattn.project_qkv({k: torch.from_numpy(v) for k, v in p.items()
                               if not k.endswith("_norm")},
                              torch.from_numpy(x), torch.from_numpy(pos), rope_theta=10_000.0)
    assert not torch.allclose(got[0], plain[0])


def _record_block_rows(monkeypatch, module):
    """Query rows of each ``_attention_core`` call of ``module``."""
    rows = []
    core = module._attention_core

    def spy(q, *args, **kwargs):
        rows.append(q.shape[1])
        return core(q, *args, **kwargs)

    monkeypatch.setattr(module, "_attention_core", spy)
    return rows


@pytest.mark.parametrize("s,blocks", [(2048, [1024, 1024]), (1536, [1536])])
def test_attend_full_query_blocking_matches_reference(monkeypatch, s, blocks):
    """S = 2048 takes two query blocks of Q_BLOCK = 1024 in both packages
    (window 300 and softcap 50 applied inside each block) and equals the
    port's own one-shot path; S = 1536 (not a multiple) takes one shot in
    both."""
    p = _attn_params(15, 32, 4, 2, 16, bias=True)
    x = (_rng(16).standard_normal((1, s, 32)) * 0.5).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    kw = dict(rope_theta=10_000.0, window=300, softcap_value=50.0, query_scale=0.3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    port_rows = _record_block_rows(monkeypatch, tattn)
    ref_rows = _record_block_rows(monkeypatch, jattn)
    got = tattn.attend_full(tp, torch.from_numpy(x), torch.from_numpy(pos), **kw)
    want = jattn.attend_full({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             jnp.asarray(pos), **kw)
    _close(got, want, atol=2e-5, rtol=2e-5)
    assert port_rows == blocks and ref_rows == blocks[:1]  # lax.map traces one block
    one_shot = tattn.attend_full(tp, torch.from_numpy(x), torch.from_numpy(pos),
                                 q_block=1 << 30, **kw)
    assert port_rows[-1] == s
    _close(got, one_shot.numpy(), atol=1e-6, rtol=1e-6)


def test_embed_unembed_softcap_match_reference():
    r = _rng(4)
    table = r.standard_normal((50, 16)).astype(np.float32)
    toks = r.integers(0, 50, (3, 6)).astype(np.int64)
    emb = tl.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks))
    _close(emb, jl.embed_lookup(jnp.asarray(table), jnp.asarray(toks)), atol=0, rtol=0)
    x = r.standard_normal((3, 6, 16)).astype(np.float32)
    _close(tl.unembed(torch.from_numpy(x), torch.from_numpy(table)),
           jl.unembed(jnp.asarray(x), jnp.asarray(table)))
    big = r.standard_normal((4, 9)).astype(np.float32) * 80
    _close(tl.softcap(torch.from_numpy(big), 30.0), jl.softcap(jnp.asarray(big), 30.0),
           atol=1e-4, rtol=1e-5)


def test_truncated_normal_initialisers():
    """Same distribution as jax.random.truncated_normal(-2, 2) x scale: no
    value beyond 2*scale, std of the truncated standard normal (0.8796)."""
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(256, (512, 256), torch.float32, g, torch.device("cpu"))
    scale = 256**-0.5
    assert w.abs().max().item() <= 2 * scale + 1e-7
    assert abs(w.std().item() / scale - 0.8796) < 0.01
    assert abs(w.mean().item()) < 0.01 * scale
    e = tl.embed_init((300, 64), torch.bfloat16, torch.Generator().manual_seed(1),
                      torch.device("cpu"))
    assert e.dtype == torch.bfloat16 and e.float().abs().max().item() <= 2.0
    again = tl.dense_init(256, (512, 256), torch.float32, torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    assert torch.equal(w, again)
