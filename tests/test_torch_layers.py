"""Port parity: repro_torch.models.layers against repro.models.layers (f32, CPU).

The same numpy-seeded inputs go through both; the bound 1e-5 (abs and rel)
covers f32 rounding of differently ordered reductions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
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
    with pytest.raises(NotImplementedError):
        tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                     activation="gelu")


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
