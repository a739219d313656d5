"""Port parity: the dense decoder (repro_torch.models) against the reference's
TransformerLM on the llama31 smoke config in f32, weights shared through
params_from_numpy.  Bounds are the reference's own (tests/test_models.py):
2e-3 for prefill logits, 3e-3 for decode logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models.transformer import DecodeState as JaxDecodeState
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.configs import get_arch as port_arch
from repro_torch.models.transformer import ModelConfig, TransformerLM, param_shapes
from repro_torch.models.weights import params_from_numpy

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

PREFILL_TOL = dict(atol=2e-3, rtol=2e-3)
DECODE_TOL = dict(atol=3e-3, rtol=3e-3)

JCFG = dataclasses.replace(get_arch("llama31-8b").smoke, dtype=jnp.float32)
TCFG = dataclasses.replace(port_arch("llama31-8b").smoke, dtype=torch.float32)
JMODEL = JaxLM(JCFG)
JPARAMS, _ = JMODEL.init(jax.random.PRNGKey(0))
TMODEL = TransformerLM(TCFG)
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), TCFG, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(1, JCFG.vocab, (b, s)).astype(np.int32)


def test_port_config_copies_reference():
    for jc, tc in ((get_arch("llama31-8b").config, port_arch("llama31-8b").config),
                   (get_arch("llama31-8b").smoke, port_arch("llama31-8b").smoke)):
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16


def test_param_bytes_match_reference():
    """The simulated serving clock reads parameter bytes: same tree, same total."""
    cfg = port_arch("llama31-8b").smoke
    tp = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jp, _ = JaxLM(get_arch("llama31-8b").smoke).init(jax.random.PRNGKey(0))
    nbytes = lambda tree: sum(x.nbytes for x in jax.tree.leaves(tree))  # noqa: E731
    assert sum(t.numel() * t.element_size() for t in jax.tree.leaves(tp)) == nbytes(jp)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jp))


def test_forward_and_prefill_match_reference():
    toks = _tokens(0, 2, 12)
    hidden, _ = JMODEL.forward(JPARAMS, jnp.asarray(toks))
    want = np.asarray(JMODEL.logits(JPARAMS, hidden))
    got = TMODEL.logits(TPARAMS, TMODEL.forward(TPARAMS, torch.from_numpy(toks)))
    np.testing.assert_allclose(got.numpy(), want, **PREFILL_TOL)
    jst = JMODEL.init_decode_state(2, 32)
    jl, jst = JMODEL.prefill(JPARAMS, jnp.asarray(toks), jst)
    tst = TMODEL.init_decode_state(2, 32, "cpu")
    tl, tst = TMODEL.prefill(TPARAMS, torch.from_numpy(toks), tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
    np.testing.assert_allclose(tst.kv["k"].numpy(), np.asarray(jst.kv["k"]), atol=1e-4)
    assert tst.length.tolist() == [12, 12]


def test_decode_steps_match_reference_with_per_slot_lengths():
    """Slots at different lengths (prompts of 5 and 2 tokens inserted into a
    shared state), decoded together for several steps."""
    b, max_len = 2, 24
    jst = JMODEL.init_decode_state(b, max_len)
    tst = TMODEL.init_decode_state(b, max_len, "cpu")
    jkv = {k: np.asarray(v).copy() for k, v in jst.kv.items()}
    lengths = []
    for slot, plen in enumerate((5, 2)):
        toks = _tokens(10 + slot, 1, plen)
        _, j1 = JMODEL.prefill(JPARAMS, jnp.asarray(toks), JMODEL.init_decode_state(1, max_len))
        _, t1 = TMODEL.prefill(TPARAMS, torch.from_numpy(toks),
                               TMODEL.init_decode_state(1, max_len, "cpu"))
        for name in ("k", "v"):
            jkv[name][:, slot] = np.asarray(j1.kv[name])[:, 0]
            tst.kv[name][:, slot] = t1.kv[name][:, 0]
        lengths.append(plen)
    jst = JaxDecodeState(kv={k: jnp.asarray(v) for k, v in jkv.items()}, ssm=None,
                         cross_kv=None, length=jnp.asarray(lengths, jnp.int32))
    tst.length = torch.tensor(lengths, dtype=torch.int32)
    tok = _tokens(20, 1, b)[0]
    for _ in range(4):
        jl, jst = JMODEL.decode_step(JPARAMS, jst, jnp.asarray(tok))
        tl, tst = TMODEL.decode_step(TPARAMS, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tst.length.tolist() == np.asarray(jst.length).tolist() == [9, 6]


def test_idle_slot_past_max_len_matches_reference():
    """decode_step advances every slot; one that idles past max_len keeps
    writing the last cache row (the reference's clamped
    dynamic_update_slice) instead of indexing out of range."""
    b, max_len = 2, 8
    toks = _tokens(30, b, 3)
    jst = JMODEL.init_decode_state(b, max_len)
    _, jst = JMODEL.prefill(JPARAMS, jnp.asarray(toks), jst)
    tst = TMODEL.init_decode_state(b, max_len, "cpu")
    _, tst = TMODEL.prefill(TPARAMS, torch.from_numpy(toks), tst)
    tok = toks[:, -1]
    for _ in range(9):  # lengths run 3 -> 12, past max_len = 8
        jl, jst = JMODEL.decode_step(JPARAMS, jst, jnp.asarray(tok))
        tl, tst = TMODEL.decode_step(TPARAMS, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tst.length.tolist() == [12, 12]
    np.testing.assert_allclose(tst.kv["v"].numpy(), np.asarray(jst.kv["v"]), atol=1e-4)


def test_decode_step_matches_forward():
    """prefill(t) + decode(token_t) == forward(t+1 tokens) last logits."""
    toks = _tokens(40, 1, 9)
    st = TMODEL.init_decode_state(1, 32, "cpu")
    _, st = TMODEL.prefill(TPARAMS, torch.from_numpy(toks[:, :-1]), st)
    dec, _ = TMODEL.decode_step(TPARAMS, st, torch.from_numpy(toks[:, -1]))
    full = TMODEL.logits(TPARAMS, TMODEL.forward(TPARAMS, torch.from_numpy(toks)))[:, -1]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_TOL)


@pytest.mark.parametrize("flag", [dict(block="moe"), dict(n_experts=8),
                                  dict(block="moe", n_experts=4, top_k=2),
                                  dict(block="moe", n_experts=4, top_k=1, moe_every=2),
                                  dict(block="hybrid", ssm_state=16),
                                  dict(n_encoder_layers=2),
                                  dict(frontend="vision"), dict(window_pattern="bogus"),
                                  dict(norm="bogus"), dict(activation="relu"),
                                  dict(frontend="bogus")])
def test_unported_families_raise(flag):
    """An inconsistent MoE config raises ValueError: ``block="moe"`` without
    ``0 < top_k <= n_experts``, experts on a dense block, dense/MoE pairs
    over an odd number of layers; so does an unknown window pattern, norm,
    activation or frontend.  A consistent MoE config and the hybrid,
    encoder-decoder and vision families build, and their parameter trees
    hold the router and the expert stacks, the hybrid's SSM branch, the
    encoder's stack and cross-attention."""
    kw = dict(name="x", n_layers=1, d_model=8, n_q_heads=2, n_kv_heads=1, head_dim=4,
              d_ff=8, vocab=16, **flag)
    moe_consistent = flag.get("top_k") and flag.get("moe_every", 1) == 1
    if {"block", "n_experts"} & set(flag) and flag.get("block") != "hybrid" \
            and not moe_consistent:
        with pytest.raises(ValueError):
            ModelConfig(**kw)
    elif {"window_pattern", "norm", "activation"} & set(flag) or flag.get("frontend") == "bogus":
        with pytest.raises(ValueError):
            ModelConfig(**kw)
    else:
        cfg = ModelConfig(**kw)
        tree = param_shapes(cfg)
        assert ("ssm" in tree["layers"]) == (cfg.block == "hybrid")
        assert ("enc_layers" in tree) == ("cross" in tree["layers"]) == (cfg.n_encoder_layers > 0)
        assert ("moe" in tree["layers"]) == ("mlp" not in tree["layers"]) == (cfg.block == "moe")
        if cfg.block == "moe":
            assert {k: v[0] for k, v in tree["layers"]["moe"].items()} == {
                "router": (1, 8, 4), "w_gate": (1, 4, 8, 8), "w_up": (1, 4, 8, 8),
                "w_down": (1, 4, 8, 8)}


def test_ssm_block_builds():
    cfg = ModelConfig(name="x", n_layers=1, d_model=8, n_q_heads=0, n_kv_heads=0,
                      head_dim=0, d_ff=0, vocab=16, block="ssm", ssm_state=4,
                      ssm_head_dim=4)
    assert cfg.uses_ssm and not cfg.uses_attention
    assert cfg.ssm_dims["n_heads"] == 4


def test_weights_bridge_rejects_mismatched_trees():
    tree = jax.tree.map(np.asarray, JPARAMS)
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, TCFG, "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"}, TCFG, "cpu")
    bf16 = params_from_numpy(tree, dataclasses.replace(TCFG, dtype=torch.bfloat16), "cpu")
    assert bf16["embed"].dtype == torch.bfloat16
