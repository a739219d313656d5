"""Port parity: the attention families (gemma2, h2o-danube, stablelm,
qwen2.5) of repro_torch.models against the reference's TransformerLM on
their smoke configs in f32, weights shared through params_from_numpy.

The reference initialises norms and biases to zero; the shared weights
here replace every zero leaf with seeded noise, so the QKV bias, the
QK-norm scales, the post norms and LayerNorm's scale all take part.
Bounds are the reference's own (tests/test_models.py): 2e-3 for prefill
logits, 3e-3 for decode logits.  Every prompt crosses the smoke window of
16, so the local layers' masks and the kernel's windowed walk are held."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_arch
from repro.models.transformer import DecodeState as JaxDecodeState
from repro.models.transformer import ModelConfig as JaxModelConfig
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import get_arch as port_arch
from repro_torch.launch import serve as port_serve
from repro_torch.models.transformer import FULL_WINDOW, ModelConfig, TransformerLM
from repro_torch.models.weights import params_from_numpy

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ARCHS = ["gemma2-27b", "h2o-danube-1.8b", "stablelm-12b", "qwen2.5-3b"]
PREFILL_TOL = dict(atol=2e-3, rtol=2e-3)
DECODE_TOL = dict(atol=3e-3, rtol=3e-3)


def _noisy(tree, rng):
    """The tree with each all-zero leaf (norm scales, biases) replaced by
    0.1 x a standard normal."""
    return {k: _noisy(v, rng) if isinstance(v, dict)
            else (v if v.any() else (0.1 * rng.standard_normal(v.shape)).astype(v.dtype))
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _family(arch):
    """(reference model, its params, port model, port params): the smoke
    config in f32, built once per module."""
    jcfg = dataclasses.replace(get_arch(arch).smoke, dtype=jnp.float32)
    tcfg = dataclasses.replace(port_arch(arch).smoke, dtype=torch.float32)
    jmodel = JaxLM(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0])
    tree = _noisy(tree, np.random.default_rng(1))
    return (jmodel, jax.tree.map(jnp.asarray, tree), TransformerLM(tcfg),
            params_from_numpy(tree, tcfg, "cpu"))


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)


def test_port_registers_the_families():
    assert set(ARCHS) <= set(PORT_ARCH_IDS)
    for arch in ARCHS:
        assert port_arch(arch).arch_id == get_arch(arch).arch_id == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_reference(arch):
    for jc, tc in ((get_arch(arch).config, port_arch(arch).config),
                   (get_arch(arch).smoke, port_arch(arch).smoke)):
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_bytes_match_reference(arch):
    """The simulated serving clock reads parameter bytes: same tree, same
    total, and param_shapes names every leaf the reference's init makes."""
    cfg = port_arch(arch).smoke
    tp = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jp, _ = JaxLM(get_arch(arch).smoke).init(jax.random.PRNGKey(0))
    nbytes = lambda tree: sum(x.nbytes for x in jax.tree.leaves(tree))  # noqa: E731
    assert sum(t.numel() * t.element_size() for t in jax.tree.leaves(tp)) == nbytes(jp)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jp))
    assert list(tp["layers"]) == list(jp["layers"])
    assert list(tp["layers"]["attn"]) == list(jp["layers"]["attn"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jmodel, jparams, tmodel, tparams = _family(arch)
    toks = _tokens(0, 2, 24)
    hidden, _ = jmodel.forward(jparams, jnp.asarray(toks))
    want = np.asarray(jmodel.logits(jparams, hidden))
    got = tmodel.logits(tparams, tmodel.forward(tparams, torch.from_numpy(toks)))
    np.testing.assert_allclose(got.numpy(), want, **PREFILL_TOL)
    jst = jmodel.init_decode_state(2, 40)
    jl, jst = jmodel.prefill(jparams, jnp.asarray(toks), jst)
    tst = tmodel.init_decode_state(2, 40, "cpu")
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks), tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
    np.testing.assert_allclose(tst.kv["k"].numpy(), np.asarray(jst.kv["k"]), atol=1e-4)
    np.testing.assert_allclose(tst.kv["v"].numpy(), np.asarray(jst.kv["v"]), atol=1e-4)
    assert tst.length.tolist() == [24, 24]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_with_per_slot_lengths(arch):
    """Slots at different lengths (prompts of 18 and 5 tokens inserted into
    a shared state), decoded together for 6 steps: slot 0 runs past the
    window of 16 from the first step, slot 1 reaches 11."""
    jmodel, jparams, tmodel, tparams = _family(arch)
    b, max_len = 2, 32
    jst = jmodel.init_decode_state(b, max_len)
    tst = tmodel.init_decode_state(b, max_len, "cpu")
    jkv = {k: np.asarray(v).copy() for k, v in jst.kv.items()}
    lengths = []
    for slot, plen in enumerate((18, 5)):
        toks = _tokens(10 + slot, 1, plen)
        _, j1 = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_decode_state(1, max_len))
        _, t1 = tmodel.prefill(tparams, torch.from_numpy(toks),
                               tmodel.init_decode_state(1, max_len, "cpu"))
        for name in ("k", "v"):
            jkv[name][:, slot] = np.asarray(j1.kv[name])[:, 0]
            tst.kv[name][:, slot] = t1.kv[name][:, 0]
        lengths.append(plen)
    jst = JaxDecodeState(kv={k: jnp.asarray(v) for k, v in jkv.items()}, ssm=None,
                         cross_kv=None, length=jnp.asarray(lengths, jnp.int32))
    tst.length = torch.tensor(lengths, dtype=torch.int32)
    tok = _tokens(20, 1, b)[0]
    for _ in range(6):
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        tl, tst = tmodel.decode_step(tparams, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tst.length.tolist() == np.asarray(jst.length).tolist() == [24, 11]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_forward(arch):
    """prefill(t) + decode(token_t) == forward(t+1 tokens) last logits, past
    the window."""
    _, _, tmodel, tparams = _family(arch)
    toks = _tokens(40, 1, 21)
    st = tmodel.init_decode_state(1, 32, "cpu")
    _, st = tmodel.prefill(tparams, torch.from_numpy(toks[:, :-1]), st)
    dec, _ = tmodel.decode_step(tparams, st, torch.from_numpy(toks[:, -1]))
    full = tmodel.logits(tparams, tmodel.forward(tparams, torch.from_numpy(toks)))[:, -1]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_TOL)


@pytest.mark.parametrize("pattern", ["full", "swa", "gemma2", "hymba"])
@pytest.mark.parametrize("n_layers,window", [(7, 16), (46, 4096), (6, None)])
def test_window_sizes_match_reference(pattern, n_layers, window):
    kw = dict(name="x", n_layers=n_layers, d_model=8, n_q_heads=2, n_kv_heads=1,
              head_dim=4, d_ff=8, vocab=16, window_pattern=pattern, sliding_window=window)
    got = ModelConfig(**kw).window_sizes()
    want = np.asarray(JaxModelConfig(**kw).window_sizes()).tolist()
    assert got == want
    assert all(isinstance(w, int) for w in got)
    if pattern == "full" or window is None:
        assert got == [FULL_WINDOW] * n_layers


def test_sliding_window_masks_old_tokens():
    """The reference's tests/test_models.py check, ported: with a window of
    4 over 2 layers, the last position cannot see position 0."""
    cfg = dataclasses.replace(port_arch("h2o-danube-1.8b").smoke, dtype=torch.float32,
                              sliding_window=4)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    t1 = torch.from_numpy(_tokens(50, 1, 12, cfg.vocab)).long()
    t2 = t1.clone()
    t2[0, 0] = t1[0, 0] % (cfg.vocab - 1) + 1  # differs at pos 0
    h1 = model.forward(params, t1)
    h2 = model.forward(params, t2)
    # position 11 only sees positions >= 8 (window 4): identical output
    np.testing.assert_allclose(h1[:, -1].numpy(), h2[:, -1].numpy(), atol=1e-5)
    assert not torch.allclose(h1[:, 0], h2[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cluster_matches_reference(monkeypatch, arch):
    """build_cluster at the serve CLI's shapes (MIKU, both engines, 8-token
    prompts, 24 new tokens: past the window) on the CPU, the smoke config in
    f32 with the reference's init shared: the same result dict and the same
    greedy streams as the reference's build_cluster(arch, smoke=True)."""
    jspec, tspec = get_arch(arch), port_arch(arch)
    jcfg = dataclasses.replace(jspec.smoke, dtype=jnp.float32)
    tcfg = dataclasses.replace(tspec.smoke, dtype=torch.float32)
    monkeypatch.setattr(jserve, "get_arch",
                        lambda a: dataclasses.replace(jspec, smoke=jcfg))
    monkeypatch.setattr(port_serve, "get_arch",
                        lambda a: dataclasses.replace(tspec, smoke=tcfg))
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0))[0])
    shared = params_from_numpy(tree, tcfg, "cpu")
    monkeypatch.setattr(port_serve.TransformerLM, "init", lambda self, gen, dev=None: shared)
    res, streams = {}, {}
    for port in (False, True):
        cl = (port_serve.build_cluster(arch, n_requests=6, mode="miku", device="cpu")
              if port else jserve.build_cluster(arch, smoke=True, n_requests=6, mode="miku"))
        res[port] = cl.run(10_000)
        streams[port] = {e.cfg.name: sorted((r.rid, list(r.output)) for r in e.done)
                         for e in cl.engines}
    assert res[True] == res[False]
    assert streams[True] == streams[False]
    assert res[True]["hbm"]["requests"] == 6 and res[True]["host"]["requests"] == 2
    assert all(len(out) == 24 for s in streams[True].values() for _, out in s)


def test_query_scale_matches_reference():
    """gemma2-27b scales queries by (d_model / n_heads)^-0.5, not
    head_dim^-0.5: the smoke config with its own such scale, forward and
    decode past the window, against the reference."""
    scale = (128 / 4) ** -0.5 * 1.5
    jcfg = dataclasses.replace(get_arch("gemma2-27b").smoke, dtype=jnp.float32,
                               query_scale=scale)
    tcfg = dataclasses.replace(port_arch("gemma2-27b").smoke, dtype=torch.float32,
                               query_scale=scale)
    jmodel, tmodel = JaxLM(jcfg), TransformerLM(tcfg)
    tree = _noisy(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(2))[0]),
                  np.random.default_rng(3))
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tcfg, "cpu")
    toks = _tokens(60, 1, 20)
    jl, jst = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_decode_state(1, 32))
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks),
                             tmodel.init_decode_state(1, 32, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        tl, tst = tmodel.decode_step(tparams, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    plain = dataclasses.replace(tcfg, query_scale=None)
    other, _ = TransformerLM(plain).prefill(tparams, torch.from_numpy(toks),
                                            TransformerLM(plain).init_decode_state(1, 32, "cpu"))
    assert not torch.allclose(other, TransformerLM(tcfg).prefill(
        tparams, torch.from_numpy(toks), tmodel.init_decode_state(1, 32, "cpu"))[0])


def test_long_prompt_admits_into_a_slot_that_holds_it():
    """The shape of the gemma2-27b serve run on the card (a 5,120-token and
    an 8-token prompt, 2 slots of 5,248, 16 new tokens each) at the smoke
    widths and a 2,048-token prompt in 2 slots of 2,176: the long prompt
    takes the query-blocked prefill and crosses the window, and its greedy
    stream equals a batch-1 prefill + decode loop."""
    from repro_torch.serving import engine as teng

    _, _, tmodel, tparams = _family("gemma2-27b")
    cfg = tmodel.cfg
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (2048, 8)]
    eng = teng.ServingEngine(teng.EngineConfig(name="hbm", model=cfg, max_slots=2,
                                               max_len=2176), tparams)
    for rid, p in enumerate(prompts):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=16))
    res = teng.TieredServingCluster([eng]).run(1000)
    assert res["hbm"]["requests"] == 2 and eng.decode_steps == 15
    assert eng.state.length.tolist() == [2048 + 15, 8 + 15]
    st = tmodel.init_decode_state(1, 2176, "cpu")
    logits, st = tmodel.prefill(tparams, torch.tensor([prompts[0]]), st)
    want = [int(logits[0].argmax())]
    for _ in range(15):
        logits, st = tmodel.decode_step(tparams, st, torch.tensor([want[-1]]))
        want.append(int(logits[0].argmax()))
    assert sorted((r.rid, r.output) for r in eng.done)[0] == (0, want)
