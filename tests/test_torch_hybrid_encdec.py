"""Port parity: hymba's hybrid block, whisper's encoder-decoder and
internvl2's early fusion in repro_torch.models against the reference's
TransformerLM on their smoke configs in f32, weights shared through
params_from_numpy.

The reference initialises norms and biases to zero; the shared weights
here replace every zero leaf with seeded noise, so every norm (the cross
and encoder norms included) takes part.  Bounds are the reference's own
(tests/test_models.py): 2e-3 for forward and prefill logits, 3e-3 for
decode logits.  Hymba's prompts cross its smoke window of 16, and its SSM
state goes through every slot; whisper attends to 32 seeded frames per
slot; internvl2 fuses 8 seeded patch embeddings."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_arch
from repro.models import attention as jattn
from repro.models.transformer import DecodeState as JaxDecodeState
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import get_arch as port_arch
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving import engine as teng

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ARCHS = ["hymba-1.5b", "whisper-large-v3", "internvl2-2b"]
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


def _frontend(cfg, seed, b):
    """Seeded frontend embeddings: the encoder's frames (audio) or the
    patch embeddings (vision), None for a text-only model."""
    n = {"audio": cfg.encoder_seq, "vision": cfg.frontend_seq}.get(cfg.frontend)
    if n is None:
        return None
    return np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)).astype(np.float32)


def _both(arr):
    """(JAX array or None, torch tensor or None)."""
    if arr is None:
        return None, None
    return jnp.asarray(arr), torch.from_numpy(arr)


def _close_trees(got, want, tol=1e-4):
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=tol,
                                   rtol=tol, err_msg=name)


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
    """Same tree, same bytes, and the leaves of every stack in the
    reference's order (hymba: attn, ssm, mlp without pre_ssm_norm; whisper:
    cross and pre_cross_norm between attn and mlp, enc_layers and
    enc_final_norm; tied embeddings: no lm_head)."""
    cfg = port_arch(arch).smoke
    tp = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jp, _ = JaxLM(get_arch(arch).smoke).init(jax.random.PRNGKey(0))
    nbytes = lambda tree: sum(x.nbytes for x in jax.tree.leaves(tree))  # noqa: E731
    assert sum(t.numel() * t.element_size() for t in jax.tree.leaves(tp)) == nbytes(jp)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jp))
    assert list(tp) == list(jp)
    for stack in ("layers", "enc_layers"):
        if stack in jp:
            assert list(tp[stack]) == list(jp[stack])
            for sub in tp[stack].values():
                if isinstance(sub, dict):
                    assert all(isinstance(t, torch.Tensor) for t in sub.values())
    # The weights bridge takes the reference's bf16 tree as it is: the SSM's
    # A_log, D and dt_bias stay f32, every other leaf is bf16.
    bridged = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    f32 = {k for k, t in bridged["layers"].get("ssm", {}).items() if t.dtype == torch.float32}
    assert f32 == ({"A_log", "D", "dt_bias"} if cfg.uses_ssm else set())
    assert sum(t.dtype == torch.bfloat16 for t in jax.tree.leaves(bridged)) == \
        len(jax.tree.leaves(bridged)) - len(f32)
    if arch == "hymba-1.5b":
        assert "pre_ssm_norm" not in tp["layers"] and "lm_head" not in tp
        assert {tp["layers"]["ssm"][k].dtype for k in ("A_log", "D", "dt_bias")} == \
            {torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    """Forward hidden states and logits, prefill's last logits and every
    piece of state it writes (K/V prefix, SSM h and conv, cross K/V)."""
    jmodel, jparams, tmodel, tparams = _family(arch)
    toks = _tokens(0, 2, 24)
    jfe, tfe = _both(_frontend(tmodel.cfg, 5, 2))
    jhidden, _ = jmodel.forward(jparams, jnp.asarray(toks), frontend_embeds=jfe)
    thidden = tmodel.forward(tparams, torch.from_numpy(toks), frontend_embeds=tfe)
    np.testing.assert_allclose(thidden.numpy(), np.asarray(jhidden), **PREFILL_TOL)
    np.testing.assert_allclose(tmodel.logits(tparams, thidden).numpy(),
                               np.asarray(jmodel.logits(jparams, jhidden)), **PREFILL_TOL)
    jl, jst = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_decode_state(2, 40),
                             frontend_embeds=jfe)
    tst0 = tmodel.init_decode_state(2, 40, "cpu")
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks), tst0, frontend_embeds=tfe)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
    _close_trees(tst.kv, jst.kv)
    assert tst.length.tolist() == [24, 24]
    for name, tpart, jpart in (("ssm", tst.ssm, jst.ssm), ("cross_kv", tst.cross_kv,
                                                          jst.cross_kv)):
        assert (tpart is None) == (jpart is None), name
        if tpart is not None:
            _close_trees(tpart, jpart)
    # Prefill writes the state in place.
    for part in ("kv", "ssm", "cross_kv"):
        if getattr(tst, part) is not None:
            assert all(getattr(tst, part)[n] is getattr(tst0, part)[n]
                       for n in getattr(tst, part))


def _slot_states(jmodel, jparams, tmodel, tparams, prompts, frontends, max_len):
    """Both sides' multi-slot states from batch-1 prefills (slot i: prompt
    i, frontend i), inserted as the serving engine inserts them, and the
    first greedy tokens."""
    b = len(prompts)
    jst = jmodel.init_decode_state(b, max_len)
    tst = tmodel.init_decode_state(b, max_len, "cpu")
    parts = [p for p in ("kv", "ssm", "cross_kv") if getattr(jst, p) is not None]
    jnp_parts = {p: {k: np.asarray(v).copy() for k, v in getattr(jst, p).items()}
                 for p in parts}
    first = []
    for slot, (toks, fe) in enumerate(zip(prompts, frontends)):
        jfe, tfe = _both(fe)
        jl, j1 = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_decode_state(1, max_len),
                                frontend_embeds=jfe)
        tl, t1 = tmodel.prefill(tparams, torch.from_numpy(toks),
                                tmodel.init_decode_state(1, max_len, "cpu"),
                                frontend_embeds=tfe)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
        for p in parts:
            for name in jnp_parts[p]:
                jnp_parts[p][name][:, slot] = np.asarray(getattr(j1, p)[name])[:, 0]
                getattr(tst, p)[name][:, slot] = getattr(t1, p)[name][:, 0]
        first.append(int(np.argmax(np.asarray(jl)[0])))
    lengths = [p.shape[1] for p in prompts]
    jst = JaxDecodeState(**{p: ({k: jnp.asarray(v) for k, v in jnp_parts[p].items()}
                                if p in jnp_parts else None)
                            for p in ("kv", "ssm", "cross_kv")},
                         length=jnp.asarray(lengths, jnp.int32))
    tst.length = torch.tensor(lengths, dtype=torch.int32)
    return jst, tst, np.asarray(first, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_with_per_slot_lengths(arch):
    """Slots at different lengths (prompts of 18 and 9 tokens, each with
    its own frames or patches) decoded together for 6 steps: hymba's slot 0
    runs past the window of 16 from the first step, with its SSM state;
    whisper attends to each slot's own encoder memory."""
    jmodel, jparams, tmodel, tparams = _family(arch)
    prompts = [_tokens(10 + i, 1, n) for i, n in enumerate((18, 9))]
    frontends = [_frontend(tmodel.cfg, 30 + i, 1) for i in range(2)]
    jst, tst, tok = _slot_states(jmodel, jparams, tmodel, tparams, prompts, frontends, 32)
    for _ in range(6):
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        tl, tst = tmodel.decode_step(tparams, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tst.length.tolist() == np.asarray(jst.length).tolist() == [24, 15]
    if tst.ssm is not None:
        _close_trees(tst.ssm, jst.ssm, 1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_forward(arch):
    """prefill(t) + decode(token_t) == forward(t+1 tokens) last logits, past
    hymba's window; the same frames or patches on both sides."""
    _, _, tmodel, tparams = _family(arch)
    toks = torch.from_numpy(_tokens(40, 1, 21))
    fe = _both(_frontend(tmodel.cfg, 41, 1))[1]
    st = tmodel.init_decode_state(1, 32, "cpu")
    _, st = tmodel.prefill(tparams, toks[:, :-1], st, frontend_embeds=fe)
    dec, _ = tmodel.decode_step(tparams, st, toks[:, -1])
    full = tmodel.logits(tparams, tmodel.forward(tparams, toks, frontend_embeds=fe))[:, -1]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_TOL)


def test_encode_and_cross_kv_match_reference():
    """Whisper's encoder output over 32 frames and the cross K/V of every
    decoder layer, on their own."""
    jmodel, jparams, tmodel, tparams = _family("whisper-large-v3")
    jfe, tfe = _both(_frontend(tmodel.cfg, 50, 2))
    np.testing.assert_allclose(tmodel.encode(tparams, tfe).numpy(),
                               np.asarray(jmodel.encode(jparams, jfe)), atol=1e-4, rtol=1e-4)
    want = jmodel._cross_memory(jparams, jfe)
    got = tmodel._cross_memory(tparams, tfe)
    assert got["k"].shape == (2, 2, 32, 4, 32)
    _close_trees(got, want)


def _attn_params(seed, d=64, hq=4, hkv=2, dh=16, bias=True):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, hq, dh)) * d**-0.5,
         "wk": rng.standard_normal((d, hkv, dh)) * d**-0.5,
         "wv": rng.standard_normal((d, hkv, dh)) * d**-0.5,
         "wo": rng.standard_normal((hq, dh, d)) * (hq * dh)**-0.5}
    if bias:
        p.update(bq=0.1 * rng.standard_normal((hq, dh)), bk=0.1 * rng.standard_normal((hkv, dh)),
                 bv=0.1 * rng.standard_normal((hkv, dh)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("s,q_block,window", [(24, 1024, 1 << 30), (32, 8, 1 << 30),
                                              (32, 8, 5)])
def test_attend_full_noncausal_matches_reference(s, q_block, window):
    """The encoder's attention (causal=False: |s - t| < window), one-shot
    and query-blocked, against the reference's."""
    jp, tp = _attn_params(60)
    x = np.random.default_rng(61).standard_normal((2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s))
    want = jattn.attend_full(jp, jnp.asarray(x), jnp.asarray(pos), rope_theta=None,
                             window=window, causal=False, q_block=q_block)
    got = tattn.attend_full(tp, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            rope_theta=None, window=window, causal=False, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,q_block", [(24, 0), (32, 8), (1, 0)])
def test_attend_cross_matches_reference(s, q_block):
    """Cross-attention against a 40-row memory (biases on the memory K/V):
    one shot, query-blocked, and one decode row (the kernel's path, its
    plain version on the CPU)."""
    jp, tp = _attn_params(70)
    rng = np.random.default_rng(71)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 40, 64)).astype(np.float32)
    jk, jv = jattn.project_memory_kv(jp, jnp.asarray(mem))
    tk, tv = tattn.project_memory_kv(tp, torch.from_numpy(mem))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    want = jattn.attend_cross(jp, jnp.asarray(x), jk, jv, q_block=q_block)
    got = tattn.attend_cross(tp, torch.from_numpy(x), tk, tv, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "internvl2-2b"])
def test_build_cluster_matches_reference(monkeypatch, arch):
    """build_cluster at the serve CLI's shapes (MIKU, both engines, 8-token
    text prompts, 24 new tokens: past hymba's window) on the CPU, the smoke
    config in f32 with the reference's init shared: the same result dict
    and the same greedy streams as the reference's."""
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


def test_encoder_decoder_without_frames_raises():
    """The reference asserts; the port raises ValueError in forward and
    prefill."""
    _, _, tmodel, tparams = _family("whisper-large-v3")
    toks = torch.from_numpy(_tokens(80, 1, 8))
    with pytest.raises(ValueError, match="frame"):
        tmodel.forward(tparams, toks)
    with pytest.raises(ValueError, match="frame"):
        tmodel.prefill(tparams, toks, tmodel.init_decode_state(1, 16, "cpu"))


def test_vision_prompt_shorter_than_its_patches_raises():
    _, _, tmodel, tparams = _family("internvl2-2b")
    patches = torch.from_numpy(_frontend(tmodel.cfg, 81, 1))
    with pytest.raises(ValueError, match="patch"):
        tmodel.forward(tparams, torch.from_numpy(_tokens(82, 1, 5)), frontend_embeds=patches)
    # Exactly as many positions as patches: every position is a patch.
    hidden = tmodel.forward(tparams, torch.from_numpy(_tokens(82, 1, 8)),
                            frontend_embeds=patches)
    assert hidden.shape == (1, 8, tmodel.cfg.d_model)


def test_serving_engine_refuses_encoder_decoder():
    _, _, tmodel, tparams = _family("whisper-large-v3")
    with pytest.raises(ValueError, match="encoder-decoder"):
        teng.ServingEngine(teng.EngineConfig(name="hbm", model=tmodel.cfg), tparams)


def test_hybrid_long_prompt_admits_into_a_slot():
    """hymba's serve shape on the card (a 2,048-token and an 8-token
    prompt, 16 new tokens each) at the smoke widths in 2 slots of 2,112:
    the long prompt takes the query-blocked prefill and 128 scan chunks,
    decode runs past the window with the SSM state in its slot, and its
    greedy stream equals a batch-1 prefill + decode loop."""
    _, _, tmodel, tparams = _family("hymba-1.5b")
    cfg = tmodel.cfg
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (2048, 8)]
    eng = teng.ServingEngine(teng.EngineConfig(name="hbm", model=cfg, max_slots=2,
                                               max_len=2112), tparams)
    for rid, p in enumerate(prompts):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=16))
    res = teng.TieredServingCluster([eng]).run(1000)
    assert res["hbm"]["requests"] == 2 and eng.decode_steps == 15
    assert eng.state.length.tolist() == [2048 + 15, 8 + 15]
    st = tmodel.init_decode_state(1, 2112, "cpu")
    logits, st = tmodel.prefill(tparams, torch.tensor([prompts[0]]), st)
    want = [int(logits[0].argmax())]
    for _ in range(15):
        logits, st = tmodel.decode_step(tparams, st, torch.tensor([want[-1]]))
        want.append(int(logits[0].argmax()))
    assert sorted((r.rid, r.output) for r in eng.done)[0] == (0, want)
