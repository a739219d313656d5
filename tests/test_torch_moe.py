"""Port parity: the MoE families (dbrx: an MoE FFN in every layer, 16 experts
top-4; llama4-maverick: dense/MoE pairs, 128 experts top-1 and a shared
expert) of repro_torch.models against the reference on their smoke configs
in f32, weights shared through params_from_numpy.

``moe_apply`` is held to tests/test_moe.py's dense per-token loop and to the
reference's ``moe_apply`` on the same inputs: outputs within 1e-5, the aux
loss within 1e-6, and the same dropped (token, expert) requests, read from
the reference's own top-k by the capacity rule in plain Python.  Model
bounds are the reference's (tests/test_models.py): 2e-3 for prefill
logits, 3e-3 for decode logits.  Capacity couples the tokens of a call, so
the serving tests compare engine against engine."""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_arch
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_init as jax_moe_init
from repro.models.transformer import DecodeState as JaxDecodeState
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import get_arch as port_arch
from repro_torch.launch import serve as port_serve
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import TransformerLM, param_shapes
from repro_torch.models.weights import params_from_numpy

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
PREFILL_TOL = dict(atol=2e-3, rtol=2e-3)
DECODE_TOL = dict(atol=3e-3, rtol=3e-3)
#: moe_apply against the reference's on the same f32 inputs: the products
#: differ only in summation order.
MOE_TOL = dict(atol=1e-5, rtol=0)
AUX_TOL = dict(atol=1e-6, rtol=0)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _moe_params(d, f, e, shared=0, seed=0):
    """(reference params, port params): the reference's moe_init, shared."""
    jp, _ = jax_moe_init(jax.random.PRNGKey(seed), d, f, e, jnp.float32,
                         shared_expert_ff=shared)
    return jp, _torch_tree(jax.tree.map(np.asarray, jp))


def dense_reference(params, x, top_k):
    """tests/test_moe.py's dense per-token loop: the plain MoE semantics
    without capacity drops (numpy, f32)."""
    b, s, d = x.shape
    xf = np.asarray(x, np.float32).reshape(-1, d)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(xf @ np.asarray(params["router"])), axis=-1))
    out = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        top = np.argsort(-gates[t])[:top_k]
        w = gates[t][top] / gates[t][top].sum()
        for wi, ei in zip(w, top):
            h = xf[t] @ np.asarray(params["w_gate"][ei])
            h = h / (1 + np.exp(-h)) * (xf[t] @ np.asarray(params["w_up"][ei]))
            out[t] += wi * (h @ np.asarray(params["w_down"][ei]))
    return out.reshape(b, s, d)


def reference_drops(params, x, top_k, capacity_factor):
    """The (token, expert) requests the reference drops: its own top-k over
    its router's gates, then per expert the requests in flat order
    ``token * k + j`` beyond the first ``capacity``."""
    d = x.shape[-1]
    router = params["router"]
    gates = jax.nn.softmax(jnp.einsum("td,de->te", jnp.asarray(x).reshape(-1, d), router)
                           .astype(jnp.float32), axis=-1)
    idx = np.asarray(jax.lax.top_k(gates, top_k)[1])
    t, e = idx.shape[0], router.shape[-1]
    cap = min(int(max(top_k, capacity_factor * t * top_k / e)), t)
    seen, drops = collections.Counter(), set()
    for flat, ex in enumerate(idx.reshape(-1).tolist()):
        if seen[ex] >= cap:
            drops.add((flat // top_k, ex))
        seen[ex] += 1
    return drops


def port_drops(params, x, top_k, capacity_factor):
    """The (token, expert) requests the port's dispatch drops."""
    xf = x.reshape(-1, x.shape[-1])
    _, _, idx = tmoe.route(params, xf, top_k)
    e = params["router"].shape[-1]
    cap = tmoe.capacity(xf.shape[0], top_k, e, capacity_factor)
    sort_idx, sorted_e, _, keep = tmoe.dispatch(idx, e, cap)
    return {(s // top_k, ex) for s, ex, k in zip(sort_idx.tolist(), sorted_e.tolist(),
                                                 keep.tolist()) if not k}


def _against_reference(jp, tp, x, top_k, capacity_factor):
    """The port's moe_apply against the reference's on ``x`` (numpy): the
    output, the aux loss and the dropped requests.  Returns (port output,
    dropped requests)."""
    want, want_aux = jax_moe_apply(jp, jnp.asarray(x), top_k=top_k,
                                   capacity_factor=capacity_factor)
    xt = torch.from_numpy(x)
    got, aux = tmoe.moe_apply(tp, xt, top_k=top_k, capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX_TOL)
    drops = port_drops(tp, xt, top_k, capacity_factor)
    assert drops == reference_drops(jp, x, top_k, capacity_factor)
    return got, drops


@pytest.mark.parametrize("top_k,e", [(1, 4), (2, 4), (4, 8)])
def test_moe_matches_dense_loop(top_k, e):
    d, f = 16, 32
    jp, tp = _moe_params(d, f, e)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 6, d), jnp.float32))
    got, drops = _against_reference(jp, tp, x, top_k, 64.0)
    np.testing.assert_allclose(got.numpy(), dense_reference(jp, x, top_k), atol=1e-4, rtol=1e-3)
    assert not drops


def test_moe_capacity_drops_tokens_not_crash():
    """cf 0.25: capacity 4 for 64 requests over 4 experts."""
    d, f, e = 16, 32, 4
    jp, tp = _moe_params(d, f, e)
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (4, 8, d), jnp.float32))
    got, drops = _against_reference(jp, tp, x, 2, 0.25)
    assert tmoe.capacity(32, 2, e, 0.25) == 4
    assert len(drops) >= 64 - 4 * e
    assert got.shape == x.shape and torch.isfinite(got).all()


def test_moe_shared_expert_adds_dense_path():
    d, f, e = 16, 32, 4
    jp, tp = _moe_params(d, f, e, shared=32)
    assert "shared" in tp and tuple(tp["shared"]["w_down"].shape) == (32, d)
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 4, d), jnp.float32))
    got, _ = _against_reference(jp, tp, x, 1, 8.0)
    routed, _ = tmoe.moe_apply({k: v for k, v in tp.items() if k != "shared"},
                               torch.from_numpy(x), top_k=1, capacity_factor=8.0)
    xf = torch.from_numpy(x)
    sh = tp["shared"]
    dense = (torch.nn.functional.silu(xf @ sh["w_gate"]) * (xf @ sh["w_up"])) @ sh["w_down"]
    np.testing.assert_allclose((got - routed).numpy(), dense.numpy(), atol=1e-5)


@pytest.mark.parametrize("tie", ["uniform", "paired_columns"])
def test_top_k_ties_take_the_lower_expert(tie):
    """Equal gates route to the lower expert first, as jax.lax.top_k does:
    a zero router (every gate 1/E) or integer-valued inputs against a
    router whose columns 5 and 7 repeat columns 2 and 0 (exactly equal
    logits).  Capacity then drops the later tokens of the tied experts."""
    d, f, e, top_k = 16, 32, 8, 2
    jp, _ = _moe_params(d, f, e)
    rng = np.random.default_rng(4)
    if tie == "uniform":
        router = np.zeros((d, e), np.float32)
        x = rng.standard_normal((2, 6, d)).astype(np.float32)
    else:
        router = 0.25 * rng.integers(-1, 2, (d, e)).astype(np.float32)
        router[:, 5], router[:, 7] = router[:, 2], router[:, 0]
        x = rng.integers(-2, 3, (2, 6, d)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    _, _, idx = tmoe.route(tp, torch.from_numpy(x).reshape(-1, d), top_k)
    want_idx = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.reshape(-1, d) @ router),
                                                        axis=-1), top_k)[1])
    assert idx.tolist() == want_idx.tolist()
    if tie == "uniform":
        assert idx.tolist() == [[0, 1]] * 12
    else:
        # Expert 5 (7) is taken only beside its twin 2 (0), never instead.
        rows = [set(r) for r in idx.tolist()]
        assert all(2 in r for r in rows if 5 in r) and all(0 in r for r in rows if 7 in r)
        assert sum(bool(r & {0, 2}) for r in rows) >= 4
    _, drops = _against_reference(jp, tp, x, top_k, 0.5)
    if tie == "uniform":
        assert drops == {(t, ex) for t in range(2, 12) for ex in (0, 1)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_reference(arch):
    assert arch in PORT_ARCH_IDS and port_arch(arch).arch_id == arch
    for jc, tc in ((get_arch(arch).config, port_arch(arch).config),
                   (get_arch(arch).smoke, port_arch(arch).smoke)):
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
        assert (tc.paired, tc.n_scan) == (jc.paired, jc.n_scan)


@pytest.mark.parametrize("arch", PORT_ARCH_IDS)
def test_param_counts_match_reference(arch):
    """All 11 archs, full and smoke: the analytic total and active counts."""
    for jc, tc in ((get_arch(arch).config, port_arch(arch).config),
                   (get_arch(arch).smoke, port_arch(arch).smoke)):
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


def _layout(tree):
    """Leaf names in insertion order with each leaf's shape."""
    return [(k, _layout(v) if isinstance(v, dict) else tuple(v.shape)) for k, v in tree.items()]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """The port's init and param_shapes give the reference's tree: leaf
    names, order and shapes, and the same bytes (the serving clock reads
    them).  llama4's pairs draw the dense sublayer (FFN d_ff_dense) first;
    an MoE sublayer has pre_mlp_norm and no post_mlp_norm."""
    cfg = port_arch(arch).smoke
    tp = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jp, _ = JaxLM(get_arch(arch).smoke).init(jax.random.PRNGKey(0))
    assert _layout(tp) == _layout(jp)
    shapes = param_shapes(cfg)
    assert _layout(jax.tree.map(lambda x: np.zeros(0), tp)) == _layout(
        jax.tree.map(lambda x: np.zeros(0), shapes, is_leaf=lambda v: isinstance(v, tuple)))
    nbytes = lambda tree: sum(x.nbytes for x in jax.tree.leaves(tree))  # noqa: E731
    assert sum(t.numel() * t.element_size() for t in jax.tree.leaves(tp)) == nbytes(jp)
    moe = tp["layers"]["moe"] if cfg.paired else tp["layers"]
    assert "post_mlp_norm" not in moe and list(moe["moe"])[:4] == [
        "router", "w_gate", "w_up", "w_down"]
    if cfg.paired:
        assert list(tp["layers"]) == ["dense", "moe"]
        assert tuple(tp["layers"]["dense"]["mlp"]["w_gate"].shape) == (
            cfg.n_scan, cfg.d_model, cfg.d_ff_dense)
        assert tuple(moe["moe"]["w_gate"].shape) == (cfg.n_scan, cfg.n_experts, cfg.d_model,
                                                    cfg.d_ff)
        assert "shared" in moe["moe"]


def _noisy(tree, rng):
    """The tree with each all-zero leaf (the norm scales) replaced by 0.1 x
    a standard normal."""
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
    tree = _noisy(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0]),
                  np.random.default_rng(1))
    return (jmodel, jax.tree.map(jnp.asarray, tree), TransformerLM(tcfg),
            params_from_numpy(tree, tcfg, "cpu"))


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    """Forward (logits and the summed aux loss), a batch-2 prefill (the K/V
    of every flat layer, llama4's in the pair view's order) and 3 decode
    steps, each routing all its tokens with one capacity."""
    jmodel, jparams, tmodel, tparams = _family(arch)
    toks = _tokens(0, 2, 12)
    hidden, jaux = jmodel.forward(jparams, jnp.asarray(toks))
    want = np.asarray(jmodel.logits(jparams, hidden))
    thidden, aux = tmodel.forward(tparams, torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(tmodel.logits(tparams, thidden).numpy(), want, **PREFILL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)
    assert float(aux) > 0
    assert torch.equal(tmodel.forward(tparams, torch.from_numpy(toks)), thidden)
    jst = jmodel.init_decode_state(2, 24)
    jl, jst = jmodel.prefill(jparams, jnp.asarray(toks), jst)
    tst = tmodel.init_decode_state(2, 24, "cpu")
    tl, tst = tmodel.prefill(tparams, torch.from_numpy(toks), tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tst.kv[name].numpy(), np.asarray(jst.kv[name]), atol=1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        tl, tst = tmodel.decode_step(tparams, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tst.length.tolist() == np.asarray(jst.length).tolist() == [15, 15]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_with_per_slot_lengths(arch):
    """Slots at different lengths (prompts of 9 and 3 tokens, each
    prefilled alone) decoded together for 3 steps: at decode both slots'
    tokens share each expert's capacity (llama4's smoke: 1)."""
    jmodel, jparams, tmodel, tparams = _family(arch)
    b, max_len = 2, 16
    jst = jmodel.init_decode_state(b, max_len)
    tst = tmodel.init_decode_state(b, max_len, "cpu")
    jkv = {k: np.asarray(v).copy() for k, v in jst.kv.items()}
    for slot, plen in enumerate((9, 3)):
        toks = _tokens(10 + slot, 1, plen)
        _, j1 = jmodel.prefill(jparams, jnp.asarray(toks), jmodel.init_decode_state(1, max_len))
        _, t1 = tmodel.prefill(tparams, torch.from_numpy(toks),
                               tmodel.init_decode_state(1, max_len, "cpu"))
        for name in ("k", "v"):
            jkv[name][:, slot] = np.asarray(j1.kv[name])[:, 0]
            tst.kv[name][:, slot] = t1.kv[name][:, 0]
    jst = JaxDecodeState(kv={k: jnp.asarray(v) for k, v in jkv.items()}, ssm=None,
                         cross_kv=None, length=jnp.asarray([9, 3], jnp.int32))
    tst.length = torch.tensor([9, 3], dtype=torch.int32)
    tok = _tokens(20, 1, b)[0]
    for _ in range(3):
        jl, jst = jmodel.decode_step(jparams, jst, jnp.asarray(tok))
        tl, tst = tmodel.decode_step(tparams, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_forward(arch):
    """prefill(t) + decode(token_t) == forward(t+1 tokens) last logits, at a
    capacity factor (64) at which no call drops a request: only then does a
    token's route not depend on the tokens that share its call."""
    _, _, tmodel, tparams = _family(arch)
    model = TransformerLM(dataclasses.replace(tmodel.cfg, capacity_factor=64.0))
    toks = _tokens(40, 1, 9)
    st = model.init_decode_state(1, 32, "cpu")
    _, st = model.prefill(tparams, torch.from_numpy(toks[:, :-1]), st)
    dec, _ = model.decode_step(tparams, st, torch.from_numpy(toks[:, -1]))
    full = model.logits(tparams, model.forward(tparams, torch.from_numpy(toks)))[:, -1]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cluster_matches_reference(monkeypatch, arch):
    """build_cluster at the serve CLI's shapes (MIKU, both engines of 4
    slots, 8-token prompts, 24 new tokens) on the CPU, the smoke config in
    f32 with the reference's init shared: the same result dict and the same
    greedy streams as the reference's build_cluster(arch, smoke=True).  A
    decode step routes all 4 slots' tokens, idle ones included, so llama4's
    capacity of 1 drops requests here too."""
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
