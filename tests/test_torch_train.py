"""Port parity: the training pieces of repro_torch against the reference on
the CPU: the learning-rate schedules, AdamW and gradient clipping, the
chunked cross entropy and the eval step, remat and the blocked attention
under autograd,
K4's autograd Function, the straggler governor and its step-timing
substrate, and the Trainer's loss falling over a short run.

Inputs come from numpy seeds.  Tolerances: schedules 1e-6 relative;
AdamW's f32 leaves 1e-6 relative + 1e-9 absolute, its bf16 params within
one bf16 step (2^-8 relative) since an f32 master a rounding apart can
round to the neighbouring bf16 value; clipping 1e-6; the cross entropy and
its gradient 1e-6 relative (f32); remat and the blocked attention give the
one-shot path's gradients within 1e-6 of each leaf's scale; K4's Function
gives autograd-through-ssd_chunked's gradients within 1e-6; the
straggler governor's decisions equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch
from repro.core.controller import StragglerGovernor as JaxGovernor
from repro.core.substrate import ControlLoop as JaxControlLoop
from repro.core.substrate import StepTimingSubstrate as JaxStepTiming
from repro.models import attention as jattn
from repro.models.transformer import TransformerLM as JaxLM
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train.step import chunked_cross_entropy as jax_cce
from repro.train.step import make_eval_step as jax_make_eval_step
from repro_torch.configs import get_arch as port_arch
from repro_torch.core.controller import HostHealth, StragglerGovernor
from repro_torch.core.invariants import InvariantViolation
from repro_torch.core.substrate import ControlLoop, StepTimingSubstrate
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.launch.train import Trainer
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.weights import params_from_numpy
from repro_torch.optim import AdamW, OptState, clip_by_global_norm, constant, warmup_cosine
from repro_torch.pytree import flatten_with_paths, tree_leaves
from repro_torch.train.step import chunked_cross_entropy, make_eval_step, make_grad_fn

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "h2o-danube-1.8b", "mamba2-2.7b", "dbrx-132b")


def _smoke(arch):
    jcfg = dataclasses.replace(get_arch(arch).smoke, dtype=jnp.float32)
    tcfg = dataclasses.replace(port_arch(arch).smoke, dtype=torch.float32)
    jparams, _ = JaxLM(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _rel_close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (what, np.abs(got - want).max(), scale)


# -- schedules ------------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 9, 10, 55, 100, 101, 250])
def test_schedules_match_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(float(warmup_cosine(step, **kw)),
                               float(jschedule.warmup_cosine(step, **kw)), rtol=1e-6)
    np.testing.assert_allclose(float(warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                                   min_ratio=0.2, **kw)),
                               float(jschedule.warmup_cosine(step, min_ratio=0.2, **kw)),
                               rtol=1e-6)
    assert float(constant(torch.tensor(step), peak_lr=3e-4)) == \
        float(jschedule.constant(step, peak_lr=3e-4))
    if step == 0:
        assert float(warmup_cosine(step, **kw)) == 0.0


# -- AdamW and clipping ---------------------------------------------------------------------


def _random_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": {"a": rng.normal(size=(3, 4, 2)).astype(ml_dtypes.bfloat16),
                       "b": rng.normal(size=(7,)).astype(np.float32)},
            "e": rng.normal(size=(9, 3)).astype(ml_dtypes.bfloat16)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
             if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v.copy()))
            for k, v in tree.items()}


@pytest.mark.parametrize("master", [True, False])
def test_adamw_update_matches_reference(master):
    rng = np.random.default_rng(3)
    params = _random_tree(rng)
    jopt, topt = jadamw.AdamW(master=master), AdamW(master=master)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.1).astype(p.dtype), params)
        lr = 1e-2 * (step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp, jnp.float32(lr))
        tp2, ts2 = topt.update(_to_torch(grads), ts, tp, torch.tensor(lr, dtype=torch.float32))
        assert tp2 is tp and ts2 is ts  # in place
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    assert (ts.master is None) == (not master)
    want = dict(flatten_with_paths({"params": jp, "m": js.m, "v": js.v, "master": js.master}))
    got = dict(flatten_with_paths({"params": tp, "m": ts.m, "v": ts.v, "master": ts.master}))
    assert sorted(want) == sorted(got)
    for key, g in got.items():
        w = np.asarray(want[key], np.float32)
        if g.dtype == torch.bfloat16:
            assert key.startswith("params/")
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2.0**-8, atol=0, err_msg=key)
        else:
            assert g.dtype == torch.float32, key
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(4)
    grads = _random_tree(rng)
    jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
    tg, tn = clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for (key, g), (_, w) in zip(flatten_with_paths(tg), flatten_with_paths(jg)):
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=1e-6 if g.dtype == torch.float32 else 2.0**-8,
                                   err_msg=key)


def test_opt_state_leaves_follow_the_reference_order():
    params = _to_torch(_random_tree(np.random.default_rng(5)))
    state = AdamW().init(params)
    assert isinstance(state, OptState)
    keys = [k for k, _ in flatten_with_paths(state)]
    assert keys[0] == "step" and keys[1:4] == ["m/e", "m/layers/a", "m/layers/b"]
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.m) + tree_leaves(state.v))
    assert [k for k, _ in flatten_with_paths(AdamW(master=False).init(params))][-1] == "v/w"


# -- the loss -------------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 512])
def test_chunked_cross_entropy_matches_reference_and_one_shot(chunk):
    jcfg, tcfg, jparams, tparams = _smoke("qwen2.5-3b")
    rng = np.random.default_rng(6)
    hidden = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    want = float(jax_cce(JaxLM(jcfg), jparams, jnp.asarray(hidden), jnp.asarray(labels),
                         chunk=chunk))
    model = TransformerLM(tcfg)
    h = torch.from_numpy(hidden).requires_grad_()
    got = chunked_cross_entropy(model, tparams, h, torch.from_numpy(labels), chunk=chunk)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    (grad,) = torch.autograd.grad(got, h)
    h1 = torch.from_numpy(hidden).requires_grad_()
    logits = model.logits(tparams, h1).float()
    one_shot = F.cross_entropy(logits.reshape(-1, jcfg.vocab),
                               torch.from_numpy(labels).long().reshape(-1))
    np.testing.assert_allclose(float(got.detach()), float(one_shot.detach()), rtol=1e-6)
    (grad1,) = torch.autograd.grad(one_shot, h1)
    _rel_close(grad.numpy(), grad1.numpy(), 1e-5, "d loss / d hidden")


def test_eval_step_matches_reference():
    jcfg, tcfg, jparams, tparams = _smoke("dbrx-132b")
    rng = np.random.default_rng(14)
    tokens = rng.integers(1, jcfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(1, jcfg.vocab, (2, 32)).astype(np.int32)
    want = jax_make_eval_step(JaxLM(jcfg), loss_chunk=8)(jparams, jnp.asarray(tokens),
                                                         jnp.asarray(labels))
    got = make_eval_step(TransformerLM(tcfg), loss_chunk=8)(tparams, torch.from_numpy(tokens),
                                                            torch.from_numpy(labels))
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- remat and the blocked attention under autograd ------------------------------------------


def _grads(model, params, seed=8, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(1, model.cfg.vocab, (b, s)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(1, model.cfg.vocab, (b, s)).astype(np.int32))
    grads, loss, aux = make_grad_fn(model, loss_chunk=8)(params, tokens, labels)
    return dict(flatten_with_paths(grads)), float(loss), float(aux)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch, remat, monkeypatch):
    _, tcfg, _, tparams = _smoke(arch)
    want, wl, wa = _grads(TransformerLM(tcfg), tparams)
    calls = []
    block = TransformerLM._block
    monkeypatch.setattr(TransformerLM, "_block",
                        lambda self, *a, **kw: calls.append(1) or block(self, *a, **kw))
    got, gl, ga = _grads(TransformerLM(tcfg, remat=remat), tparams)
    assert len(calls) == 2 * tcfg.n_layers  # each body ran again in the backward
    assert (gl, ga) == pytest.approx((wl, wa), rel=1e-6)
    for key, w in want.items():
        _rel_close(got[key].numpy(), w.numpy(), 1e-6, key)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(port_arch("qwen2.5-3b").smoke, remat="some")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "h2o-danube-1.8b"])
def test_blocked_attention_gives_the_one_shot_gradients(arch, monkeypatch):
    """S = 32 = 2 x q_block: the model's attention takes the blocked path,
    each block checkpointed, and its gradients are the one-shot path's."""
    _, tcfg, _, tparams = _smoke(arch)
    want, wl, _ = _grads(TransformerLM(tcfg), tparams)
    checkpoints = []
    real = tattn.checkpoint
    monkeypatch.setattr(tattn, "checkpoint",
                        lambda *a, **kw: checkpoints.append(1) or real(*a, **kw))
    monkeypatch.setattr(tattn, "attend_full", functools.partial(tattn.attend_full, q_block=16))
    got, gl, _ = _grads(TransformerLM(tcfg), tparams)
    assert len(checkpoints) == 2 * tcfg.n_layers
    assert gl == pytest.approx(wl, rel=1e-6)
    for key, w in want.items():
        _rel_close(got[key].numpy(), w.numpy(), 1e-6, key)


def test_blocked_attention_gradients_match_reference():
    """attend_full at S = 2 x q_block under autograd against jax.grad of the
    reference's (its blocks under jax.checkpoint), window and softcap on."""
    jcfg, tcfg, jparams, tparams = _smoke("qwen2.5-3b")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda v: v[0], jparams["layers"]["attn"])
    tlayer = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    pos = np.broadcast_to(np.arange(32)[None], (2, 32)).astype(np.int32)
    kw = dict(rope_theta=jcfg.rope_theta, window=12, softcap_value=20.0, q_block=16)

    def jloss(layer, xx):
        return jnp.sum(jattn.attend_full(layer, xx, jnp.asarray(pos), **kw) * w)

    jg_layer, jg_x = jax.grad(jloss, argnums=(0, 1))(jlayer, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tlayer.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = tattn.attend_full(leaves, tx, torch.from_numpy(pos).long(), **kw)
    torch.sum(out * torch.from_numpy(w)).backward()
    _rel_close(tx.grad.numpy(), np.asarray(jg_x), 1e-5, "x")
    for k, v in leaves.items():
        _rel_close(v.grad.numpy(), np.asarray(jg_layer[k]), 1e-5, k)


# -- K4 under autograd ----------------------------------------------------------------------


def _scan_inputs(seed, b=2, s=48, h=4, p=32, g=1, n=16):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    xs, bm, cm = mk(b, s, h, p), mk(b, s, g, n), mk(b, s, g, n)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32))
    a = -torch.from_numpy(rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32))
    return [t.requires_grad_() for t in (xs, bm, cm, dt, a)]


@pytest.mark.parametrize("use_state", [True, False])
def test_scan_function_gives_ssd_chunked_gradients(use_state):
    inputs = _scan_inputs(10)
    rng = np.random.default_rng(11)
    wy = torch.from_numpy(rng.normal(size=inputs[0].shape).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(2, 4, 32, 16)).astype(np.float32))

    def loss(y, state):
        return (y * wy).sum() + ((state * ws).sum() if use_state else 0.0)

    y, state = tssm.ssd(*inputs, chunk=16)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad(loss(y, state), inputs)
    y2, state2 = tssm.ssd_chunked(*inputs, chunk=16)
    want = torch.autograd.grad(loss(y2, state2), inputs)
    np.testing.assert_array_equal(y.detach().numpy(), y2.detach().numpy())
    for name, g, w in zip(("x", "B", "C", "dt", "a"), got, want):
        assert g is not None and float(g.abs().max()) > 0, name
        _rel_close(g.numpy(), w.numpy(), 1e-6, name)


def test_ssm_block_gradients_reach_every_leaf_through_the_scan_function(monkeypatch):
    _, tcfg, _, tparams = _smoke("mamba2-2.7b")
    applied = []
    real = tssm.SSDScan.apply
    monkeypatch.setattr(tssm.SSDScan, "apply",
                        lambda *a: applied.append(1) or real(*a))
    grads, _, _ = _grads(TransformerLM(tcfg), tparams)
    assert len(applied) == tcfg.n_layers
    for key, g in grads.items():
        assert float(g.abs().max()) > 0, key


def test_kernel_launcher_refuses_inputs_that_require_grad():
    """The launcher's outputs come from the kernel over raw pointers, outside
    autograd: with grad enabled, an input that requires grad raises rather
    than returning outputs cut from the graph."""
    xs, bm, cm, dt, a = _scan_inputs(12)
    with pytest.raises(RuntimeError, match="carry no gradient"):
        ssd_scan_cuda(xs, dt, bm[:, :, 0], cm[:, :, 0], a, chunk=16)
    with torch.no_grad(), pytest.raises(InvariantViolation, match="CUDA"):
        ssd_scan_cuda(xs, dt, bm[:, :, 0], cm[:, :, 0], a, chunk=16)
    y, state = ops.ssd_scan(xs, dt, bm[:, :, 0], cm[:, :, 0], a, chunk=16)  # CPU: plain
    assert y.requires_grad and state.requires_grad


# -- the straggler governor -----------------------------------------------------------------


def _same(port, ref):
    assert [dataclasses.astuple(h) for h in port] == [dataclasses.astuple(h) for h in ref]


def test_straggler_governor_demotes_and_recovers():
    gov, ref = StragglerGovernor(n_hosts=4, patience=1), JaxGovernor(n_hosts=4, patience=1)
    for _ in range(3):
        out = gov.window([1.0, 1.0, 1.0, 5.0])
        _same(out, ref.window([1.0, 1.0, 1.0, 5.0]))
    assert isinstance(out[3], HostHealth)
    assert not out[3].healthy and out[3].rate_factor < 1.0
    assert all(h.healthy for h in out[:3])
    for _ in range(6):
        out = gov.window([1.0, 1.0, 1.0, 1.0])
        _same(out, ref.window([1.0, 1.0, 1.0, 1.0]))
    assert out[3].rate_factor == 1.0


def test_straggler_governor_matches_reference_on_random_windows():
    rng = np.random.default_rng(13)
    gov, ref = StragglerGovernor(n_hosts=5), JaxGovernor(n_hosts=5)
    for _ in range(60):
        times = rng.choice([0.0, 1.0, 1.2, 2.0, 6.0], size=5, p=[0.05, 0.5, 0.2, 0.15, 0.1])
        _same(gov.window(times.tolist()), ref.window(times.tolist()))
    with pytest.raises(InvariantViolation, match="host-count"):
        gov.window([1.0])


def test_step_timing_substrate_drives_straggler_governor():
    sub = StepTimingSubstrate(n_hosts=4)
    loop = ControlLoop(sub, StragglerGovernor(n_hosts=4, patience=1), window_ns=1.0)
    ref_sub = JaxStepTiming(n_hosts=4)
    ref_loop = JaxControlLoop(ref_sub, JaxGovernor(n_hosts=4, patience=1), window_ns=1.0)
    for _ in range(3):
        for h, t in enumerate([1.0, 1.0, 1.0, 5.0]):
            sub.record_step(h, t)
            ref_sub.record_step(h, t)
        loop.fire()
        ref_loop.fire()
    assert sub.rate_factor(3) < 1.0
    assert all(sub.rate_factor(h) == 1.0 for h in range(3))
    assert loop.windows_run == 3
    assert sub.clock_ns == ref_sub.clock_ns
    _same(sub.health, ref_sub.health)


def test_control_loop_caps_its_history():
    sub = StepTimingSubstrate(n_hosts=1)
    loop = ControlLoop(sub, StragglerGovernor(n_hosts=1), window_ns=1.0, max_history=4)
    for _ in range(20):
        sub.record_step(0, 0.1)
        loop.fire()
    assert loop.windows_run == 20 and len(loop.decisions) <= 8


# -- the Trainer ----------------------------------------------------------------------------


def test_train_loss_decreases():
    """Port of tests/test_system.py::test_train_loss_decreases on the CPU."""
    t = Trainer("h2o-danube-1.8b", smoke=True, global_batch=4, seq_len=64, total_steps=6,
                device="cpu")
    state = t.init_or_resume(False)
    losses = []
    for _ in range(6):
        tokens, labels = next(t.loader)
        state, m = t.step_fn(state, torch.from_numpy(tokens), torch.from_numpy(labels))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert not any(np.isnan(losses))


def test_trainer_runs_its_loop_and_governor(capsys):
    t = Trainer("qwen2.5-3b", smoke=True, global_batch=2, seq_len=16, total_steps=3,
                device="cpu")
    state = t.train(3, log_every=1)
    assert int(state.opt.step) == 3
    assert [h["step"] for h in t.history] == [0, 1, 2]
    assert all(h["seconds"] > 0 and np.isfinite(h["loss"]) for h in t.history)
    assert t.straggler_loop.windows_run == 3 and t.step_substrate.rate_factor(0) == 1.0
    assert capsys.readouterr().out.count("[train] step=") == 3
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt.master["embed"].dtype == torch.float32
    assert not any(p.requires_grad for p in tree_leaves(state.params))


def test_unstacked_layers_are_views_of_the_stacked_leaves():
    """llama4's dense/MoE pairs: flat layer 2p + j is sublayer j of pair p,
    each leaf a view of its stacked leaf's row p."""
    cfg = port_arch("llama4-maverick-400b-a17b").smoke
    params = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    layers = ttransformer._decoder_layers(cfg, params["layers"])
    assert len(layers) == cfg.n_layers
    for i, layer in enumerate(layers):
        stack = params["layers"]["moe" if i % 2 else "dense"]
        want = flatten_with_paths(stack)
        got = flatten_with_paths(layer)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            assert a.data_ptr() == b[i // 2].data_ptr() and a.shape == b.shape[1:], k
