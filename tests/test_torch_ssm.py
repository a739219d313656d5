"""Port parity: the Mamba2 SSD scan, the SSM block and the mamba2 model and
serving path (repro_torch) against the reference (repro) on the CPU.

Inputs are made with numpy from a seed and handed to both.  The scan's plain
versions are held to the reference's Pallas kernel run in interpret mode and
to its token recurrence at tests/test_kernels.py's tolerances (1e-4 in f32,
5e-2 in bf16); the SSM block at tests/test_ssm.py's bounds; the model at
tests/test_models.py's (2e-3 prefill, 3e-3 decode logits, f32); serving
identical in greedy streams, result dict and MIKU decisions.  The CUDA kernel
itself runs only on the card (chip_smoke.py holds it against these plain
versions there); on the CPU the wrapper takes the plain path."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.kernels.ops import ssd_scan as pallas_ssd_scan
from repro.kernels.ref import ssd_scan_ref as jax_scan_ref
from repro.models import ssm as jssm
from repro.models.transformer import DecodeState as JaxDecodeState
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import engine as jeng
from repro_torch.configs import get_arch as port_arch
from repro_torch.core.controller import MikuConfig, MikuController
from repro_torch.core.invariants import InvariantViolation
from repro_torch.core.littles_law import EstimatorConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as kernel_mod
from repro_torch.kernels.ref import ssd_scan_chunked_ref, ssd_scan_ref
from repro_torch.launch import serve as port_serve
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving import engine as teng

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

SWEEP = [  # b, s, h, p, n, chunk (tests/test_kernels.py::test_ssd_scan_sweep)
    (1, 64, 2, 32, 16, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 128, 64),  # mamba2-class state
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, 5e-2)}
PREFILL_TOL = dict(atol=2e-3, rtol=2e-3)
DECODE_TOL = dict(atol=3e-3, rtol=3e-3)

JCFG = dataclasses.replace(get_arch("mamba2-2.7b").smoke, dtype=jnp.float32)
TCFG = dataclasses.replace(port_arch("mamba2-2.7b").smoke, dtype=torch.float32)
JMODEL = JaxLM(JCFG)
JPARAMS, _ = JMODEL.init(jax.random.PRNGKey(0))
TMODEL = TransformerLM(TCFG)
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), TCFG, "cpu")


def _scan_inputs(seed, b, s, h, p, n, np_dtype=np.float32):
    """Model-layout scan inputs in the distribution of the reference's
    kernel tests; x, B and C rounded to the working dtype once in numpy."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((b, s, h, p)) * 0.5).astype(np_dtype)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    bm = (r.standard_normal((b, s, n)) * 0.3).astype(np_dtype)
    cm = (r.standard_normal((b, s, n)) * 0.3).astype(np_dtype)
    a = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    return x, dt, bm, cm, a


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a).astype(np.float32), dtype)


def _port_scan(x, dt, bm, cm, a, t_dt, chunk):
    y, state = ops.ssd_scan(_t(x, t_dt), _t(dt), _t(bm, t_dt), _t(cm, t_dt), _t(a),
                            chunk=chunk)
    return y.float().numpy(), state.numpy()


def _jax_recurrence(x, dt, bm, cm, a):
    """The reference's token recurrence, in model layout, f32."""
    y = jax_scan_ref(jnp.moveaxis(_j(x), 2, 1), jnp.moveaxis(_j(dt), 2, 1),
                     jnp.stack([_j(bm), _j(cm)], 2), _j(a))
    return np.asarray(jnp.moveaxis(y, 1, 2))


def _jax_chunked(x, dt, bm, cm, a, chunk):
    """The reference model's scan (f32): (y, final state)."""
    y, final = jssm.ssd_chunked(_j(x), _j(bm)[:, :, None], _j(cm)[:, :, None], _j(dt),
                                _j(a), chunk=chunk)
    return np.asarray(y), np.asarray(final)


# -- the scan: plain versions against the reference -----------------------------


@pytest.mark.parametrize("oracle", ["pallas", "recurrence"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_ssd_scan_sweep(oracle, dtype, b, s, h, p, n, chunk):
    """ops.ssd_scan on CPU tensors (the kernel's plain version) against the
    reference's Pallas kernel in interpret mode, and against its token
    recurrence."""
    np_dt, jnp_dt, t_dt, tol = DTYPES[dtype]
    x, dt, bm, cm, a = _scan_inputs(2, b, s, h, p, n, np_dt)
    y, _ = _port_scan(x, dt, bm, cm, a, t_dt, chunk)
    if oracle == "pallas":
        want = np.asarray(pallas_ssd_scan(_j(x, jnp_dt), _j(dt), _j(bm), _j(cm), _j(a),
                                          chunk=chunk).astype(jnp.float32))
    else:
        want = _jax_recurrence(x, dt, bm, cm, a)
    np.testing.assert_allclose(y, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_versions_in_kernel_layout_match_reference_recurrence(dtype):
    """The port's token recurrence and chunked plain version, kernel layout,
    against the reference's ssd_scan_ref; both final states agree."""
    np_dt, _, t_dt, tol = DTYPES[dtype]
    x, dt, bm, cm, a = _scan_inputs(5, 2, 96, 3, 32, 16, np_dt)
    xk = _t(x, t_dt).transpose(1, 2)
    dtk = _t(dt).transpose(1, 2)
    bc = torch.stack([_t(bm, t_dt), _t(cm, t_dt)], dim=2)
    want = _jax_recurrence(x, dt, bm, cm, a)
    y_rec, h_rec = ssd_scan_ref(xk, dtk, bc, _t(a))
    y_chk, h_chk = ssd_scan_chunked_ref(xk, dtk, bc, _t(a), chunk=32)
    assert y_rec.dtype == y_chk.dtype == t_dt
    for y in (y_rec, y_chk):
        np.testing.assert_allclose(y.transpose(1, 2).float().numpy(), want, atol=tol,
                                   rtol=tol)
    np.testing.assert_allclose(h_chk.numpy(), h_rec.numpy(), atol=1e-4, rtol=1e-4)


def test_ssd_scan_state_carries_across_chunks():
    """Same sequence, chunk 32 against chunk 128: the same y and final
    state, and the final state is the reference ssd_chunked's."""
    x, dt, bm, cm, a = _scan_inputs(3, 1, 128, 2, 32, 16)
    y32, h32 = _port_scan(x, dt, bm, cm, a, torch.float32, 32)
    y128, h128 = _port_scan(x, dt, bm, cm, a, torch.float32, 128)
    np.testing.assert_allclose(y32, y128, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h32, h128, atol=1e-4, rtol=1e-4)
    _, want = _jax_chunked(x, dt, bm, cm, a, 32)
    np.testing.assert_allclose(h32, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s,chunk", [(40, 16), (200, 128), (7, 128), (1, 16)])
def test_ssd_scan_pads_a_ragged_last_chunk(s, chunk):
    """S not a chunk multiple (and S below the chunk): y and the final
    state equal the reference's padded ssd_chunked and the token
    recurrence's, whose state sees no padding at all."""
    x, dt, bm, cm, a = _scan_inputs(4, 2, s, 3, 32, 16)
    y, h = _port_scan(x, dt, bm, cm, a, torch.float32, chunk)
    assert y.shape == (2, s, 3, 32) and h.shape == (2, 3, 32, 16)
    want_y, want_h = _jax_chunked(x, dt, bm, cm, a, chunk)
    np.testing.assert_allclose(y, want_y, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h, want_h, atol=1e-4, rtol=1e-4)
    _, h_rec = ssd_scan_ref(_t(x).transpose(1, 2), _t(dt).transpose(1, 2),
                            torch.stack([_t(bm), _t(cm)], dim=2), _t(a))
    np.testing.assert_allclose(h, h_rec.numpy(), atol=1e-4, rtol=1e-4)


def test_ssd_scan_wrapper_contract():
    """No initial state; a CPU tensor never reaches the launcher; the
    launcher refuses CPU tensors and shapes it is not sized for."""
    x, dt, bm, cm, a = (_t(v) for v in _scan_inputs(6, 1, 16, 2, 32, 16))
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.ssd_scan(x, dt, bm, cm, a, chunk=16, initial_state=torch.zeros(1, 2, 32, 16))
    before = kernel_mod.LAUNCHES.count
    ops.ssd_scan(x, dt, bm, cm, a, chunk=16)
    assert kernel_mod.LAUNCHES.count == before
    with pytest.raises(InvariantViolation, match="CUDA"):
        kernel_mod.ssd_scan_cuda(x, dt, bm, cm, a, chunk=16)


# -- the SSM block against repro.models.ssm ----------------------------------------


def _jax_ssm_params(d, dims, seed):
    params, _ = jssm.ssm_init(jax.random.PRNGKey(seed), d, dims, jnp.float32)
    tparams = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in params.items()}
    return params, tparams


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_reference(g):
    """The model's plain scan, G = 1 and a G = 2 head repeat, y and final
    state (tests/test_ssm.py's bounds)."""
    b, s, h, p, n = 2, 64, 4, 16, 8
    r = np.random.default_rng(7)
    xs = (r.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    bm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    y, final = tssm.ssd_chunked(*map(_t, (xs, bm, cm, dt, a)), chunk=16)
    jy, jfinal = jssm.ssd_chunked(*map(_j, (xs, bm, cm, dt, a)), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=1e-4, rtol=1e-3)


def test_ssm_forward_and_step_match_reference():
    """ssm_forward on a sequence and ssm_step token by token, from the
    reference's weights, against the reference's; the steps equal the
    forward (tests/test_ssm.py::test_ssm_decode_matches_forward)."""
    d = 64
    dims = tssm.ssm_dims(d, expand=2, head_dim=16, d_state=8, n_groups=1)
    assert dims == jssm.ssm_dims(d, expand=2, head_dim=16, d_state=8, n_groups=1)
    jparams, tparams = _jax_ssm_params(d, dims, 0)
    x = (np.random.default_rng(8).standard_normal((1, 12, d)) * 0.3).astype(np.float32)
    full = tssm.ssm_forward(tparams, _t(x), dims, chunk=4)
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jssm.ssm_forward(jparams, _j(x), dims, chunk=4)),
                               atol=2e-3, rtol=2e-3)
    tstate = tssm.init_ssm_state(1, dims, torch.float32)
    jstate = jssm.init_ssm_state(1, dims, jnp.float32)
    outs = []
    for t in range(12):
        y, tstate = tssm.ssm_step(tparams, _t(x[:, t:t + 1]), tstate, dims)
        jy, jstate = jssm.ssm_step(jparams, _j(x[:, t:t + 1]), jstate, dims)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-3, rtol=2e-3)
        outs.append(y)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), atol=1e-4)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), atol=2e-3,
                               rtol=2e-3)


def test_causal_conv_matches_reference():
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 11, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32)
    got = tssm._causal_depthwise_conv(_t(x), _t(w), _t(bias))
    want = jssm._causal_depthwise_conv(_j(x), _j(w), _j(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- the mamba2 model ----------------------------------------------------------------


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(1, JCFG.vocab, (b, s)).astype(np.int32)


def test_port_config_copies_reference():
    for jc, tc in ((get_arch("mamba2-2.7b").config, port_arch("mamba2-2.7b").config),
                   (get_arch("mamba2-2.7b").smoke, port_arch("mamba2-2.7b").smoke)):
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.ssm_dims == jc.ssm_dims
        assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16


def test_param_tree_and_bytes_match_reference():
    cfg = port_arch("mamba2-2.7b").smoke
    tp = TransformerLM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jp, _ = JaxLM(get_arch("mamba2-2.7b").smoke).init(jax.random.PRNGKey(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jp))
    assert teng.param_bytes(tp) == sum(x.nbytes for x in jax.tree.leaves(jp))
    for k in ("A_log", "D", "dt_bias"):
        assert tp["layers"]["ssm"][k].dtype == torch.float32
        np.testing.assert_allclose(tp["layers"]["ssm"][k].numpy(),
                                   np.asarray(jp["layers"]["ssm"][k]), rtol=1e-6)


def test_weights_bridge_keeps_ssm_leaves_f32_in_a_bf16_config():
    tree = jax.tree.map(np.asarray, JPARAMS)
    bf16 = params_from_numpy(tree, dataclasses.replace(TCFG, dtype=torch.bfloat16), "cpu")
    ssm = bf16["layers"]["ssm"]
    assert ssm["in_proj"].dtype == bf16["embed"].dtype == torch.bfloat16
    for k in ("A_log", "D", "dt_bias"):
        assert ssm[k].dtype == torch.float32
        np.testing.assert_array_equal(ssm[k].numpy(), tree["layers"]["ssm"][k])


@pytest.mark.parametrize("s", [12, 40])
def test_forward_and_prefill_match_reference(s):
    """Prefill logits (2e-3) and the state it leaves: the final scan state
    and the pre-conv rows.  40 tokens at chunk 16 make three chunks, the
    last one padded."""
    toks = _tokens(s, 2, s)
    hidden, _ = JMODEL.forward(JPARAMS, jnp.asarray(toks))
    want = np.asarray(JMODEL.logits(JPARAMS, hidden))
    got = TMODEL.logits(TPARAMS, TMODEL.forward(TPARAMS, torch.from_numpy(toks)))
    np.testing.assert_allclose(got.numpy(), want, **PREFILL_TOL)
    jl, jst = JMODEL.prefill(JPARAMS, jnp.asarray(toks), JMODEL.init_decode_state(2, 64))
    tst = TMODEL.init_decode_state(2, 64, "cpu")
    assert tst.kv is None
    tl, tst = TMODEL.prefill(TPARAMS, torch.from_numpy(toks), tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PREFILL_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst.ssm[k].numpy(), np.asarray(jst.ssm[k]), atol=1e-4)
    assert tst.length.tolist() == [s, s]


def test_decode_steps_match_reference_with_per_slot_states():
    """Prompts of 5 and 9 tokens prefilled one at a time and inserted into a
    shared state, then decoded together (3e-3)."""
    b = 2
    jst = JMODEL.init_decode_state(b, 32)
    tst = TMODEL.init_decode_state(b, 32, "cpu")
    jssm_state = {k: np.asarray(v).copy() for k, v in jst.ssm.items()}
    for slot, plen in enumerate((5, 9)):
        toks = _tokens(10 + slot, 1, plen)
        _, j1 = JMODEL.prefill(JPARAMS, jnp.asarray(toks), JMODEL.init_decode_state(1, 32))
        _, t1 = TMODEL.prefill(TPARAMS, torch.from_numpy(toks),
                               TMODEL.init_decode_state(1, 32, "cpu"))
        for k in ("h", "conv"):
            jssm_state[k][:, slot] = np.asarray(j1.ssm[k])[:, 0]
            tst.ssm[k][:, slot] = t1.ssm[k][:, 0]
    lengths = [5, 9]
    jst = JaxDecodeState(kv=None, ssm={k: jnp.asarray(v) for k, v in jssm_state.items()},
                         cross_kv=None, length=jnp.asarray(lengths, jnp.int32))
    tst.length = torch.tensor(lengths, dtype=torch.int32)
    tok = _tokens(20, 1, b)[0]
    for _ in range(4):
        jl, jst = JMODEL.decode_step(JPARAMS, jst, jnp.asarray(tok))
        tl, tst = TMODEL.decode_step(TPARAMS, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst.ssm[k].numpy(), np.asarray(jst.ssm[k]), atol=1e-4)
    assert tst.length.tolist() == [9, 13]


def test_decode_step_matches_forward():
    """prefill(t) + decode(token_t) == forward(t+1 tokens) last logits."""
    toks = _tokens(40, 1, 9)
    st = TMODEL.init_decode_state(1, 32, "cpu")
    _, st = TMODEL.prefill(TPARAMS, torch.from_numpy(toks[:, :-1]), st)
    dec, _ = TMODEL.decode_step(TPARAMS, st, torch.from_numpy(toks[:, -1]))
    full = TMODEL.logits(TPARAMS, TMODEL.forward(TPARAMS, torch.from_numpy(toks)))[:, -1]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_TOL)


# -- serving --------------------------------------------------------------------------


def _engine(name, placement, n_req, *, port, max_new=6):
    mod = teng if port else jeng
    cfg, params = (TCFG, TPARAMS) if port else (JCFG, JPARAMS)
    e = mod.ServingEngine(mod.EngineConfig(name=name, model=cfg, max_slots=2, max_len=64,
                                           placement=placement, stream_chunks=64), params)
    for i in range(n_req):
        e.submit(mod.Request(rid=i, prompt=[1 + i, 2, 3, 4, 5], max_new_tokens=max_new))
    return e


def _miku(port, param_bytes):
    chunk_service = param_bytes / 64 / 16.0
    if port:
        return MikuController(MikuConfig(levels=(1, 2, 4, 8)),
                              EstimatorConfig(t_fast=1.2e3,
                                              slow_read_threshold=8 * chunk_service,
                                              min_window_inserts=4, min_slow_inserts=1))
    from repro.core.controller import MikuConfig as JMikuConfig
    from repro.core.controller import MikuController as JMikuController
    from repro.core.littles_law import EstimatorConfig as JEstimatorConfig

    return JMikuController(JMikuConfig(levels=(1, 2, 4, 8)),
                           JEstimatorConfig(t_fast=1.2e3,
                                            slow_read_threshold=8 * chunk_service,
                                            min_window_inserts=4, min_slow_inserts=1))


@pytest.mark.parametrize("engines", [("device",), ("device", "host")])
def test_cluster_result_and_greedy_streams_match_reference(engines):
    """f32 mamba2 smoke engines, racing: identical run() dicts and greedy
    token streams per request; no KV bytes are charged."""
    res, streams = {}, {}
    for port in (False, True):
        mod = teng if port else jeng
        engs = [_engine(f"{p}{i}", p, 3 + 2 * i, port=port)
                for i, p in enumerate(engines)]
        assert all(e.kv_bytes_per_token == 0 for e in engs)
        res[port] = mod.TieredServingCluster(engs).run(8000)
        streams[port] = {e.cfg.name: sorted((r.rid, list(r.output)) for r in e.done)
                         for e in engs}
    assert res[True] == res[False]
    assert streams[True] == streams[False]


def test_miku_decision_sequence_matches_reference():
    out = {}
    for port in (False, True):
        probe_bytes = _engine("p", "host", 0, port=port).param_bytes
        ctl = _miku(port, probe_bytes)
        mod = teng if port else jeng
        cl = mod.TieredServingCluster(
            [_engine("d", "device", 8, port=port), _engine("h", "host", 4, port=port)],
            controller=ctl, window_ns=3e4)
        res = cl.run(20000)
        seq = [(d.restricted, d.max_concurrency, d.rate_factor) for d in ctl.decisions]
        out[port] = (res, seq, probe_bytes)
    assert out[True][2] == out[False][2]
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert len(out[True][1]) > 0


def test_build_cluster_serves_mamba2_on_cpu(capsys):
    cl = port_serve.build_cluster("mamba2-2.7b", n_requests=3, max_new=4, mode="miku",
                                  device="cpu")
    assert [e.cfg.placement for e in cl.engines] == ["device", "host"]
    assert cl.engines[0].state.kv is None and cl.engines[0].kv_bytes_per_token == 0
    res = cl.run(20000)
    assert res["hbm"]["requests"] == 3 and res["host"]["requests"] == 1
    for e in cl.engines:
        for r in e.done:
            assert len(r.output) == 4 and all(0 <= t < 512 for t in r.output)
    port_serve.main(["--arch", "mamba2-2.7b", "--device", "cpu", "--requests", "2",
                     "--mode", "racing"])
    assert "simulated tok/s" in capsys.readouterr().out
