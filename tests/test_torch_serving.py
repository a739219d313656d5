"""Port parity: serving engine, tiered cluster, samplers, transfer queue and
the MIKU control plane (repro_torch) against the reference (repro), on the
llama31 smoke config on the CPU.

Greedy token streams, the cluster's result dict and the MIKU decision
sequence must be identical (the simulated clock is exact arithmetic over
bytes and tier constants, and f32 greedy decoding agrees token for token)."""

import dataclasses
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core.controller import MikuConfig as JMikuConfig
from repro.core.controller import MikuController as JMikuController
from repro.core.littles_law import EstimatorConfig as JEstimatorConfig
from repro.core.littles_law import OpClass as JOpClass
from repro.core.littles_law import TierCounters as JTierCounters
from repro.core.littles_law import TierWindow as JTierWindow
from repro.models.transformer import TransformerLM as JaxLM
from repro.serving import engine as jeng
from repro.serving import sampler as jsampler
from repro_torch.configs import get_arch as port_arch
from repro_torch.core.controller import Decision, MikuConfig, MikuController, Phase
from repro_torch.core.littles_law import EstimatorConfig, OpClass, TierCounters, TierWindow
from repro_torch.core.offload import HostOffloader, TransferQueue, UnknownTierError
from repro_torch.core.substrate import WindowedCounters
from repro_torch.launch import serve as port_serve
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving import engine as teng
from repro_torch.serving import sampler as tsampler

# Tiny shapes: one intra-op thread is fastest and keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

JCFG = get_arch("llama31-8b").smoke
TCFG = port_arch("llama31-8b").smoke
JPARAMS, _ = JaxLM(JCFG).init(jax.random.PRNGKey(0))
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), TCFG, "cpu")

JCFG32 = dataclasses.replace(JCFG, dtype=jnp.float32)
TCFG32 = dataclasses.replace(TCFG, dtype=torch.float32)
JPARAMS32 = jax.tree.map(lambda x: x.astype(jnp.float32), JPARAMS)
TPARAMS32 = params_from_numpy(jax.tree.map(np.asarray, JPARAMS32), TCFG32, "cpu")


def mk(name, placement, n_req, max_new=8, *, port=True, f32=False, kv_pagemap=None):
    mod = teng if port else jeng
    if port:
        cfg, params = (TCFG32, TPARAMS32) if f32 else (TCFG, TPARAMS)
    else:
        cfg, params = (JCFG32, JPARAMS32) if f32 else (JCFG, JPARAMS)
    e = mod.ServingEngine(
        mod.EngineConfig(name=name, model=cfg, max_slots=2, max_len=64,
                         placement=placement, stream_chunks=64),
        params, kv_pagemap=kv_pagemap,
    )
    for i in range(n_req):
        e.submit(mod.Request(rid=i, prompt=[1, 2, 3, 4], max_new_tokens=max_new))
    return e


def _miku(port, param_bytes):
    chunk_service = param_bytes / 64 / 16.0
    if port:
        return MikuController(MikuConfig(levels=(1, 2, 4, 8)),
                              EstimatorConfig(t_fast=1.2e3,
                                              slow_read_threshold=8 * chunk_service,
                                              min_window_inserts=4, min_slow_inserts=1))
    return JMikuController(JMikuConfig(levels=(1, 2, 4, 8)),
                           JEstimatorConfig(t_fast=1.2e3,
                                            slow_read_threshold=8 * chunk_service,
                                            min_window_inserts=4, min_slow_inserts=1))


# -- the port's versions of tests/test_serving.py's tier-1 tests -------------


def test_engine_completes_all_requests():
    res = teng.TieredServingCluster([mk("a", "device", 5)]).run(2000)
    assert res["a"]["requests"] == 5
    assert res["a"]["tokens"] == 5 * 8


def test_continuous_batching_more_requests_than_slots():
    eng = mk("a", "device", 7)
    teng.TieredServingCluster([eng]).run(4000)
    assert len(eng.done) == 7
    assert all(len(r.output) == 8 for r in eng.done)


def test_host_instance_slower_than_device():
    a = teng.TieredServingCluster([mk("d", "device", 4)]).run(4000)
    b = teng.TieredServingCluster([mk("h", "host", 4)]).run(8000)
    assert a["d"]["tokens_per_s"] > 3 * b["h"]["tokens_per_s"]


def test_miku_restricts_under_racing():
    probe = mk("p", "host", 0)
    ctl = _miku(True, probe.param_bytes)
    cl = teng.TieredServingCluster([mk("d", "device", 12), mk("h", "host", 6)],
                                   controller=ctl, window_ns=3e4)
    cl.run(20000)
    assert any(d.restricted for d in ctl.decisions)


# -- identical to the reference ------------------------------------------------


def test_miku_decision_sequence_matches_reference():
    """The test_miku_restricts_under_racing setup on both sides: the same
    result dict and the same (restricted, max concurrency, rate) per window."""
    out = {}
    for port in (False, True):
        probe_bytes = mk("p", "host", 0, port=port).param_bytes
        ctl = _miku(port, probe_bytes)
        mod = teng if port else jeng
        cl = mod.TieredServingCluster(
            [mk("d", "device", 12, port=port), mk("h", "host", 6, port=port)],
            controller=ctl, window_ns=3e4)
        res = cl.run(20000)
        seq = [(d.restricted, d.max_concurrency, d.rate_factor) for d in ctl.decisions]
        out[port] = (res, seq, probe_bytes)
    assert out[True][2] == out[False][2]
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert sum(r for r, _, _ in out[True][1]) > 0


@pytest.mark.parametrize("engines", [("device",), ("host",), ("device", "host")])
def test_cluster_result_and_greedy_streams_match_reference(engines):
    """f32 engines, racing (no controller): identical run() dicts and
    identical greedy token streams per request."""
    res, streams = {}, {}
    for port in (False, True):
        mod = teng if port else jeng
        engs = [mk(f"{p}{i}", p, 3 + 2 * i, max_new=6, port=port, f32=True)
                for i, p in enumerate(engines)]
        res[port] = mod.TieredServingCluster(engs).run(8000)
        streams[port] = {e.cfg.name: sorted((r.rid, list(r.output)) for r in e.done)
                         for e in engs}
    assert res[True] == res[False]
    assert streams[True] == streams[False]


def test_engine_matches_sequential_greedy_loop():
    """Continuous-batched greedy decode equals a batch-1 prefill + decode loop
    (the port's version of the reference's end-to-end serving check)."""
    model = TransformerLM(TCFG32)
    prompt, n_new = [5, 6, 7], 6
    st = model.init_decode_state(1, 64, "cpu")
    logits, st = model.prefill(TPARAMS32, torch.tensor([prompt]), st)
    ref = [int(logits[0].argmax())]
    for _ in range(n_new - 1):
        logits, st = model.decode_step(TPARAMS32, st, torch.tensor([ref[-1]]))
        ref.append(int(logits[0].argmax()))
    eng = teng.ServingEngine(teng.EngineConfig(name="e", model=TCFG32, max_slots=2,
                                               max_len=64), TPARAMS32)
    for i in range(3):
        eng.submit(teng.Request(rid=i, prompt=list(prompt), max_new_tokens=n_new))
    teng.TieredServingCluster([eng]).run(2000)
    assert [r.output for r in eng.done] == [ref] * 3


def test_idle_ticks_fast_path_is_exact():
    """idle_advance(dt, until, n) leaves the queue exactly where n
    advance(dt) calls would (clock, completions, windows, decisions)."""
    def setup():
        q = TransferQueue(controller=_miku(True, 1 << 20), window_ns=3e4)
        q.account_fast(1 << 20, 2e4, OpClass.LOAD)
        q.submit_slow_stream(1 << 20, 16)
        return q

    a, b = setup(), setup()
    until = a.now + 50_000.5
    steps = a.idle_advance(1e3, until, 10**6)
    n = 0
    while b.now < until:
        b.advance(1e3)
        n += 1
    assert steps == n and a.now == b.now
    assert a.counters["slow"] == b.counters["slow"]
    assert [(d.restricted, d.max_concurrency) for d in a.decisions] == \
        [(d.restricted, d.max_concurrency) for d in b.decisions]
    assert a.idle_advance(1e3, math.inf, 7) == 7


# -- samplers ------------------------------------------------------------------


def test_greedy_matches_reference_exactly():
    r = np.random.default_rng(0)
    logits = r.standard_normal((16, 512)).astype(np.float32)
    logits[3, [7, 9]] = 50.0  # a tie: both take the first maximum
    got = tsampler.greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(jsampler.greedy(jnp.asarray(logits))).tolist()


def test_temperature_and_top_k_sample_the_reference_distribution():
    """Different generators, same law: empirical frequencies of 20k draws
    within 0.015 of softmax(logits / temp); top-k never leaves the top k."""
    logits = torch.tensor([2.0, 1.0, 0.5, -1.0, 0.0])
    n = 20_000
    g = torch.Generator().manual_seed(0)
    draws = tsampler.temperature(logits.expand(n, 5), g, temp=0.8)
    freq = torch.bincount(draws.long(), minlength=5).float() / n
    want = np.asarray(jax.nn.softmax(jnp.asarray(logits.numpy()) / 0.8))
    np.testing.assert_allclose(freq.numpy(), want, atol=0.015)
    topk = tsampler.temperature(logits.expand(n, 5), g, temp=0.8, top_k=2)
    assert set(topk.tolist()) == {0, 1}


# -- transfer queue, offloader, control plane ----------------------------------


def test_transfer_queue_stream_duration_is_bandwidth_bound():
    q = TransferQueue()
    total = 16 << 20
    assert q.submit_slow_stream(total, 64) == pytest.approx(
        total / q.slow.bandwidth_gbps, rel=0.05)


def test_cap_bounds_backlog_without_slowing_stream():
    q1 = TransferQueue()
    d1 = q1.submit_slow_stream(16 << 20, 64)
    q2 = TransferQueue()
    q2.apply(Decision(max_concurrency=4, rate_factor=1.0, phase=Phase.RESTRICTED))
    d2 = q2.submit_slow_stream(16 << 20, 64)
    assert q2.slow_backlog() == 0 and q1.slow_backlog() > 32
    assert d2 == pytest.approx(d1, rel=0.01)
    assert q1.fast_penalty() > 1.2 and q2.fast_penalty() == 1.0


def test_unknown_transfer_link_is_a_loud_error():
    q = TransferQueue()
    with pytest.raises(UnknownTierError, match="slow"):
        q.decision_for("warp_drive")
    with pytest.raises(UnknownTierError):
        q.submit_slow_stream(1 << 20, 4, tier="warp_drive")
    assert q.decision_for("slow") is q.decision


def test_offloader_roundtrip_on_cpu():
    off = HostOffloader(torch.device("cpu"))
    tree = {"a": torch.arange(64, dtype=torch.float32),
            "b": {"c": torch.ones(8, 8, dtype=torch.bfloat16)}}
    host = off.to_host(tree)
    staging = off.to_device(host)
    off.to_device(host, out=staging)
    off.block()
    assert torch.equal(staging["a"], tree["a"]) and torch.equal(staging["b"]["c"],
                                                                tree["b"]["c"])
    assert off.bytes_to_device == 2 * (64 * 4 + 64 * 2)
    assert not off.supported and off.copy_seconds() == 0.0


def _random_window(rng, port):
    counters, names = [], ("fast", "slow")
    for _ in names:
        tc = (TierCounters if port else JTierCounters)()
        for _ in range(rng.randrange(0, 12)):
            op = rng.choice(list(OpClass if port else JOpClass))
            tc.record(op, rng.uniform(50, 5e4))
        counters.append(tc)
    return (TierWindow if port else JTierWindow)(counters, names)


def test_miku_controller_copy_matches_reference_on_random_windows():
    decisions = {}
    for port in (False, True):
        rng = random.Random(7)
        ctl = (MikuController if port else JMikuController)(
            (MikuConfig if port else JMikuConfig)(),
            (EstimatorConfig if port else JEstimatorConfig)(
                t_fast=300.0, slow_read_threshold=8e3, min_window_inserts=4,
                min_slow_inserts=1))
        seq = []
        for _ in range(300):
            d = ctl.window(_random_window(rng, port))
            est = d.estimate
            seq.append((d.restricted, d.max_concurrency, d.rate_factor,
                        est.t_slow, est.valid))
        decisions[port] = seq
    assert decisions[True] == decisions[False]
    assert any(s[0] for s in decisions[True])


def test_windowed_counters_consume_on_read():
    wc = WindowedCounters()
    wc.fast.record(OpClass.LOAD, 10.0)
    df, ds = wc.delta()
    assert (df.inserts, ds.inserts) == (1, 0)
    assert wc.delta()[0].inserts == 0


# -- the serve entry point -------------------------------------------------------


def test_build_cluster_serves_on_cpu(capsys):
    cl = port_serve.build_cluster(n_requests=3, max_new=4, mode="miku", device="cpu")
    assert [e.cfg.placement for e in cl.engines] == ["device", "host"]
    res = cl.run(20000)
    assert res["hbm"]["requests"] == 3 and res["host"]["requests"] == 1
    assert cl.engines[0].decode_steps == 3
    port_serve.main(["--device", "cpu", "--requests", "2", "--mode", "racing"])
    assert "simulated tok/s" in capsys.readouterr().out


def test_kv_pagemap_cluster_matches_reference():
    """A MIKU smoke cluster whose host engine's KV stream is split by a KV
    PageMap (half its pages on HBM, a drifting hot set): the reference's
    simulated tokens/s, decisions and KV hotness, and a different clock than
    the same cluster without the PageMap."""
    import repro.tiering as rt
    import repro_torch.tiering as pt

    out = {}
    for port in (False, True):
        tier, mod = (pt, teng) if port else (rt, jeng)
        pm = tier.PageMap(("hbm", "host"), fast_capacity_pages=64)
        pm.add_region("h", 64, 4096, {"hbm": 0.5, "host": 0.5},
                      tier.HotSetPattern(drift_pages=1.0))
        host = mk("h", "host", 3, port=port, kv_pagemap=pm)
        ctl = _miku(port, host.param_bytes)
        cl = mod.TieredServingCluster([mk("d", "device", 6, port=port), host],
                                      controller=ctl, window_ns=3e4)
        res = cl.run(20000)
        seq = [(d.restricted, d.max_concurrency, d.rate_factor) for d in ctl.decisions]
        out[port] = (res, seq, pm.regions["h"].hotness.copy())
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert np.array_equal(out[True][2], out[False][2]) and out[True][2].sum() > 0
    host = mk("h", "host", 3)
    plain = teng.TieredServingCluster([mk("d", "device", 6), host],
                                      controller=_miku(True, host.param_bytes),
                                      window_ns=3e4).run(20000)
    assert plain["h"]["tokens"] == out[True][0]["h"]["tokens"]
    assert plain["h"]["tokens_per_s"] != out[True][0]["h"]["tokens_per_s"]
