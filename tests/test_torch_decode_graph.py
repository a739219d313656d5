"""The served decode step as one CUDA graph per engine
(``serving/engine.py``: ``ServingEngine._capture`` and ``_replay``).

On a CUDA card (marker ``card``; each such test skips elsewhere), at the
smoke widths of hymba and mamba2, in f32 and in bf16: an engine that records
its decode step after the first and replays it gives the logits and greedy
tokens of an engine held eager, bit for bit, over more than 40 steps between
which prefills, retirements and a slot running into ``max_len`` fall; K1
counts attention layers x decode steps with the replays; the registry counts
one capture and steps - 1 replays.  A temperature-sampled engine replays its
logits and draws the eager engine's tokens from them; an engine whose
weights are DTensors stays eager.

On the CPU, which every tier-1 run covers: no graph is recorded, every
``serving.decode`` span says ``graph`` False, both counters stay where they
were, and each step writes the tokens, lengths and state that
``decode_step`` and the sampler give on a copy of the engine's.

On a card: ``PYTHONPATH=src python -m pytest --noconftest
tests/test_torch_decode_graph.py`` (the suite's conftest imports JAX, which
the card's machine does not have).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as k1
from repro_torch.models.transformer import TransformerLM
from repro_torch.obs import metrics
from repro_torch.obs.metrics import PhaseProfiler, default_registry
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)

ARCHS = ("hymba-1.5b", "mamba2-2.7b")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
COUNTERS = ("serving.decode.graph_captures", "serving.decode.graph_replays")
SLOTS, MAX_LEN = 4, 40
#: (prompt length, new tokens): more requests than slots, so prefills fall
#: between replays as slots retire; the 30-token prompt's slot runs into
#: ``max_len`` before its 30 new tokens.
REQUESTS = ((5, 19), (12, 25), (3, 6), (30, 30), (8, 24), (17, 11), (6, 30), (21, 7),
            (4, 26), (9, 22))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def prof(monkeypatch):
    """A fresh process-default span log."""
    p = PhaseProfiler(log_size=metrics.LOG_SIZE)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    return p


def _model(arch, dtype, device):
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=DTYPES[dtype])
    params = TransformerLM(cfg).init(torch.Generator(device=device).manual_seed(3), device)
    return cfg, params


def _engine(cfg, params, *, sampler="greedy", eager=False):
    eng = ServingEngine(EngineConfig(name="e", model=cfg, max_slots=SLOTS, max_len=MAX_LEN,
                                     sampler=sampler), params,
                        generator=torch.Generator(device=params["embed"].device).manual_seed(5))
    if eager:
        eng._graphable = lambda params: False
    g = torch.Generator().manual_seed(11)
    for rid, (plen, new) in enumerate(REQUESTS):
        prompt = torch.randint(1, cfg.vocab, (plen,), generator=g).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    return eng


def _serve(eng, each=None):
    """Admit and decode until every request is done: (streams by request,
    each step's logits)."""
    logits = []
    while not eng.finished:
        eng.admit(0.0)
        if each is not None:
            each(eng)
        if eng.decode_once(0.0):
            logits.append(eng.logits.clone())
    return {r.rid: r.output for r in eng.done}, logits


def _counts():
    reg = default_registry()
    return [reg.counter(n).value for n in COUNTERS]


def _decodes(prof):
    return [r for r in prof.log if r.name == "serving.decode"]


def _check_serves_every_case(eng):
    assert len(eng.done) == len(REQUESTS)
    assert eng.decode_steps > 40
    overflowed = [r for r in eng.done if len(r.output) < r.max_new_tokens]
    assert [r.rid for r in overflowed] == [3]


# -- on the CPU -----------------------------------------------------------


def _shadow_step(eng, expected):
    """Before each step: what ``decode_step`` and the sampler give on a copy
    of the engine's state, tokens and generator."""
    state = dataclasses.replace(
        eng.state, kv=None if eng.state.kv is None else {k: v.clone() for k, v in eng.state.kv.items()},
        ssm=None if eng.state.ssm is None else {k: v.clone() for k, v in eng.state.ssm.items()},
        length=eng.state.length.clone())
    logits, state = eng.model.decode_step(eng.params, state, eng._tokens.clone())
    if eng.cfg.sampler == "greedy":
        tokens = sampler_lib.greedy(logits)
    else:
        gen = torch.Generator().set_state(eng.generator.get_state())
        tokens = sampler_lib.temperature(logits, gen)
    expected.append((logits, tokens, state))


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_engine_stays_eager_and_steps_as_decode_step(prof, arch, sampler):
    cfg, params = _model(arch, "f32", torch.device("cpu"))
    eng = _engine(cfg, params, sampler=sampler)
    before = _counts()
    expected, got = [], []

    def each(e):
        if e.n_active:
            _shadow_step(e, expected)

    orig = eng.decode_once

    def decode_once(now_ns):
        n = orig(now_ns)
        if n:
            got.append((eng.logits.clone(), eng._tokens.clone(), eng.state.length.clone(),
                        {k: v.clone() for k, v in (eng.state.ssm or {}).items()}))
        return n

    eng.decode_once = decode_once
    _serve(eng, each)
    _check_serves_every_case(eng)
    assert eng._graph is None and _counts() == before
    spans = _decodes(prof)
    assert len(spans) == eng.decode_steps and not any(s.args["graph"] for s in spans)
    assert len(got) == len(expected) == eng.decode_steps
    for (logits, tokens, length, ssm), (want_l, want_t, want_s) in zip(got, expected):
        assert torch.equal(logits, want_l) and torch.equal(tokens, want_t)
        assert torch.equal(length, want_s.length)
        for k, v in ssm.items():
            assert torch.equal(v, want_s.ssm[k])


def test_graph_rule_reads_the_device_and_dtensor_leaves(tmp_path):
    """On a CUDA device the step is recorded unless a leaf of the weights
    or of the state is a DTensor; on the CPU never (here the engine's
    device is set to CUDA by hand to reach the DTensor rule)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.pytree import tree_map

    cfg, params = _model("hymba-1.5b", "f32", torch.device("cpu"))
    eng = _engine(cfg, params)
    assert not eng._graphable(params)
    eng.device = torch.device("cuda", 0)
    assert eng._graphable(params)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        dparams = tree_map(lambda t: distribute_tensor(t, mesh, [Replicate()]), params)
        assert not eng._graphable(dparams)
        eng.state.length = distribute_tensor(eng.state.length, mesh, [Replicate()])
        assert not eng._graphable(params)
    finally:
        dist.destroy_process_group()


# -- on the card ----------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_replays_the_eager_engine_bit_for_bit(card, prof, arch, dtype):
    cfg, params = _model(arch, dtype, card)
    eager_streams, eager_logits = _serve(_engine(cfg, params, eager=True))
    assert _decodes(prof) and not any(s.args["graph"] for s in _decodes(prof))
    prof.log.clear()
    before = _counts()
    k1.LAUNCHES.reset()
    eng = _engine(cfg, params)
    streams, logits = _serve(eng)
    launches = k1.LAUNCHES.count
    _check_serves_every_case(eng)
    assert streams == eager_streams
    assert len(logits) == len(eager_logits) == eng.decode_steps
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)
    steps = eng.decode_steps
    attn_layers = cfg.n_layers if cfg.uses_attention else 0
    assert launches == attn_layers * steps
    assert [b - a for a, b in zip(before, _counts())] == [1, steps - 1]
    spans = _decodes(prof)
    assert [s.args["graph"] for s in spans] == [False] + [True] * (steps - 1)


@pytest.mark.card
def test_temperature_engine_replays_its_logits(card, prof):
    cfg, params = _model("hymba-1.5b", "f32", card)
    eager_streams, eager_logits = _serve(_engine(cfg, params, sampler="temperature",
                                                 eager=True))
    before = _counts()
    eng = _engine(cfg, params, sampler="temperature")
    streams, logits = _serve(eng)
    assert eng._graph is not None
    assert [b - a for a, b in zip(before, _counts())] == [1, eng.decode_steps - 1]
    assert streams == eager_streams
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)


@pytest.mark.card
def test_dtensor_weights_keep_the_engine_eager(card, tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.pytree import tree_map

    cfg, params = _model("hymba-1.5b", "f32", card)
    eng = _engine(cfg, params)
    assert eng._graphable(params)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        dparams = tree_map(lambda t: distribute_tensor(t, mesh, [Replicate()]), params)
        assert not eng._graphable(dparams)
    finally:
        dist.destroy_process_group()
