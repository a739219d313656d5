"""Nemotron-H's kernels and decode graph on a CUDA card (marker ``card``;
each test skips elsewhere).  This file imports no JAX: on a card run
``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_nemotron_card.py``.

* K4 with groups (``kernels/ssd_scan.py``) against the model's plain scan
  ``ssd_chunked`` at Nemotron's shape (H 64, P 64, N 128, G 8) at S = 8,
  1,024 and 4,096 in bf16: y and the final state within 5e-2 of their
  scale, ``chip_smoke.py``'s bf16 gate for K4 against the plain scan (the
  kernel rounds W' and h_in to bf16 where the plain scan keeps f32).
* K4 at one group gives the bits it gave before groups were taken, on
  hymba's and mamba2's smoke and full shapes in f32 and bf16: SHA-256 of y
  and the state, pinned from the kernel of the tree before groups (NVIDIA
  H100 80GB HBM3).
* K1 at G = 16 (32 query over 2 KV heads of 128) against the plain
  attention, f32 within 1e-5 and bf16 within 2e-2 of the output's scale
  (``chip_smoke.py``'s K1 gates).
* The dropless MoE's grouped expert products (the library's
  ``torch._grouped_mm``, the path of bf16 on a card) against their plain
  version at Nemotron's widths, a decode step's 128 tokens and a prefill's
  1,024, within 2e-2 of the output's scale in bf16; and the layer captured
  in a CUDA graph, in bf16 and in f32 (the plain version), replayed equal
  to the eager call.
* The decode step as one CUDA graph on Nemotron's smoke config, replayed
  over more than 40 steps between prefills and retirements: the logits and
  tokens of an engine held eager, bit for bit, in f32 and bf16, with the
  MoE counts of every step.
"""

import dataclasses
import hashlib

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch
from repro_torch.kernels import ssd_scan as k4
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import moe as moe_lib
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scale_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# -- K4 ---------------------------------------------------------------------


def k4_inputs(b, s, h, p, n, groups, dtype, seed, device):
    """Seeded scan inputs, made on the CPU: x [B,S,H,P], dt, B and C
    [B,S,G,N] (or [B,S,N] for ``groups`` None), a."""
    g = torch.Generator().manual_seed(seed)
    shape = (b, s, n) if groups is None else (b, s, groups, n)
    x = torch.randn(b, s, h, p, generator=g) * 0.5
    bm = torch.randn(shape, generator=g) * 0.3
    cm = torch.randn(shape, generator=g) * 0.3
    dt = F.softplus(torch.randn(b, s, h, generator=g) - 1.0)
    a = -torch.exp(torch.randn(h, generator=g) * 0.3)
    return (x.to(dtype).to(device), dt.to(device), bm.to(dtype).to(device),
            cm.to(dtype).to(device), a.to(device))


@pytest.mark.card
@pytest.mark.parametrize("s", [8, 1024, 4096])
def test_grouped_k4_matches_the_plain_scan(card, s):
    x, dt, bm, cm, a = k4_inputs(1, s, 64, 64, 128, 8, torch.bfloat16, 33 + s, card)
    before = k4.LAUNCHES.count
    y, state = k4.ssd_scan_cuda(x, dt, bm, cm, a, chunk=min(128, s))
    assert k4.LAUNCHES.count == before + 1
    want_y, want_state = ssd_chunked(x, bm, cm, dt, a, chunk=128)
    torch.cuda.synchronize()
    assert _scale_err(y, want_y) <= 5e-2
    assert _scale_err(state, want_state) <= 5e-2
    plan = k4.plan_for(1, s, 64, 64, 128, min(128, s), torch.bfloat16, card, 8)
    assert plan["head_groups"] % 8 == 0 and 8 % plan["heads_per_block"] == 0


#: (name, B, S, H, P, N, chunk) -> SHA-256 of y and the state from K4 before
#: groups, per dtype.
K4_SHAPES = {
    "smoke_2chunks": (2, 24, 8, 32, 16, 16),
    "smoke_1chunk": (2, 12, 8, 32, 16, 16),
    "hymba_2048": (1, 2048, 50, 64, 16, 128),
    "mamba2_2048": (1, 2048, 80, 64, 128, 128),
    "mamba2_200": (1, 200, 80, 64, 128, 128),
}
K4_DIGESTS = {
    "hymba_2048/bfloat16":
        "d62df3ef1bcd03227dd22862c63dbe6e4c586e2e97918d00c7585b9e3b2524f0",
    "hymba_2048/float32":
        "b24fb1aaeeda30672ddd394813a60024294e8ab958c0f2e1eed746620f9582d5",
    "mamba2_200/bfloat16":
        "e41061ba78c71bcabd751a430788e2ddd64b91646408069a24dae6535e2ab9a4",
    "mamba2_200/float32":
        "5cc3f5ad81edf6a77354624b5429c4f385ac9e5a6946b82f697c560efd51e248",
    "mamba2_2048/bfloat16":
        "91ae7176b0cc11f8576fe7038cfb3f6d913ba5329a4197c4e579728fb94c0c70",
    "mamba2_2048/float32":
        "11f11bdbeff6e4afa2a3421c3d79a5207344f77c414425150a15eb505b13a775",
    "smoke_1chunk/bfloat16":
        "995afd532272b09277d2a6efb4894680f85b08066a56a5e442d8d86090d21408",
    "smoke_1chunk/float32":
        "f52b7a425953bb524e6e0c45d8c1a8c27be1adcef9524b806e1e508de69de11c",
    "smoke_2chunks/bfloat16":
        "10f56f798fb1a3e66db691956d30760c7089cd9f5aaed09d76dcec206a87f2a2",
    "smoke_2chunks/float32":
        "f79d4c86210c4941e74ce1e36ae433106aa50e43a612a43f9f8b3d633d40d810",
}


def k4_digest(y, state):
    h = hashlib.sha256()
    for t in (y, state):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(K4_SHAPES))
def test_k4_at_one_group_gives_its_former_bits(card, shape, dtype):
    b, s, h, p, n, chunk = K4_SHAPES[shape]
    args = k4_inputs(b, s, h, p, n, None, getattr(torch, dtype), 7, card)
    y, state = k4.ssd_scan_cuda(*args, chunk=min(chunk, s))
    assert k4_digest(y, state) == K4_DIGESTS[f"{shape}/{dtype}"]


# -- K1 at G = 16 -------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_k1_at_sixteen_query_heads_a_group(card, dtype, tol):
    g = torch.Generator().manual_seed(11)
    dt = getattr(torch, dtype)
    b, hq, hkv, dh, s = 4, 32, 2, 128, 4672
    q = (torch.randn(b, hkv, hq // hkv, dh, generator=g)).to(dt).to(card)
    k = (torch.randn(b, hkv, s, dh, generator=g)).to(dt).to(card)
    v = (torch.randn(b, hkv, s, dh, generator=g)).to(dt).to(card)
    lengths = torch.tensor([4672, 1, 1031, 3000], dtype=torch.int32, device=card)
    got = decode_attention_cuda(q, k, v, lengths, window=1 << 30, softcap=None, scale=None)
    want = decode_attention_ref(q, k, v, lengths, window=1 << 30, softcap=None, scale=None)
    assert _scale_err(got, want) <= tol


# -- the dropless MoE's expert products ---------------------------------------


def _moe_call(tokens, dtype, device, seed=13):
    g = torch.Generator().manual_seed(seed)
    d, f, held, r, k = 2688, 1856, 32, 128, 6
    params = {"router": torch.randn(d, r, generator=g) * d ** -0.5,
              "router_bias": torch.randn(r, generator=g) * 0.1,
              "w_experts_in": torch.randn(held, d, f, generator=g) * d ** -0.5,
              "w_experts_out": torch.randn(held, f, d, generator=g) * f ** -0.5}
    params = {n: t.to(dtype).to(device) for n, t in params.items()}
    x = torch.randn(tokens, 1, d, generator=g).to(dtype).to(device)
    return params, x, k


@pytest.mark.card
@pytest.mark.parametrize("tokens", [128, 1024])
def test_grouped_products_match_their_plain_version(card, tokens):
    params, x, k = _moe_call(tokens, torch.bfloat16, card)
    xf = x.reshape(tokens, -1)
    gates, idx = moe_lib.route_sigmoid(params, xf, k, 2.5)
    held = params["w_experts_in"].shape[0]
    flat = idx.reshape(-1)
    key = torch.where(flat < held, flat, held)
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(key[order], torch.arange(held + 1, device=card))
    args = (xf, order // k, gates.reshape(-1)[order], order, offsets,
            params["w_experts_in"], params["w_experts_out"])
    got = moe_lib._grouped_experts_library(*args)
    want = moe_lib._grouped_experts_plain(*args)
    mine = (flat < held)[:, None]
    assert _scale_err(torch.where(mine, got, 0.0), want) <= 2e-2


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_dropless_layer_replays_in_a_cuda_graph(card, dtype):
    params, x, k = _moe_call(128, getattr(torch, dtype), card)
    counts = torch.zeros(2, dtype=torch.int64, device=card)
    eager = moe_lib.dropless_apply(params, x, top_k=k, scaling=2.5, counts=counts)
    eager_counts = counts.clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        counts.zero_()
        out = moe_lib.dropless_apply(params, x, top_k=k, scaling=2.5, counts=counts)
        graph.capture_end()
    torch.cuda.current_stream(card).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(counts, eager_counts)
    assert 0 < int(counts[0]) <= 128 * k and 0 < int(counts[1]) <= 32


# -- the decode graph on Nemotron's smoke config -------------------------------

SLOTS, MAX_LEN = 4, 40
REQUESTS = ((5, 19), (12, 25), (3, 6), (30, 30), (8, 24), (17, 11), (6, 30), (21, 7),
            (4, 26), (9, 22))


def _engine(cfg, params, *, eager=False):
    eng = ServingEngine(EngineConfig(name="e", model=cfg, max_slots=SLOTS, max_len=MAX_LEN),
                        params)
    if eager:
        eng._graphable = lambda params: False
    g = torch.Generator().manual_seed(11)
    for rid, (plen, new) in enumerate(REQUESTS):
        prompt = torch.randint(1, cfg.vocab, (plen,), generator=g).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    return eng


def _serve(eng):
    logits, counts = [], []
    while not eng.finished:
        eng.admit(0.0)
        if eng.decode_once(0.0):
            logits.append(eng.logits.clone())
            counts.append(eng.state.moe.tolist())
    return {r.rid: r.output for r in eng.done}, logits, counts


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replays_the_eager_engine_bit_for_bit(card, dtype):
    cfg = dataclasses.replace(get_arch("nemotron3-nano-30b-a3b").smoke,
                              dtype=getattr(torch, dtype), n_experts=4)
    params = TransformerLM(cfg).init(torch.Generator(device=card).manual_seed(3), card)
    eager_streams, eager_logits, eager_counts = _serve(_engine(cfg, params, eager=True))
    eng = _engine(cfg, params)
    streams, logits, counts = _serve(eng)
    assert eng._graph is not None and eng.decode_steps > 40
    assert streams == eager_streams and counts == eager_counts
    assert len(logits) == len(eager_logits) == eng.decode_steps
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)
