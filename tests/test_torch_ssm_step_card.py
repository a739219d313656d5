"""The fused SSM decode-step kernel (``kernels/ssm_step.py``,
``csrc/ssm_step.cu``) on a CUDA card (marker ``card``; each test skips
elsewhere).  This file imports no JAX: on a card run
``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_ssm_step_card.py``.

* The kernel against its plain version (``ssm_step_ref``) at the served
  shapes of mamba2 (H 80, P 64, N 128), hymba (H 50, P 64, N 16) and
  Nemotron-3 Nano (H 64, P 64, N 128, G 8) at 128 slots, at the smoke
  shapes (P 32 and 16, N 16, G 1 and 2), and at N 32 (P 48) and N 64, the
  two other states the kernel is built for, with the inputs read from the
  model's strided views of a row-major conv output and of a channel-major
  one (the decode step's einsum gives the latter), f32 and bf16
  activations: the new state equal bit
  for bit (the kernel rounds each product and sum of the update where the
  plain version does), y within 1e-5 of its scale in f32 (the read-out's
  sum over N runs in another order than the einsum's) and within 1e-2 in
  bf16 (that f32 sum, then one rounding to bf16).
* Aliasing: the kernel on one layer's run of slots inside a stacked
  [L, B, H, P, N] state writes those slots in place and nothing else.
* A CUDA graph of the call, replayed over 48 steps with new inputs, gives
  the eager calls' state and y bit for bit.
* The mamba2, hymba and Nemotron smoke models in f32, 48 greedy decode
  steps after a prefill: the tokens of the plain version's path, logits
  within 1e-4 of their scale, and SSM layers x steps launches.
* The mamba2 smoke model with every parameter and state leaf a DTensor on
  a one-rank mesh under ``DECODE_RULES``, the SSM state placed by batch and
  head: the kernel launched on the state's shards (SSM layers x steps),
  the tokens of the unmeshed run, logits and the final state within 1e-4
  and 1e-5 of their scale.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_step as kernel_mod
from repro_torch.models.transformer import TransformerLM

#: name: (slots, heads, head_dim, state, groups)
SHAPES = {
    "mamba2": (128, 80, 64, 128, 1),
    "hymba": (128, 50, 64, 16, 1),
    "nemotron": (128, 64, 64, 128, 8),
    "smoke_p32": (4, 8, 32, 16, 1),  # mamba2's and hymba's smoke configs
    "smoke_p16": (4, 8, 16, 16, 2),  # Nemotron's
    "n32_p48": (16, 8, 48, 32, 2),
    "n64": (16, 8, 64, 64, 4),
}
STEPS = 48


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scale_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def step_inputs(shape, dtype, seed, device, channel_major=False):
    """Model-layout inputs of one step: x, B and C views of a [B, conv_dim]
    conv output (laid out [conv_dim, B] in memory with ``channel_major``),
    dt_raw a view of a [B, d_in_proj] projection, as
    ``models/ssm.py:ssm_step`` cuts them; dt_bias, A_log and D in f32."""
    b, h, p, n, g = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    di, gn = h * p, g * n
    if channel_major:
        conv = torch.randn(di + 2 * gn, b, generator=gen, device=device).to(dtype).t()
    else:
        conv = torch.randn(b, di + 2 * gn, generator=gen, device=device).to(dtype)
    proj = torch.randn(b, 2 * di + 2 * gn + h, generator=gen, device=device).to(dtype)
    x = conv[:, :di].unflatten(-1, (h, p))
    bm = conv[:, di:di + gn].unflatten(-1, (g, n))
    cm = conv[:, di + gn:].unflatten(-1, (g, n))
    dt_raw = proj[:, -h:]
    dt_bias = torch.randn(h, generator=gen, device=device) - 2.0
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    d = torch.randn(h, generator=gen, device=device)
    return x, dt_raw, bm, cm, dt_bias, a_log, d


@pytest.mark.card
@pytest.mark.parametrize("layout", ["rows", "channels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_the_plain_version(card, shape, dtype, layout):
    b, h, p, n, _ = SHAPES[shape]
    state = torch.randn(b, h, p, n, generator=torch.Generator(device=card).manual_seed(1),
                        device=card)
    args = step_inputs(SHAPES[shape], getattr(torch, dtype), 2, card,
                       channel_major=layout == "channels")
    hk, hp = state.clone(), state.clone()
    before = kernel_mod.LAUNCHES.count
    yk = kernel_mod.ssm_step_cuda(hk, *args)
    torch.cuda.synchronize()
    assert kernel_mod.LAUNCHES.count == before + 1
    yp = kernel_mod.ssm_step_ref(hp, *args)
    assert yk.dtype == yp.dtype == args[0].dtype and yk.shape == (b, h, p)
    assert torch.equal(hk, hp)
    assert not torch.equal(hk, state)
    assert _scale_err(yk, yp) <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.card
@pytest.mark.parametrize("n", [16, 128])
def test_kernel_writes_its_slots_in_place_and_nothing_else(card, n):
    layers, slots, h, p = 3, 6, 8, 64
    gen = torch.Generator(device=card).manual_seed(4)
    state = torch.randn(layers, slots, h, p, n, generator=gen, device=card)
    before = state.clone()
    args = step_inputs((3, h, p, n, 1), torch.bfloat16, 5, card, channel_major=True)
    want = before[1, 2:5].clone()
    y_want = kernel_mod.ssm_step_ref(want, *args)
    view = state[1, 2:5]
    y = kernel_mod.ssm_step_cuda(view, *args)
    torch.cuda.synchronize()
    assert view.data_ptr() == state[1, 2].data_ptr() and y.data_ptr() != view.data_ptr()
    assert torch.equal(state[1, 2:5], want)
    assert _scale_err(y, y_want) <= 1e-2
    for layer in range(layers):
        for slot in range(slots):
            if not (layer == 1 and 2 <= slot < 5):
                assert torch.equal(state[layer, slot], before[layer, slot]), (layer, slot)


@pytest.mark.card
@pytest.mark.parametrize("shape", ["nemotron", "smoke_p32"])
def test_graph_replays_the_eager_calls_bit_for_bit(card, shape):
    b, h, p, n, _ = SHAPES[shape]
    gen = torch.Generator(device=card).manual_seed(6)
    state = torch.randn(b, h, p, n, generator=gen, device=card)
    eager = state.clone()
    static = step_inputs(SHAPES[shape], torch.bfloat16, 7, card, channel_major=True)
    kernel_mod.ssm_step_cuda(state.clone(), *static)  # builds and loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_static = kernel_mod.ssm_step_cuda(state, *static)
    for step in range(STEPS):
        new = step_inputs(SHAPES[shape], torch.bfloat16, 100 + step, card, channel_major=True)
        for buf, val in zip(static, new):
            buf.copy_(val)
        graph.replay()
        y = kernel_mod.ssm_step_cuda(eager, *new)
        torch.cuda.synchronize()
        assert torch.equal(y_static, y), step
        assert torch.equal(state, eager), step


def _greedy(model, params, prompts, device):
    """Prefill the prompts as one batch, then STEPS greedy decode steps:
    (tokens [STEPS, B], logits of each step)."""
    b, s = prompts.shape
    state = model.init_decode_state(b, s + STEPS + 1, device)
    logits, state = model.prefill(params, prompts, state)
    tokens, out = [], []
    for _ in range(STEPS):
        tok = logits.argmax(-1).to(torch.int32)
        tokens.append(tok)
        logits, state = model.decode_step(params, state, tok)
        out.append(logits.float())
    return torch.stack(tokens), out, state


@pytest.mark.card
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b", "nemotron3-nano-30b-a3b"])
def test_greedy_streams_equal_the_plain_path(card, arch, monkeypatch):
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(3), card)
    prompts = torch.randint(1, cfg.vocab, (4, 6),
                            generator=torch.Generator(device=card).manual_seed(8), device=card)
    before = kernel_mod.LAUNCHES.count
    tokens, logits, state = _greedy(model, params, prompts, card)
    launched = kernel_mod.LAUNCHES.count - before
    monkeypatch.setattr(ops, "ssm_step_cuda", kernel_mod.ssm_step_ref)
    want_tokens, want_logits, _ = _greedy(model, params, prompts, card)
    assert launched == state.ssm["h"].shape[0] * STEPS
    assert torch.equal(tokens, want_tokens)
    for got, want in zip(logits, want_logits):
        assert _scale_err(got, want) <= 1e-4


@pytest.mark.card
def test_dtensor_decode_launches_on_the_shards(card, tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.autosharding import distribute_tree, logical_sharding_context
    from repro_torch.distributed.sharding import DECODE_RULES
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_arch("mamba2-2.7b").smoke, dtype=torch.float32)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(3), card)
    prompts = torch.randint(1, cfg.vocab, (4, 6),
                            generator=torch.Generator(device=card).manual_seed(8), device=card)
    want_tokens, want_logits, want_state = _greedy(model, params, prompts, card)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), card)
        dparams = distribute_tree(params, mesh, model.param_axes(), DECODE_RULES)
        state = distribute_tree(model.init_decode_state(4, 6 + STEPS + 1, card), mesh,
                                model.decode_state_axes(), DECODE_RULES)
        # A mesh axis of one replicates under the rules: place the state by
        # batch and head, as they do on a larger mesh.
        state.ssm["h"] = state.ssm["h"].redistribute(mesh, [Shard(1), Shard(2)])
        tokens = distribute_tree({"t": prompts}, mesh, {"t": ("batch", "seq")},
                                 DECODE_RULES)["t"]
        before = kernel_mod.LAUNCHES.count
        got_tokens, got_logits = [], []
        with torch.no_grad(), logical_sharding_context(mesh, DECODE_RULES):
            logits, state = model.prefill(dparams, tokens, state)
            for _ in range(STEPS):
                tok = logits.full_tensor().argmax(-1).to(torch.int32)
                got_tokens.append(tok)
                logits, state = model.decode_step(dparams, state, tok)
                got_logits.append(logits.full_tensor().float())
        launched = kernel_mod.LAUNCHES.count - before
        assert tuple(state.ssm["h"].placements) == (Shard(1), Shard(2))
        got_h = state.ssm["h"].full_tensor()
    finally:
        dist.destroy_process_group()
    assert launched == want_state.ssm["h"].shape[0] * STEPS
    assert torch.equal(torch.stack(got_tokens), want_tokens)
    for got, want in zip(got_logits, want_logits):
        assert _scale_err(got, want) <= 1e-4
    assert _scale_err(got_h, want_state.ssm["h"]) <= 1e-5
