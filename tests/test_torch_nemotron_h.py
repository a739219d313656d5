"""Nemotron-H (``nemotron3-nano-30b-a3b``), the port's mixed stack of
Mamba-2, dropless MoE and attention layers, on the CPU.

Against the benchmark's plain float32 reference
(``portbench/reference/nemotron_h.py``, which imports nothing of the port)
at the configuration's smoke widths on seeded random weights: the full
forward to 2e-5 of the logits' scale and prefill then decode through the
cache to 5e-5, the bounds of the benchmark's reference tests for hymba and
mamba2 (float32 sums taken in another order over a few hundred products: a
few ulps of the largest logit, where a left-out term or a wrong group would
move the logits by a tenth or more).  The held shares of an MoE layer add
up to the layer with all experts held; a router biased onto two experts
drops nothing.  The registry's parameter counts, the KV bytes the engine
charges, the pattern's checks, the engine's MoE spans and counters, K4's
groups on the CPU and the configuration's least-work module.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402
from portbench.least_work import nemotron_h as work  # noqa: E402
from portbench.reference import nemotron_h as reference  # noqa: E402
from portbench.weights import make_weights  # noqa: E402
from repro_torch.configs import ARCH_IDS, PORT_ONLY_IDS, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models.transformer import ModelConfig, TransformerLM, param_shapes  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.metrics import PhaseProfiler, default_registry  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)

ARCH = "nemotron3-nano-30b-a3b"
FILE = json.loads((REPO / "portbench" / "configs" / f"{ARCH}.json").read_text())
SEED = 2**31 + 3
CPU = torch.device("cpu")


def _smoke(dtype="float32", **changes):
    m = dict(FILE["smoke"], dtype=dtype, **changes)
    cfg = harness.model_config(m)
    w = make_weights(param_shapes(cfg), SEED, CPU, FILE["weights"])
    return m, cfg, TransformerLM(cfg), w


def _tokens(n, seed):
    return torch.randint(0, FILE["smoke"]["vocab"], (n,), generator=torch.Generator().manual_seed(seed))


# -- the configuration and the registry ------------------------------------


def test_registry_counts_and_kv_bytes():
    cfg = get_arch(ARCH).config
    assert ARCH in PORT_ONLY_IDS and ARCH not in ARCH_IDS
    assert cfg.param_count() == 31_577_940_288
    held = dataclasses.replace(cfg, n_experts=32)
    assert held.router_width == 128 and held.layer_pattern == cfg.layer_pattern
    assert held.param_count() == 9_546_834_240
    assert FILE["held"]["parameters"] == held.param_count()
    assert FILE["published"]["parameters"] == cfg.param_count()
    # each MoE layer's held experts at the share of the 6 choices that fall on them
    per_expert = 2 * 2688 * 1856
    assert held.active_param_count() == (held.param_count() - 23 * 32 * per_expert
                                         + 23 * per_expert * 6 * 32 // 128)
    assert (cfg.kind_layers("M"), cfg.kind_layers("E"), cfg.n_attn_layers) == (23, 23, 6)
    assert [i for i, c in enumerate(cfg.layer_pattern) if c == "*"] == [5, 12, 19, 26, 33, 42]
    assert cfg.ssm_dims["d_inner"] == 4096 and cfg.ssm_dims["d_in_proj"] == 10304


def test_engine_charges_the_attention_layers_kv_bytes():
    cfg = get_arch(ARCH).smoke
    params = TransformerLM(cfg).init(torch.Generator().manual_seed(0), CPU)
    eng = ServingEngine(EngineConfig(name="e", model=cfg, max_slots=2, max_len=32), params)
    assert eng.kv_bytes_per_token == 2 * 2 * 32 * 1 * 2
    full = get_arch(ARCH).config
    assert 2 * full.n_kv_heads * full.head_dim * full.n_attn_layers * 2 == 6144
    for arch in ("llama31-8b", "mamba2-2.7b", "hymba-1.5b"):
        c = get_arch(arch).config
        assert c.n_attn_layers == (c.n_layers if c.uses_attention else 0)


def test_the_file_holds_the_catalog_numbers_and_the_cut():
    assert FILE["reduced"] == ["n_routed_experts"]
    assert FILE["n_routed_experts"] == FILE["model"]["n_experts"] == 32
    assert FILE["published"]["n_routed_experts"] == FILE["model"]["router_experts"] == 128
    assert FILE["hybrid_override_pattern"] == FILE["model"]["layer_pattern"]
    m = FILE["model"]
    for key, ours in (("hidden_size", "d_model"), ("num_hidden_layers", "n_layers"),
                      ("mamba_num_heads", "ssm_heads"), ("mamba_head_dim", "ssm_head_dim"),
                      ("ssm_state_size", "ssm_state"), ("n_groups", "ssm_groups"),
                      ("moe_intermediate_size", "d_ff"), ("num_experts_per_tok", "top_k"),
                      ("moe_shared_expert_intermediate_size", "shared_expert_ff"),
                      ("routed_scaling_factor", "routed_scaling"), ("norm_eps", "norm_eps"),
                      ("num_attention_heads", "n_q_heads"), ("head_dim", "head_dim"),
                      ("num_key_value_heads", "n_kv_heads"), ("vocab_size", "vocab"),
                      ("chunk_size", "ssm_chunk")):
        assert FILE[key] == m[ours], key
    assert m["rope_theta"] is None and "rope_theta" in FILE["assumed"]


def test_other_families_keep_their_fields_and_settings():
    """The mixed stack's settings are not dataclass fields; every other
    family reads their defaults, and a replaced config keeps them."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    assert not names & {"layer_pattern", "ssm_heads", "norm_eps", "router", "routed_scaling",
                        "router_experts"}
    for arch in ARCH_IDS:
        c = get_arch(arch).config
        assert (c.layer_pattern, c.ssm_heads, c.norm_eps, c.router, c.routed_scaling) == \
            (None, 0, None, "softmax", 1.0)
        assert c.router_experts == 0 and c.router_width == c.n_experts
        assert c.kind_layers("E") == 0
    smoke = dataclasses.replace(get_arch(ARCH).smoke, dtype=torch.float32)
    assert (smoke.layer_pattern, smoke.router, smoke.norm_eps) == ("MEM*EM", "sigmoid", 1e-5)


BAD = {
    "pattern_length": dict(layer_pattern="MEM*E"),
    "unknown_letter": dict(layer_pattern="MEM*EX"),
    "experts_without_E": dict(layer_pattern="MMM*MM"),
    "E_without_experts": dict(n_experts=0),
    "M_without_state": dict(ssm_state=0),
    "attention_without_heads": dict(n_q_heads=0, n_kv_heads=0, head_dim=0),
    "softmax_router": dict(router="softmax"),
    "gated_experts": dict(activation="silu"),
    "more_held_than_routed": dict(n_experts=33),
    "top_k_above_router": dict(top_k=33),
    "groups_not_dividing_heads": dict(ssm_groups=3),
    "pattern_on_another_block": dict(block="ssm"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_a_pattern_that_does_not_match_raises(case):
    fields = dict(FILE["smoke"], dtype="float32", **BAD[case])
    with pytest.raises(ValueError):
        harness.model_config(fields)


def test_every_leaf_has_logical_axes_of_its_rank():
    from repro_torch.models.transformer import param_axes

    cfg = get_arch(ARCH).smoke
    axes, shapes = param_axes(cfg), param_shapes(cfg)

    def walk(a, s, stacked):
        for k, v in s.items():
            if isinstance(v, dict):
                walk(a[k], v, stacked or k == "layers")
            else:
                assert len(a[k]) == len(v[0]) and (a[k][0] == "layers") == stacked, k

    walk(axes, shapes, False)
    assert axes["layers"]["experts"]["moe"]["w_experts_in"] == ("layers", "experts", "embed",
                                                               "ffn")


def test_the_mixed_settings_stay_on_the_mixed_stack():
    with pytest.raises(ValueError, match="mixed"):
        dataclasses.replace(get_arch("dbrx-132b").smoke, router="sigmoid")
    with pytest.raises(ValueError, match="mixed"):
        dataclasses.replace(get_arch("llama31-8b").smoke, activation="relu2")


# -- the port against the reference ----------------------------------------


def test_forward_matches_the_reference():
    m, cfg, lm, w = _smoke()
    tokens = _tokens(53, 1)
    port = lm.logits(w, lm.forward(w, tokens[None]))[0]
    ref = reference.logits(m, w, tokens.tolist(), list(range(53)))
    assert (ref - port).abs().max() <= 2e-5 * port.abs().max()


def test_prefill_then_decode_matches_the_reference():
    m, cfg, lm, w = _smoke()
    seq = _tokens(40, 2)
    state = lm.init_decode_state(1, 64, CPU)
    logits, state = lm.prefill(w, seq[None, :20], state)
    got = [logits[0]]
    for t in seq[20:39]:
        logits, state = lm.decode_step(w, state, t[None].to(torch.int32))
        got.append(logits[0])
    ref = reference.logits(m, w, seq.tolist(), list(range(19, 39)))
    port = torch.stack(got)
    assert (ref - port).abs().max() <= 5e-5 * port.abs().max()
    assert state.kv["k"].shape[0] == 1 and state.ssm["h"].shape[0] == 3


def test_the_reference_refuses_other_blocks_and_precisions():
    m = dict(FILE["smoke"])
    with pytest.raises(ValueError):
        reference.logits(dict(m, block="ssm"), {"embed": torch.zeros(4, 4)}, [1], [0])
    with pytest.raises(ValueError):
        reference.logits(m, {"embed": torch.zeros(4, 4)}, [1], [0], precision="int3")


def test_the_fp8_control_differs_and_keeps_its_scale():
    m, cfg, lm, w = _smoke()
    seq = _tokens(30, 3).tolist()
    a = reference.logits(m, w, seq, [29])
    b = reference.logits(m, w, seq, [29], precision="fp8")
    assert not torch.equal(a, b)
    assert (a - b).abs().max() < 0.5 * a.abs().max()


def _moe_layer(w, j=0):
    return {k: v[j] if not isinstance(v, dict) else {kk: vv[j] for kk, vv in v.items()}
            for k, v in w["layers"]["experts"]["moe"].items()}


def test_held_shares_add_up_to_the_whole_layer():
    """With all 32 experts held, the layer is the sum of the four shares of
    eight experts each, the shared expert counted once (in the port and in
    the reference)."""
    m, cfg, lm, w = _smoke(n_experts=32)
    p = _moe_layer(w)
    x = torch.randn(1, 37, cfg.d_model, generator=torch.Generator().manual_seed(4))
    kw = dict(top_k=cfg.top_k, scaling=cfg.routed_scaling)
    whole = moe_lib.dropless_apply(p, x, **kw)
    routed = {k: v for k, v in p.items() if k != "shared"}
    parts = []
    for first in range(0, 32, 8):
        share = dict(routed, w_experts_in=p["w_experts_in"][first:first + 8],
                     w_experts_out=p["w_experts_out"][first:first + 8])
        parts.append(moe_lib.dropless_apply(share, x, first=first, **kw))
    sh = p["shared"]
    shared = moe_lib.relu2(x @ sh["w_up"]) @ sh["w_down"]
    assert torch.allclose(sum(parts) + shared, whole, atol=1e-6, rtol=1e-5)
    ref_whole = reference.moe(m, p, x[0], "f32")
    ref_parts = sum(reference.moe(m, dict(routed, w_experts_in=p["w_experts_in"][f:f + 8],
                                          w_experts_out=p["w_experts_out"][f:f + 8]),
                                  x[0], "f32", first=f, shared=False) for f in range(0, 32, 8))
    ref_shared = reference.relu2(x[0] @ sh["w_up"]) @ sh["w_down"]
    assert torch.allclose(ref_parts + ref_shared, ref_whole, atol=1e-6, rtol=1e-5)
    assert (ref_whole - whole[0]).abs().max() <= 2e-5 * whole.abs().max()


def test_a_router_biased_onto_two_experts_drops_nothing():
    """At top 2, every token picks experts 0 and 1: each held expert takes
    all 41 tokens (a capacity path would drop most), and the port still
    matches the reference."""
    m, cfg, lm, w = _smoke(top_k=2)
    bias = w["layers"]["experts"]["moe"]["router_bias"]
    bias.zero_()
    bias[:, :2] = 10.0
    seq = _tokens(41, 5)
    state = lm.init_decode_state(1, 64, CPU)
    logits, state = lm.prefill(w, seq[None], state)
    # 41 tokens x 2 choices x 2 MoE layers, all on held experts 0 and 1
    assert state.moe.tolist() == [41 * 2 * 2, 2 * 2]
    port = lm.logits(w, lm.forward(w, seq[None]))[0]
    ref = reference.logits(m, w, seq.tolist(), list(range(41)))
    assert (ref - port).abs().max() <= 2e-5 * port.abs().max()
    assert (ref[-1] - logits[0]).abs().max() <= 2e-5 * port.abs().max()


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_the_library_grouped_products_match_the_plain_version(dtype, tol):
    """The card's path (``torch._grouped_mm`` over each held expert's run
    of sorted requests) gives the plain version's rows, where this CPU's
    library has the grouped product; the requests of experts held
    elsewhere sort last and are masked.  f32 to 1e-6 of the scale (the same
    products, summed alike); bf16 to 2e-2, the port's bf16 gate for its
    kernels against their plain versions."""
    m, cfg, lm, w = _smoke(dtype=dtype)
    p = _moe_layer(w)
    x = torch.randn(37, cfg.d_model, generator=torch.Generator().manual_seed(8)).to(cfg.dtype)
    gates, idx = moe_lib.route_sigmoid(p, x, cfg.top_k, cfg.routed_scaling)
    held = p["w_experts_in"].shape[0]
    flat = idx.reshape(-1)
    key = torch.where(flat < held, flat, held)
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(key[order], torch.arange(held + 1))
    args = (x, order // cfg.top_k, gates.reshape(-1)[order], order, offsets,
            p["w_experts_in"], p["w_experts_out"])
    mine = (flat < held)[:, None]
    assert 0 < int(mine.sum()) < flat.numel()
    got = torch.where(mine, moe_lib._grouped_experts_library(*args), 0.0)
    want = moe_lib._grouped_experts_plain(*args)
    assert torch.equal(want, torch.where(mine, want, 0.0))
    assert (got - want).abs().max() <= tol * want.abs().max()


def test_prefill_counts_the_requests_and_experts_it_routed():
    m, cfg, lm, w = _smoke()
    seq = _tokens(30, 6)
    state = lm.init_decode_state(1, 64, CPU)
    _, state = lm.prefill(w, seq[None], state)
    want = [0, 0]  # from the reference's own routing, layer by layer
    hidden = w["embed"][seq].float()
    seen = {}
    for letter in m["layer_pattern"]:
        j = seen.get(letter, 0)
        seen[letter] = j + 1
        p = reference._layer(w["layers"][reference.KINDS[letter]], j)
        if letter == "M":
            hidden = hidden + reference.mamba(m, p["ssm"], reference.rmsnorm(
                hidden, p["pre_ssm_norm"], m["norm_eps"]), "f32")
        elif letter == "E":
            h = reference.rmsnorm(hidden, p["pre_mlp_norm"], m["norm_eps"])
            _, idx = reference.route(m, p["moe"], h, "f32")
            held = idx < m["n_experts"]
            want[0] += int(held.sum())
            want[1] += len(set(idx[held].tolist()))
            hidden = hidden + reference.moe(m, p["moe"], h, "f32")
        else:
            hidden = hidden + reference.attention(m, p["attn"], reference.rmsnorm(
                hidden, p["pre_attn_norm"], m["norm_eps"]), reference.FULL_WINDOW, "f32")
    assert state.moe.tolist() == want
    assert 0 < want[0] < 30 * 2 * 2


# -- the engine's MoE spans and counters -----------------------------------


@pytest.fixture
def prof(monkeypatch):
    p = PhaseProfiler(log_size=metrics.LOG_SIZE)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    return p


def _serve(cfg, params, n=5):
    eng = ServingEngine(EngineConfig(name="e", model=cfg, max_slots=2, max_len=48), params)
    g = torch.Generator().manual_seed(7)
    for rid in range(n):
        prompt = torch.randint(1, cfg.vocab, (6 + 3 * rid,), generator=g).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
    while not eng.finished:
        eng.admit(0.0)
        eng.decode_once(0.0)
    return eng


MOE_COUNTERS = ("serving.moe.requests", "serving.moe.experts_touched", "serving.moe.choices")


def test_engine_records_the_moe_counts(prof):
    _, cfg, lm, w = _smoke()
    reg = default_registry()
    before = [reg.counter(n).value for n in MOE_COUNTERS]
    eng = _serve(cfg, w)
    spans = [s for s in prof.log if s.name in ("serving.decode", "serving.prefill")]
    assert {s.name for s in spans} == {"serving.decode", "serving.prefill"}
    k, layers = cfg.top_k, cfg.kind_layers("E")
    for s in spans:
        tokens = s.args["prompt"] if s.name == "serving.prefill" else eng.cfg.max_slots
        assert s.args["moe_choices"] == tokens * k * layers
        assert 0 <= s.args["moe_requests"] <= s.args["moe_choices"]
        assert 0 <= s.args["moe_experts"] <= cfg.n_experts * layers
        assert (s.args["moe_requests"] > 0) == (s.args["moe_experts"] > 0)
    sums = [sum(s.args[a] for s in spans) for a in ("moe_requests", "moe_experts",
                                                    "moe_choices")]
    assert [reg.counter(n).value - b for n, b in zip(MOE_COUNTERS, before)] == sums


def test_a_model_without_the_dropless_moe_records_none(prof):
    cfg = get_arch("mamba2-2.7b").smoke
    params = TransformerLM(cfg).init(torch.Generator().manual_seed(0), CPU)
    before = default_registry().snapshot()["counters"]
    _serve(cfg, params, n=2)
    spans = [s for s in prof.log if s.name in ("serving.decode", "serving.prefill")]
    assert spans and not any(k.startswith("moe_") for s in spans for k in s.args)
    after = default_registry().snapshot()["counters"]
    assert {n: after.get(n) for n in MOE_COUNTERS} == {n: before.get(n) for n in MOE_COUNTERS}


# -- the SSM's groups --------------------------------------------------------


def test_ssm_heads_set_d_inner_and_the_gated_norm_takes_groups():
    dims = ssm_lib.ssm_dims(2688, head_dim=64, d_state=128, n_groups=8, n_heads=64)
    assert (dims["d_inner"], dims["conv_dim"], dims["d_in_proj"]) == (4096, 6144, 10304)
    assert ssm_lib.ssm_dims(128, head_dim=16, d_state=16) == ssm_lib.ssm_dims(
        128, head_dim=16, d_state=16, n_heads=0)
    g = torch.Generator().manual_seed(8)
    y, z, scale = (torch.randn(3, 64, generator=g) for _ in range(3))
    one = ssm_lib._gated_norm(y, z, scale[0], 1, 1e-6)
    assert torch.equal(one, ssm_lib.rmsnorm(y * torch.nn.functional.silu(z), scale[0]))
    four = ssm_lib._gated_norm(y, z, scale[0], 4, 1e-5)
    for i in range(4):
        s = slice(16 * i, 16 * (i + 1))
        assert torch.allclose(four[:, s], ssm_lib.rmsnorm(
            y[:, s] * torch.nn.functional.silu(z[:, s]), scale[0, s], 1e-5))


def test_the_scan_operator_takes_groups_on_the_cpu():
    g = torch.Generator().manual_seed(9)
    b, s, h, p, n, G = 2, 40, 8, 16, 16, 4
    x = torch.randn(b, s, h, p, generator=g) * 0.5
    bm, cm = (torch.randn(b, s, G, n, generator=g) * 0.3 for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g) * 0.3)
    y, state = ops.ssd_scan(x, dt, bm, cm, a, chunk=16)
    y2, state2 = ssm_lib.ssd_chunked(x, bm, cm, dt, a, chunk=16)
    assert torch.allclose(y, y2, atol=1e-5) and torch.allclose(state, state2, atol=1e-5)
    y1, _ = ops.ssd_scan(x, dt, bm[:, :, 0], cm[:, :, 0], a, chunk=16)
    y1b, _ = ssm_lib.ssd_chunked(x, bm[:, :, :1], cm[:, :, :1], dt, a, chunk=16)
    assert torch.allclose(y1, y1b, atol=1e-5)


def test_k4_plans_blocks_of_one_group():
    """At one group the plan is the one K4 had before groups (the cases of
    ``launch_plan``'s docstring); at 8 a block never takes two groups."""
    plan = k4.launch_plan(1, 2048, 80, 64, 128, 128, torch.bfloat16, 132, 2)
    assert plan["heads_per_block"] == 5 and plan["head_groups"] == 16
    assert k4.launch_plan(1, 256, 80, 64, 128, 128, torch.bfloat16, 132, 2)[
        "heads_per_block"] == 1
    assert k4.launch_plan(1, 8192, 80, 64, 128, 128, torch.bfloat16, 132, 2)[
        "heads_per_block"] == 20
    for s in (8, 1024, 4096):
        for dtype, per_sm in ((torch.bfloat16, 2), (torch.float32, 1)):
            one = k4.launch_plan(1, s, 64, 64, 128, 128, dtype, 132, per_sm)
            assert one == k4.launch_plan(1, s, 64, 64, 128, 128, dtype, 132, per_sm, groups=1)
            eight = k4.launch_plan(1, s, 64, 64, 128, 128, dtype, 132, per_sm, groups=8)
            hpb = eight["heads_per_block"]
            assert 8 % hpb == 0 or hpb <= 8
            assert eight["head_groups"] == 8 * -(-8 // hpb)
            assert eight["blocks_chunk"] == eight["n_chunks"] * eight["head_groups"]


# -- the least-work module ---------------------------------------------------


def test_the_least_work_module_counts_the_pattern():
    m = FILE["model"]
    assert len(work.k4_calls(m, 1000)) == 23
    from portbench.counts import k4_call

    assert work.k4_calls(m, 1000)[0] == k4_call(1000, 64, 64, 128, groups=8)
    req, experts = work.moe_expected(m, 128)
    assert req == pytest.approx(23 * 128 * 6 * 32 / 128)
    assert experts == pytest.approx(23 * 32 * (1 - (1 - 1 / 128) ** 768))
    step = work.decode_step(m, [1000] * 128)
    pre = work.prefill(m, 1000)
    assert step.bytes > 0.5 * 2 * 2688 * 1856 * 2 * experts and step.flops > 0
    assert pre.flops > 2 * 1000 * work.dense_params(m)
    assert work.decode_step(m, []).bytes == 0
    # the smoke widths count too, and the configuration names this module
    # and the reference as its own
    assert work.moe_expected(FILE["smoke"], 8)[1] == pytest.approx(2 * 8 * (1 - (1 - 1 / 32) ** 48))
    assert FILE["counts"] == "least_work/nemotron_h.py"
    assert FILE["reference"] == "reference/nemotron_h.py"


#: How a traced run's breakdown names the grouped expert products.
GROUPED_OP = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6"
              "kernel13GemmUniv")


def _moe_run(device_ops, counts_module=work):
    from types import SimpleNamespace

    from portbench.engine import DecodeRec, PrefillRec
    from portbench.tracing import TraceData

    decodes = [DecodeRec(0, 0.5, 0.6, (7,) * 128, (7,) * 128, False),
               DecodeRec(0, 1.0, 1.1, (9,) * 128, (9,) * 128, True)]
    prefills = [PrefillRec(0, 1.2, 1.4, 1000, True)]
    trace = TraceData(window_s=1.0, busy_s=0.5, device_ops=device_ops, idle_gaps=[],
                      kernels={}, pads_lost=0)
    return SimpleNamespace(model=FILE["model"], counts=counts_module, trace=trace,
                           rec=SimpleNamespace(decodes=decodes, prefills=prefills))


@pytest.fixture
def span_log(monkeypatch):
    p = PhaseProfiler(log_size=metrics.LOG_SIZE)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    return p


def _moe_reader():
    return harness.reader(REPO / "portbench", "moe_roofline_pct")


def test_moe_roofline_reads_the_profiled_steps_counts(span_log):
    """The least time of the requests and experts the profiled steps' spans
    say, over the grouped kernel's device time; the unprofiled step's span
    is not counted."""
    span_log.record("serving.decode", 0.51, 0.59, moe_requests=1, moe_experts=1)
    span_log.record("serving.decode", 1.01, 1.09, moe_requests=800, moe_experts=400)
    span_log.record("serving.prefill", 1.21, 1.39, moe_requests=5000, moe_experts=700)
    run = _moe_run([("elementwise", 0.5), (GROUPED_OP, 0.02)])
    want = 100.0 * work.expert_work(FILE["model"], 5800, 1100).least_seconds / 0.02
    assert _moe_reader()(run) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


def test_moe_roofline_counts_at_the_expectation_without_spans(span_log):
    run = _moe_run([(GROUPED_OP, 0.03)])
    req = work.moe_expected(FILE["model"], 128)[0] + work.moe_expected(FILE["model"], 1000)[0]
    exp = work.moe_expected(FILE["model"], 128)[1] + work.moe_expected(FILE["model"], 1000)[1]
    want = 100.0 * work.expert_work(FILE["model"], req, exp).least_seconds / 0.03
    assert _moe_reader()(run) == pytest.approx(want, rel=1e-12)


def test_moe_roofline_reads_nothing_without_the_kernel_or_the_counts(span_log, capsys):
    from portbench import counts

    assert _moe_reader()(_moe_run([("elementwise", 0.5)])) is None
    assert "no grouped expert kernel" in capsys.readouterr().err
    assert _moe_reader()(_moe_run([(GROUPED_OP, 0.02)], counts_module=counts)) is None
