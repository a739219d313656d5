"""Today's numbers, pinned: the weights made from a seed, the reference's
logits, the scale of every leaf at the published widths, and the values of
the model-step and K4 readers, for hymba-1.5b and mamba2-2.7b.  The
configuration's own modules (its file's ``reference`` and ``counts``, loaded
by path) and its weight rules must give these to the bit, as the modules
imported directly did before a configuration named them."""

import hashlib
import math
from pathlib import Path

import pytest
import torch

from portbench import counts, harness, tracing, traffic
from portbench.engine import DecodeRec, PrefillRec, Recorder
from portbench.reference import model as reference
from portbench.weights import _leaves, _scale, make_weights

ROOT = Path(__file__).resolve().parents[2]
MIX = traffic.load_mix(ROOT / "portbench" / "traffic" / "chat-tiered.json")
CELL_OF = {"hymba-1.5b": "hymba-tiered-chat", "mamba2-2.7b": "mamba2-tiered-chat"}
SEED = 2**31 + 3

WEIGHTS_SHA256 = {
    "hymba-1.5b": "74c3d021f04c0c9ce5ce0902b98ea2bee8a79cca45940a78d1f3117a3f6aa50e",
    "mamba2-2.7b": "e68c3c1732c4a7ed5db563a0c8ca526f74ef68414ce14064d07e93f3ae5d572c",
}
LOGITS_SHA256 = {  # (float32, the float8 control)
    "hymba-1.5b": ("9e2394e16db32bf0606d6f665b608f63f063e9758f148478d3aeb442bcd1d2ae",
                   "8c19266eb8d4ba83167122e0f8eeca36757510f494c3ce41387af56615aa33a5"),
    "mamba2-2.7b": ("3ee5626e2b17e2a12b2da16b4f09387b6829dabc2cb92b1041e7a07a290d5acd",
                    "bc3b6129ba65ad134270049faca48dea0aabc823db9b61577e724ba97feea4ba"),
}
#: Each bf16 leaf's scale at the published widths.
SCALES = {
    "hymba-1.5b": {
        "embed": 0.02, "final_norm": 0.1, "layers/attn/wk": 0.025, "layers/attn/wo": 0.025,
        "layers/attn/wq": 0.025, "layers/attn/wv": 0.025,
        "layers/mlp/w_down": 0.013479096650429801, "layers/mlp/w_gate": 0.025,
        "layers/mlp/w_up": 0.025, "layers/pre_attn_norm": 0.1, "layers/pre_mlp_norm": 0.1,
        "layers/ssm/conv_b": 0.1, "layers/ssm/conv_w": 0.5, "layers/ssm/in_proj": 0.025,
        "layers/ssm/norm": 0.1, "layers/ssm/out_proj": 0.017677669529663688},
    "mamba2-2.7b": {
        "embed": 0.02, "final_norm": 0.1, "layers/pre_ssm_norm": 0.1, "layers/ssm/conv_b": 0.1,
        "layers/ssm/conv_w": 0.5, "layers/ssm/in_proj": 0.01976423537605237,
        "layers/ssm/norm": 0.1, "layers/ssm/out_proj": 0.013975424859373685},
}
#: decode_mfu_pct, prefill_mfu_pct, k4_roofline_pct on :func:`_run_data`,
#: at the published and at the smoke widths.
READS = {
    ("hymba-1.5b", "model"): (1.3303965652570764, 8.90758237319245, 0.7453982441714633),
    ("mamba2-2.7b", "model"): (3.329659086410515, 14.638346966699357, 2.9183630030149756),
    ("hymba-1.5b", "smoke"): (0.0014136863764566251, 0.013598137134735415,
                              0.007972637646492082),
    ("mamba2-2.7b", "smoke"): (0.00047256280801773615, 0.0012897721497423513,
                               0.003986318823246041),
}
READERS = ("decode_mfu_pct", "prefill_mfu_pct", "k4_roofline_pct")


def _cell(config):
    return harness.load_cell(ROOT, CELL_OF[config])


def _sha(tree):
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(tree)):
        t = leaf.contiguous()
        h.update("/".join(path).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


def _weights(m, rules):
    from repro_torch.models.transformer import param_shapes

    return make_weights(param_shapes(harness.model_config(m)), SEED, torch.device("cpu"), rules)


@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_smoke_weights_are_todays(config):
    cell = _cell(config)
    assert _sha(_weights(cell.smoke, cell.weight_rules)) == WEIGHTS_SHA256[config]


@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_every_leafs_scale_at_the_published_widths_is_todays(config):
    from repro_torch.models.transformer import param_shapes

    cell = _cell(config)
    shapes = param_shapes(harness.model_config(cell.model))
    got = {"/".join(p): _scale(p, s, cell.weight_rules) for p, (s, _) in _leaves(shapes)
           if p[-1] not in ("A_log", "D", "dt_bias")}
    assert got == SCALES[config]


@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_reference_logits_are_todays(config):
    """The configuration's reference, loaded by path, and the module
    imported directly give today's logits, in float32 and float8."""
    cell = _cell(config)
    m = dict(cell.smoke, dtype="float32")
    w = _weights(m, cell.weight_rules)
    tokens = torch.randint(0, m["vocab"], (53,), generator=torch.Generator().manual_seed(1))
    pos = list(range(53))
    for module in (cell.reference, reference):
        for precision, want in zip(("f32", "fp8"), LOGITS_SHA256[config]):
            got = module.logits(m, w, tokens.tolist(), pos, precision=precision)
            assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == want, precision


def _run_data(m, counts_module):
    rec = Recorder()
    rec.t_open, rec.deadline = 100.0, 110.0
    rec.decodes = [DecodeRec(0, 100.5 + i, 100.5 + i + 0.0173 * (i + 1),
                             tuple(range(7 * i, 7 * i + 5 + i)), (), i % 2 == 0, 0.001 * i)
                   for i in range(8)]
    rec.prefills = [PrefillRec(0, 101.0 + i, 101.0 + i + 0.0019 * p ** 0.5, p, i % 2 == 1,
                               0.0003 * i)
                    for i, p in enumerate((1, 17, 300, 1025, 4096))]
    n_pre = sum(1 for p in rec.prefills if p.profiled)
    trace = tracing.TraceData(window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                              kernels={"ssd_chunk_kernel": (0.0123, m["n_layers"] * n_pre),
                                       "ssd_state_kernel": (0.00457, 0),
                                       "ssd_pass_kernel": (0.0011, 0)}, pads_lost=0)
    return harness.RunData(model=m, counts=counts_module, mix=MIX, t_open=100.0, t_close=110.0,
                           t_return=110.5, rec=rec, h2d_bytes=0, h2d_seconds=0.0, trace=trace)


def _old_reads(run):
    """The three readers as they were before a configuration named its
    counts: the yardstick's functions, ``n_layers`` K4 calls a prefill."""
    m = run.model
    steps = [d for d in run.rec.decodes if run.in_window(d.t0)]
    least = sum(counts.decode_step(m, d.active).least_seconds for d in steps)
    decode = counts.share_pct(least, sum(d.t1 - d.t0 - d.staged for d in steps))
    pre = [p for p in run.rec.prefills if run.in_window(p.t0)]
    least = sum(counts.prefill(m, p.plen).least_seconds for p in pre)
    prefill = counts.share_pct(least, sum(p.t1 - p.t0 - p.staged for p in pre))
    d = counts.ssm_dims(m)
    least = sum(m["n_layers"] * counts.k4_call(p.plen, d["n_heads"], d["head_dim"],
                                               d["d_state"]).least_seconds
                for p in run.rec.prefills if p.profiled)
    k4 = counts.share_pct(least, run.trace.kernel_seconds(tracing.K4_KERNELS))
    return decode, prefill, k4


@pytest.mark.parametrize("widths", ["model", "smoke"])
@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_reader_values_are_todays(config, widths):
    cell = _cell(config)
    run = _run_data(getattr(cell, widths), cell.counts)
    new = tuple(harness.reader(cell.data_dir, name)(run) for name in READERS)
    assert new == _old_reads(run) == READS[(config, widths)]


def test_k4_call_counts_b_and_c_per_group():
    one = counts.k4_call(100, 64, 64, 128)
    assert counts.k4_call(100, 64, 64, 128, groups=1) == one
    eight = counts.k4_call(100, 64, 64, 128, groups=8)
    # B and C: 2 x 8 groups x N bf16 elements a token, against 2 x N
    assert eight.bytes - one.bytes == 100 * (16 - 2) * 128 * counts.BF16
    assert eight.flops == one.flops
    m = _cell("mamba2-2.7b").model
    calls = counts.k4_calls(m, 1000)
    assert len(calls) == m["n_layers"] and set(calls) == {counts.k4_call(1000, 80, 64, 128)}
    assert math.fsum(w.least_seconds for w in calls) == \
        m["n_layers"] * counts.k4_call(1000, 80, 64, 128).least_seconds
    assert counts.k4_calls(dict(m, block="dense"), 1000) == []
