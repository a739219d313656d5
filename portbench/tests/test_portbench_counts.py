"""counts.py against bytes and operations worked by hand at hymba-1.5b's and
mamba2-2.7b's widths, and against the port's own parameter tree."""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


HYMBA, MAMBA2 = _model("hymba-1.5b"), _model("mamba2-2.7b")


def test_param_bytes_by_hand():
    # hymba, a layer: products 1600*64*(50+10) + 3*1600*5504 + 1600*6482
    # + 3200*1600 = 48,054,400 weights in bf16; two norms; conv (4 x 3232),
    # conv bias 3232 and gated norm 3200 in bf16; A_log, D, dt_bias 3 x 50 f32.
    layer = 48_054_400 * 2 + 2 * 1600 * 2 + (4 * 3232 + 3232 + 3200) * 2 + 3 * 50 * 4
    assert layer == 96_154_520
    assert counts.param_bytes(HYMBA) == 32 * layer + 32001 * 1600 * 2 + 1600 * 2 == 3_179_351_040
    layer = (2560 * 10576 + 5120 * 2560) * 2 + (4 * 5376 + 5376 + 5120) * 2 + 80 * 3 * 4 + 2560 * 2
    assert counts.param_bytes(MAMBA2) == 64 * layer + 50280 * 2560 * 2 + 2560 * 2 == 5_405_189_120


@pytest.mark.parametrize("name", ["hymba-1.5b", "mamba2-2.7b"])
def test_param_bytes_match_the_port(name):
    from repro_torch.models.transformer import param_shapes

    from portbench.harness import model_config

    m = _model(name)

    def total(tree):
        return sum(total(v) if isinstance(v, dict) else math.prod(v[0]) * v[1].itemsize
                   for v in tree.values())

    assert counts.param_bytes(m) == total(param_shapes(model_config(m)))


def test_k1_call_by_hand():
    # two slots at hymba's decode shape, 1024 and 23 kept rows: K and V rows
    # 2 x 1047 x 5 heads x 64 x 2 B, q and out 2 x 2 x 25 x 64 x 2 B, lengths
    w = counts.k1_call([1024, 23], 25, 5, 64)
    assert w.bytes == 2 * 1047 * 5 * 64 * 2 + 2 * 2 * 25 * 64 * 2 + 8 == 1_352_968
    assert w.flops == 4 * 1047 * 25 * 64 == 6_700_800
    assert w.bound_by == "bytes"
    assert w.least_seconds == pytest.approx(1_352_968 / 3.35e12)


def test_k1_keys_follow_window_and_cache():
    assert counts.k1_keys(HYMBA, [0, 10, 1500, 5000], 1152, 1024) == [1, 11, 1024, 1024]
    assert counts.k1_keys(HYMBA, [1500, 5000], 1152, 1 << 30) == [1152, 1152]


def test_k4_call_by_hand():
    # mamba2, 1000 steps: x and y 80 x 64 bf16 each, dt 80 f32, B and C 128
    # bf16 each, a step; the final state 80 x 64 x 128 f32; a 80 f32.
    w = counts.k4_call(1000, 80, 64, 128)
    assert w.bytes == 1000 * (2 * 80 * 64 * 2 + 80 * 4 + 2 * 128 * 2) + 80 * 64 * 128 * 4 + 320
    assert w.bytes == 23_933_760
    assert w.flops == 4 * 1000 * 80 * 64 * 128
    w = counts.k4_call(100, 50, 64, 16)  # hymba's heads
    assert w.bytes == 100 * (2 * 50 * 64 * 2 + 50 * 4 + 2 * 16 * 2) + 50 * 64 * 16 * 4 + 200


def test_windows_and_pairs():
    ws = counts.windows(HYMBA)
    assert [i for i, w in enumerate(ws) if w == counts.FULL_WINDOW] == [0, 16, 31]
    assert set(ws) == {1024, counts.FULL_WINDOW}
    assert counts.causal_pairs(4, 100) == 10
    assert counts.causal_pairs(5, 2) == 3 + 3 * 2
    assert counts.attn_layers(MAMBA2) == []


def test_decode_step_by_hand():
    # mamba2, 3 active slots: every weight once, 3 logit rows, each slot's
    # SSM state (80 x 64 x 128 f32) and conv state (3 x 5376 bf16) read and
    # written in 64 layers.
    w = counts.decode_step(MAMBA2, [10, 20, 30])
    state, conv = 80 * 64 * 128 * 4, 3 * 5376 * 2
    assert w.bytes == 5_405_189_120 + 3 * 50280 * 2 + 3 * 64 * 2 * (state + conv)
    assert w.flops == 2 * 3 * (40_181_760 * 64 + 50280 * 2560) + 4 * 3 * 80 * 64 * 128 * 64
    assert w.bound_by == "bytes"
    assert counts.decode_step(MAMBA2, []) == counts.ZERO
    # hymba, one slot of 2000 tokens: 29 windowed layers keep 1024 rows and
    # 3 full ones 2001; 1280 B a row (K and V, 5 heads x 64, bf16).
    h = counts.decode_step(HYMBA, [2000])
    rows = 29 * 1024 + 3 * 2001
    ssm = 32 * (2 * 50 * 64 * 16 * 4 + 2 * 3 * 3232 * 2)
    assert h.bytes == 3_179_351_040 + 32001 * 2 + rows * 1280 + ssm
    assert h.flops == (2 * (48_054_400 * 32 + 32001 * 1600) + 4 * rows * 25 * 64
                       + 4 * 50 * 64 * 16 * 32)


def test_prefill_is_flop_bound_when_long():
    short, long = counts.prefill(HYMBA, 64), counts.prefill(HYMBA, 4096)
    assert short.bound_by == "bytes" and long.bound_by == "flops"
    assert long.flops > 2 * 4096 * 48_054_400 * 32


def test_share_never_divides_by_zero():
    with pytest.raises(ValueError):
        counts.share_pct(1.0, 0.0)
    assert counts.share_pct(1.0, 4.0) == 25.0


def test_peaks_are_the_data_sheet():
    assert counts.PEAK_BF16_FLOPS == 989e12 and counts.PEAK_HBM_BYTES == 3.35e12
    assert torch.finfo(torch.bfloat16).bits == 8 * counts.BF16
