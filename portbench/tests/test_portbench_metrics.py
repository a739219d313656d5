"""The metric arithmetic: rates over the whole window, percentiles over all
samples, shares that stay at or under 100%, and the trace's reduction."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import counts, harness, stats, tracing, traffic
from portbench.engine import DecodeRec, PrefillRec, Recorder, Span, Track

ROOT = Path(__file__).resolve().parents[2]
MIX = traffic.load_mix(ROOT / "portbench" / "traffic" / "chat-tiered.json")
HYMBA = json.loads((ROOT / "portbench" / "configs" / "hymba-1.5b.json").read_text())["model"]


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(q).exponential(size=257))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def _rec():
    """A window [100, 110]: one request submitted before it, two inside it,
    one after it; stamps inside and outside."""
    rec = Recorder()
    rec.t_open, rec.deadline = 100.0, 110.0

    class R:
        def __init__(self, rid):
            self.rid, self.output, self.prompt = rid, [], [1]

    rec.tracks = {
        0: Track(0, 0, R(0), None, [99.0, 101.0, 103.0]),  # set-up request
        1: Track(0, 1, R(1), 102.0, [102.5, 104.0, 106.0, 111.0]),
        2: Track(1, 0, R(2), 109.0, [109.5]),
        3: Track(0, 1, R(3), 108.0, [112.0]),  # answered after the window
        4: Track(0, 2, R(4), 111.0, [111.5]),
    }
    return rec


def test_end_to_end_counts_the_whole_window():
    e2e = harness.end_to_end(_rec(), 10.0)
    # tokens inside [100, 110]: 101, 103 | 102.5, 104, 106 | 109.5
    assert e2e["tokens"] == 6 and e2e["output_tok_s"] == 0.6
    # answered: submitted and first token inside the window: 0.5 s and 0.5 s
    assert e2e["answered"] == 2 and e2e["submitted"] == 3
    assert e2e["ttft_p90_ms"] == pytest.approx(500.0)
    assert e2e["ttft_p50_ms"] == pytest.approx(500.0) and e2e["ttft_mean_ms"] == pytest.approx(500.0)
    # gaps with both stamps inside: 2.0 | 1.5, 2.0
    assert e2e["itl_samples"] == 3
    assert e2e["itl_p95_ms"] == pytest.approx(stats.percentile([2.0, 1.5, 2.0], 95) * 1e3)


def _run(trace=None, h2d=(0, 0.0)):
    rec = _rec()
    rec.admits = [Span(0, 99.0, 100.5), Span(1, 102.0, 103.0), Span(0, 109.0, 111.0)]
    rec.tick_starts = [99.0, 102.0, 109.0]
    rec.decodes = [DecodeRec(0, 100.5, 102.0, (10, 20), (10, 20), False),
                   DecodeRec(0, 103.0, 109.0, (11, 21), (11, 21), False),
                   DecodeRec(0, 111.0, 112.0, (12, 22), (12, 22), True)]
    rec.prefills = [PrefillRec(0, 102.0, 102.6, 100, False),
                    PrefillRec(0, 111.0, 111.4, 900, True)]
    return harness.RunData(model=HYMBA, counts=counts, mix=MIX, t_open=100.0, t_close=110.0,
                           t_return=111.0, rec=rec, h2d_bytes=h2d[0], h2d_seconds=h2d[1],
                           trace=trace)


def _read(name, run):
    return harness.reader(ROOT / "portbench", name)(run)


def test_span_metrics_by_hand():
    run = _run()
    # engine spans inside the window: 0.5 + 1.5 + 1.0 + 6.0 + 1.0 = 10.0 s
    # ticks started inside it: 102 and 109
    assert _read("cluster_self_ms_per_tick", run) == pytest.approx(0.0)
    assert _read("decode_step_ms", run) == pytest.approx((1.5 + 6.0) / 2 * 1e3)
    assert _read("prefill_share_pct", run) == pytest.approx(100 * (0.5 + 1.0 + 1.0) / 10)
    assert _read("h2d_gb_s", run) is None and _read("h2d_share_pct", run) is None
    run = _run(h2d=(int(50e9), 2.2))
    assert _read("h2d_gb_s", run) == pytest.approx(50e9 / 2.2 / 1e9)
    assert _read("h2d_share_pct", run) == pytest.approx(100 * 2.2 / 11.0)
    # nothing traced: the device metrics read nothing
    for name in ("k1_roofline_pct", "k4_roofline_pct", "device_idle_pct"):
        assert _read(name, run) is None


def test_host_copies_are_left_to_the_host_tier():
    """A host engine's ``step_params`` wall inside a decode step or a
    prefill counts for neither the engine's nor the model step's metrics."""
    plain = _run()
    run = _run()
    rec = run.rec
    rec.decodes = [dataclasses.replace(d, staged=0.5) for d in rec.decodes]
    rec.prefills = [dataclasses.replace(p, staged=0.2) for p in rec.prefills]
    # copies inside the admits at 102..103 (in the window) and 109..111
    # (half in it)
    rec.stagings = {"prefill": [Span(1, 102.1, 102.3), Span(0, 109.5, 110.5)],
                    "decode": [Span(0, 100.5, 101.0), Span(0, 103.0, 103.5)]}
    assert _read("decode_step_ms", run) == pytest.approx((1.0 + 5.5) / 2 * 1e3)
    assert _read("prefill_share_pct", run) == pytest.approx(100 * (2.5 - 0.2 - 0.5) / 10)
    least = counts.decode_step(HYMBA, (10, 20)).least_seconds + \
        counts.decode_step(HYMBA, (11, 21)).least_seconds
    assert _read("decode_mfu_pct", run) == pytest.approx(100 * least / 6.5)
    assert _read("decode_mfu_pct", run) > _read("decode_mfu_pct", plain)
    assert _read("prefill_mfu_pct", run) == pytest.approx(
        100 * counts.prefill(HYMBA, 100).least_seconds / 0.4)
    # the cluster's own time is what no engine call covered, copies included
    assert _read("cluster_self_ms_per_tick", run) == _read("cluster_self_ms_per_tick", plain)


class _Event:
    """A CUDA event that has ended, at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class _Offloader:
    """``HostOffloader`` as a host engine on the card uses it: every
    device-ward copy leaves a (start, end) event pair, here 7.5 ms apart,
    and returns at once."""

    COPY_MS = 7.5

    def __init__(self):
        self._timings = []
        self.bytes_to_device = 0

    def to_device(self, tree, out=None):
        self._timings.append((_Event(0.0), _Event(self.COPY_MS)))
        return out

    def block(self):
        pass

    def copy_seconds(self):
        return sum(s.elapsed_time(e) for s, e in self._timings) / 1e3


def test_a_host_copy_is_charged_its_device_time():
    """A host engine's ``step_params`` issues its copy and returns; the step
    waits for the copy on the device.  So each decode step and prefill of
    the engine is charged the copy's device time from its events, not the
    host's issue time, and each staging span lasts that long."""
    from portbench.tests.smoke import rehearse, smoke_cell

    engines = []

    def host_tier(engs):
        for eng in engs:
            eng.offloader, eng._staging = _Offloader(), eng.params
        engines.extend(engs)

    res = rehearse(smoke_cell("mamba2-host-chat"), faults=host_tier)
    assert res["correct"], res["info"]["why_not_correct"]
    rec = engines[0].rec
    copy_s = _Offloader.COPY_MS / 1e3
    assert rec.decodes and rec.prefills
    assert all(d.staged == pytest.approx(copy_s) for d in rec.decodes)
    assert all(p.staged == pytest.approx(copy_s) for p in rec.prefills)
    assert len(rec.stagings["decode"]) == len(rec.decodes)
    assert len(rec.stagings["prefill"]) == len(rec.prefills)
    for s in rec.stagings["decode"] + rec.stagings["prefill"]:
        assert s.t1 - s.t0 == pytest.approx(copy_s)
    assert len(engines[0].offloader._timings) == len(rec.decodes) + len(rec.prefills)


def test_roofline_shares_stay_under_100():
    run = _run()
    assert 0 < _read("decode_mfu_pct", run) <= 100
    assert 0 < _read("prefill_mfu_pct", run) <= 100
    # a trace whose kernels took exactly the least time reads 100%
    k1 = sum(counts.k1_call(counts.k1_keys(HYMBA, (12, 22), MIX.max_len, w), 25, 5, 64).least_seconds
             for _, w in counts.attn_layers(HYMBA))
    k4 = 32 * counts.k4_call(900, 50, 64, 16).least_seconds
    trace = tracing.TraceData(window_s=1.0, busy_s=0.25, device_ops=[], idle_gaps=[],
                              kernels={"decode_attention_kernel": (k1, 32),
                                       "ssd_chunk_kernel": (k4, 32)}, pads_lost=0)
    run = _run(trace=trace)
    assert _read("k1_roofline_pct", run) == pytest.approx(100.0)
    assert _read("k4_roofline_pct", run) == pytest.approx(100.0)
    assert _read("device_idle_pct", run) == pytest.approx(75.0)
    # a trace that lost calls reads nothing rather than a share too high
    trace.kernels["decode_attention_kernel"] = (k1 / 2, 16)
    assert _read("k1_roofline_pct", run) is None


def _ev(name, cat, ts, dur, ph="X"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": ph}


def test_reduce_trace_by_hand():
    events = [_ev("spin_kernel", "kernel", 0, 10), _ev("spin_kernel", "kernel", 10, 10),
              _ev("engine.decode", "user_annotation", 5, 60),
              _ev("void decode_attention_kernel<bf16, 64>", "kernel", 20, 10),
              _ev("gemv", "kernel", 25, 10),  # overlaps: busy 20..35
              _ev("Memcpy HtoD", "gpu_memcpy", 50, 5),
              _ev("engine.prefill", "user_annotation", 66, 24),
              _ev("ssd_chunk_kernel<bf16, true>", "kernel", 80, 10),
              _ev(tracing.END_MARK, "user_annotation", 100, 0)]
    t = tracing.reduce_trace(events)
    assert t.window_s == pytest.approx(80e-6)  # 20..100
    assert t.busy_s == pytest.approx(30e-6)  # 20..35, 50..55, 80..90
    assert t.kernels["decode_attention_kernel"] == (pytest.approx(10e-6), 1)
    assert t.kernels["ssd_chunk_kernel"] == (pytest.approx(10e-6), 1)
    # gaps: 35..50 (decode), 55..80 (mid 67.5: prefill), 90..100 (none)
    assert [g[0] for g in t.idle_gaps] == ["engine.prefill", "engine.decode", "cluster.control"]
    assert t.idle_gaps[0][1] == pytest.approx(25e-6)
    assert t.pads_lost == tracing.PAD_KERNELS - 2
    assert t.device_ops[0][1] == pytest.approx(10e-6)
    with pytest.raises(RuntimeError):
        tracing.reduce_trace([_ev("spin_kernel", "kernel", 0, 1)])
