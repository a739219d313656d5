"""The readers of the program's own spans (``program_span``): on a smoke
cluster on the CPU each reads a positive number from a window that holds
its spans, and nothing from an empty window, from a log that dropped
records inside the window, or from a program that keeps no span log."""

import json
from pathlib import Path

import pytest
import torch

from portbench import counts, harness, traffic
from portbench.engine import Recorder, clock

ROOT = Path(__file__).resolve().parents[2]
MIX = traffic.load_mix(ROOT / "portbench" / "traffic" / "chat-tiered.json")
HYMBA = json.loads((ROOT / "portbench" / "configs" / "hymba-1.5b.json").read_text())["model"]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("queue_wait_p90_ms", "miku_ms_per_tick", "miku_us_per_window", "decode_dispatch_ms")
#: Every reader of the program's spans that reads a positive number there.
SPAN_READERS = READERS + ("host_decode_dispatch_ms",)


@pytest.fixture
def prof(monkeypatch):
    """A fresh process-default span log."""
    from repro_torch.obs import metrics

    p = metrics.PhaseProfiler(log_size=metrics.LOG_SIZE)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    return p


def _window(t_open, t_close):
    return harness.RunData(model=HYMBA, counts=counts, mix=MIX, t_open=t_open,
                           t_close=t_close, t_return=t_close, rec=Recorder(), h2d_bytes=0,
                           h2d_seconds=0.0,
                           trace=None)


def _served():
    """A MIKU cluster of a device and a host engine whose requests are all
    submitted inside the window, more of them than slots, so some wait."""
    from repro_torch.launch.serve import build_cluster
    from repro_torch.serving.engine import Request

    torch.set_num_threads(1)
    cluster = build_cluster("llama31-8b", n_requests=0, max_new=4, device="cpu")
    t_open = clock()
    for eng in cluster.engines:
        for rid in range(7):
            eng.submit(Request(rid=rid, prompt=list(range(1, 9)), max_new_tokens=4))
    cluster.run()
    return t_open, clock()


def _read(name, run):
    return harness.reader(ROOT / "portbench", name)(run)


def test_the_four_entries_read_the_programs_spans():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(READERS) <= set(entries)
    for name in READERS:
        assert entries[name]["source"] == "program_span"
    for name in READERS[:3]:
        assert "workloads" not in entries[name]
    # the dispatch reader reads a device-placed engine's steps, which only
    # the tiered cells have; a host engine's are read apart, in every cell
    assert entries["decode_dispatch_ms"]["workloads"] == ["hymba-tiered-chat",
                                                          "mamba2-tiered-chat"]
    assert entries["host_decode_dispatch_ms"]["workloads"] == [w["name"]
                                                               for w in BENCH["workloads"]]
    assert entries["miku_us_per_window"]["unit"] == "us"
    assert entries["queue_wait_p90_ms"]["moves"] == "ttft_p90_ms"


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_reads_a_window_with_its_spans(prof, name):
    t_open, t_close = _served()
    value = _read(name, _window(t_open, t_close))
    assert value is not None and value > 0
    # an empty window reads nothing
    assert _read(name, _window(t_close + 1.0, t_close + 2.0)) is None


def test_readers_by_hand(prof):
    """Each reader against the log, summed by hand."""
    t_open, t_close = _served()
    run = _window(t_open, t_close)
    spans = [r for r in prof.log if t_open <= r.t0 <= t_close]
    waits = sorted(r.t1 - r.t0 for r in spans if r.name == "serving.queued")
    assert len(waits) == 14 and waits[-1] > 0
    from portbench import stats

    assert _read("queue_wait_p90_ms", run) == pytest.approx(stats.percentile(waits, 90) * 1e3)
    queue = [r for r in spans if r.name in ("serving.advance", "serving.idle_advance")]
    ticks = sum(1 for r in spans if r.name == "serving.tick")
    busy = sum(r.t1 - r.t0 for r in queue)
    assert _read("miku_ms_per_tick", run) == pytest.approx(busy / ticks * 1e3)
    windows = sum(r.args["windows"] for r in queue)
    assert _read("miku_us_per_window", run) == pytest.approx(busy / windows * 1e6)
    # the device engine's steps, and apart from them the host engine's
    every = 0
    for name, placement in (("decode_dispatch_ms", "device"),
                            ("host_decode_dispatch_ms", "host")):
        decode = {r.sid: r for r in spans
                  if r.name == "serving.decode" and r.args["placement"] == placement}
        steps = [r.t1 - r.t0 for r in spans
                 if r.name == "serving.decode.dispatch" and r.parent in decode]
        assert steps and len(steps) == len(decode)
        assert _read(name, run) == pytest.approx(sum(steps) / len(steps) * 1e3)
        # the dispatch is part of its step
        assert sum(steps) < sum(r.t1 - r.t0 for r in decode.values())
        every += len(steps)
    assert every == sum(1 for r in spans if r.name == "serving.decode.dispatch")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_reads_nothing_after_drops_inside_the_window(monkeypatch, name):
    from repro_torch.obs import metrics

    p = metrics.PhaseProfiler(log_size=64)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    t_open, t_close = _served()
    assert p.dropped > 0 and p.dropped_until >= t_open
    assert _read(name, _window(t_open, t_close)) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_reads_nothing_from_a_program_without_a_span_log(prof, monkeypatch, name):
    """A tree whose ``repro_torch.obs`` has no ``default_profiler`` (the
    benchmark runs its readers on the parent's program too)."""
    import repro_torch.obs

    t_open, t_close = _served()
    monkeypatch.delattr(repro_torch.obs, "default_profiler")
    assert _read(name, _window(t_open, t_close)) is None
