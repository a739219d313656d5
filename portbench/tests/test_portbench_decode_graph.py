"""The reader ``metrics/decode_graph_pct.py``: the share of every engine's
decode steps in the window that replayed the engine's CUDA graph,
by hand on made-up spans, and on a smoke cluster on the CPU, where no step
replays."""

import pytest

from portbench.tests.test_portbench_spans import _read, _served, _window, prof  # noqa: F401


def test_decode_graph_pct_by_hand(prof):
    """A host engine's steps count as a device engine's; steps outside the
    window are left out; nothing from steps that do not say (a program
    without graphs) or from an empty window."""
    for i, graph in enumerate((False, True, True, True)):
        prof.record("serving.decode", 10.0 + i, 10.5 + i, engine="hbm", placement="device",
                    active=3, graph=graph)
    prof.record("serving.decode", 11.2, 11.4, engine="host", placement="host", active=2,
                graph=False)
    prof.record("serving.decode", 20.0, 20.5, engine="hbm", placement="device", active=3,
                graph=False)
    assert _read("decode_graph_pct", _window(9.0, 15.0)) == pytest.approx(60.0)
    assert _read("decode_graph_pct", _window(10.5, 11.1)) == pytest.approx(100.0)
    assert _read("decode_graph_pct", _window(10.5, 15.0)) == pytest.approx(75.0)
    assert _read("decode_graph_pct", _window(15.0, 25.0)) == pytest.approx(0.0)
    assert _read("decode_graph_pct", _window(30.0, 40.0)) is None
    # steps that do not say whether they replayed (the program before graphs)
    prof.record("serving.decode", 50.0, 50.5, engine="hbm", placement="device", active=3)
    assert _read("decode_graph_pct", _window(49.0, 51.0)) is None


def test_decode_graph_pct_reads_nothing_without_a_span_log(monkeypatch):
    from repro_torch.obs import metrics

    p = metrics.PhaseProfiler()
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    p.record("serving.decode", 10.0, 10.5, engine="hbm", placement="device", active=3,
             graph=True)
    assert _read("decode_graph_pct", _window(9.0, 11.0)) is None


def test_decode_graph_pct_on_the_cpu_reads_no_replay(prof):
    """A smoke cluster on the CPU: its engines' steps all run op by op."""
    t_open, t_close = _served()
    assert _read("decode_graph_pct", _window(t_open, t_close)) == 0.0
