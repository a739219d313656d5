"""The serving path's real-clock spans and counters (``repro_torch.obs``):
a smoke-size MIKU cluster, a device engine beside a host-placed one, on the
CPU.  Every child span lies inside its parent and its siblings do not
overlap; each request is queued once and prefilled once; the registry's
serving counters count the work as it happens; the log keeps its bound and
counts what it drops; under ``torch.profiler`` each span is a range of the
same name with its id as the argument; and a profiler without a log logs
nothing and changes no result."""

import json

import pytest
import torch

from repro_torch.core.offload import HostOffloader
from repro_torch.launch.serve import build_cluster
from repro_torch.obs import metrics
from repro_torch.obs.metrics import PhaseProfiler, default_profiler, default_registry
from repro_torch.serving.engine import Request

torch.set_num_threads(1)

CPU = torch.device("cpu")

#: Each span's parent by name (None: top-level).
PARENTS = {
    "serving.tick": None,
    "serving.idle_advance": None,
    "serving.queued": None,
    "serving.admit": {"serving.tick", None},
    "serving.prefill": {"serving.admit"},
    "serving.prefill.state": {"serving.prefill"},
    "serving.prefill.dispatch": {"serving.prefill"},
    "serving.prefill.readback": {"serving.prefill"},
    "serving.prefill.insert": {"serving.prefill"},
    "serving.h2d": {"serving.prefill", "serving.decode"},
    "serving.decode": {"serving.tick", None},
    "serving.decode.dispatch": {"serving.decode"},
    "serving.decode.readback": {"serving.decode"},
    "serving.decode.retire": {"serving.decode"},
    "serving.account": {"serving.tick"},
    "serving.advance": {"serving.tick"},
}


@pytest.fixture
def prof(monkeypatch):
    """A fresh process-default profiler for the test."""
    p = PhaseProfiler(log_size=metrics.LOG_SIZE)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    assert default_profiler() is p
    return p


def _stage_host_weights(cluster):
    """Give the host-placed engine the weight copy a CUDA card gives it
    (plain copies on the CPU), so its steps run ``step_params``' copy."""
    eng = cluster.engines[1]
    assert eng.cfg.placement == "host" and eng.offloader is None
    eng.offloader = HostOffloader(CPU)
    eng._staging = eng.offloader.to_device(eng.params)


def _cluster(n_requests=6, max_new=5, staged=True):
    cluster = build_cluster("llama31-8b", n_requests=n_requests, max_new=max_new, device="cpu")
    if staged:
        _stage_host_weights(cluster)
    return cluster


def _run(n_requests=6, max_new=5):
    cluster = _cluster(n_requests, max_new)
    return cluster, cluster.run()


def _by_sid(prof):
    return {r.sid: r for r in prof.log}


def test_every_span_nests_in_its_parent(prof):
    _run()
    recs = _by_sid(prof)
    names = {r.name for r in recs.values()}
    assert names == set(PARENTS), names ^ set(PARENTS)
    for r in recs.values():
        assert r.t0 <= r.t1
        want = PARENTS[r.name]
        if r.parent == 0:
            assert want is None or None in want, r
            continue
        parent = recs[r.parent]
        assert parent.name in want, (r.name, parent.name)
        assert parent.t0 <= r.t0 and r.t1 <= parent.t1, (r, parent)


def test_siblings_do_not_overlap(prof):
    _run()
    children = {}
    for r in prof.log:
        children.setdefault(r.parent, []).append(r)
    assert len(children) > 10
    for parent, kids in children.items():
        if parent == 0:  # top-level spans include the queued, which overlap
            kids = [k for k in kids if k.name != "serving.queued"]
        kids.sort(key=lambda r: r.t0)
        for a, b in zip(kids, kids[1:]):
            assert a.t1 <= b.t0, (a, b)


def test_each_request_is_queued_once_and_prefilled_once(prof):
    cluster, _ = _run()
    recs = _by_sid(prof)
    queued = [r for r in recs.values() if r.name == "serving.queued"]
    prefills = [r for r in recs.values() if r.name == "serving.prefill"]
    keys = [(q.args["engine"], q.args["rid"]) for q in queued]
    pkeys = [(recs[p.parent].args["engine"], p.args["rid"]) for p in prefills]
    want = sorted((e.cfg.name, r.rid) for e in cluster.engines for r in e.done)
    assert sorted(keys) == sorted(pkeys) == want
    by_key = dict(zip(pkeys, prefills))
    for q, key in zip(queued, keys):
        pre = by_key[key]
        # the wait ends where the prefill starts
        assert q.t1 == pre.t0 and q.t0 <= q.t1
        assert pre.args["prompt"] == 8
    # every engine's admit says how many it admitted
    admitted = sum(r.args["admitted"] for r in recs.values() if r.name == "serving.admit")
    assert admitted == len(prefills)


def test_step_spans_carry_their_arguments(prof):
    reg = default_registry()
    w0 = reg.counter("control.windows").value
    cluster, _ = _run()
    windows = reg.counter("control.windows").value - w0
    recs = list(prof.log)
    fired = sum(r.args["windows"] for r in recs
                if r.name in ("serving.advance", "serving.idle_advance"))
    assert fired == windows > 0
    ticks = [r.args["tick"] for r in recs if r.name == "serving.tick"]
    assert ticks == sorted(ticks) and len(set(ticks)) == len(ticks)
    decodes = [r for r in recs if r.name == "serving.decode"]
    assert len(decodes) == sum(e.decode_steps for e in cluster.engines)
    assert all(1 <= d.args["active"] <= 4 for d in decodes)
    placement = {e.cfg.name: e.cfg.placement for e in cluster.engines}
    assert placement == {"hbm": "device", "host": "host"}
    assert all(d.args["placement"] == placement[d.args["engine"]] for d in decodes)
    # no CUDA graph on the CPU: every step is issued op by op
    assert all(d.args["graph"] is False for d in decodes)
    chunks = {r.args["engine"]: r.args["chunks"] for r in recs if r.name == "serving.account"}
    assert chunks == {"hbm": 0, "host": 64}
    # the host engine's weight copy: one in each of its prefills and steps
    h2d = [r for r in recs if r.name == "serving.h2d"]
    host = cluster.engines[1]
    host_prefills = sum(1 for r in recs if r.name == "serving.admit" and r.args["engine"] == "host"
                        for _ in range(r.args["admitted"]))
    assert len(h2d) == host_prefills + host.decode_steps
    assert {r.args["engine"] for r in h2d} == {"host"}


def test_counters_count_the_work_as_it_happens(prof):
    reg = default_registry()
    names = ("serving.tokens", "serving.requests")
    before = {n: reg.counter(n).value for n in names}
    cluster = _cluster(n_requests=3, max_new=4)
    out = cluster.run()
    mid = {n: reg.counter(n).value for n in names}
    tokens = sum(len(r.output) for e in cluster.engines for r in e.done)
    done = sum(len(e.done) for e in cluster.engines)
    assert mid["serving.tokens"] - before["serving.tokens"] == tokens
    assert tokens == sum(o["tokens"] for o in out.values())
    assert mid["serving.requests"] - before["serving.requests"] == done
    # A second run adds the second run's work only, while its result's
    # totals count every request the engines have finished.
    for e in cluster.engines:
        e.submit(Request(rid=100, prompt=[5, 6, 7], max_new_tokens=3))
    out2 = cluster.run()
    after = {n: reg.counter(n).value for n in names}
    assert after["serving.tokens"] - mid["serving.tokens"] == 2 * 3
    assert after["serving.requests"] - mid["serving.requests"] == 2
    assert sum(o["tokens"] for o in out2.values()) == tokens + 6


def test_a_partial_token_count_before_the_run_ends(prof):
    """Tokens count when they are produced, not when their request ends."""
    reg = default_registry()
    cluster = _cluster(n_requests=2, max_new=6)
    eng = cluster.engines[0]
    t0 = reg.counter("serving.tokens").value
    r0 = reg.counter("serving.requests").value
    eng.admit(0.0)
    assert reg.counter("serving.tokens").value - t0 == 2  # the first tokens
    eng.decode_once(0.0)
    assert reg.counter("serving.tokens").value - t0 == 4
    assert reg.counter("serving.requests").value == r0 and not eng.done


def test_the_log_keeps_its_bound_and_counts_drops():
    p = PhaseProfiler(log_size=8)
    for i in range(20):
        with p.phase("work", i=i):
            pass
    assert len(p.log) == 8 and p.dropped == 12
    assert [r.args["i"] for r in p.log] == list(range(12, 20))
    assert p.calls["work"] == 20  # the sums keep every call
    # the newest dropped record ended where the oldest kept one starts, or before
    assert p.dropped_until <= p.log[0].t0
    assert p.spans(p.log[0].t0, p.log[-1].t1) is not None
    assert p.spans(p.dropped_until, p.log[-1].t1) is None
    # a profiler without a log logs nothing and reads no window
    q = PhaseProfiler()
    with q.phase("work"):
        pass
    assert q.log is None and q.spans(0.0, 1e30) is None and q.calls == {"work": 1}
    assert q.snapshot()["phases"]["work"]["calls"] == 1


def test_a_cluster_run_past_the_bound_drops_its_oldest(monkeypatch):
    p = PhaseProfiler(log_size=32)
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", p)
    _run()
    assert len(p.log) == 32 and p.dropped > 0
    # every call was logged once; the newest 32 are kept, in the order
    # they ended
    assert p.dropped + 32 == sum(p.calls.values())
    assert [r.t1 for r in p.log] == sorted(r.t1 for r in p.log)
    assert p.dropped_until <= p.log[0].t1
    # a window that reaches back to the newest drop reads nothing
    assert p.spans(p.dropped_until, p.log[-1].t1) is None
    assert p.spans(p.log[-1].t0, p.log[-1].t1) is not None


def _user_ranges(path):
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("serving.")),
                  key=lambda e: (e["ts"], -e["dur"]))


@pytest.mark.parametrize("record_shapes", [False, True])
def test_profiler_ranges_mirror_the_spans(prof, tmp_path, record_shapes):
    cluster = _cluster(n_requests=3, max_new=3)
    # spans before the profiler starts have no range
    cluster.engines[0].admit(0.0)
    first = max(r.sid for r in prof.log)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as p:
        cluster.run()
    last = max(r.sid for r in prof.log)
    with prof.phase("serving.after"):  # and after it stops
        pass
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    ranges = _user_ranges(path)
    # ``serving.queued`` spans two calls, so it is logged and has no range
    spans = sorted((r for r in prof.log if first < r.sid <= last and r.name != "serving.queued"),
                   key=lambda r: r.sid)
    assert {r.name for r in spans} == set(PARENTS) - {"serving.queued"}
    assert [e["name"] for e in ranges] == [r.name for r in spans]
    if record_shapes:  # the span id is the range's argument
        assert [e["args"]["Concrete Inputs"] for e in ranges] == [[str(r.sid)] for r in spans]
    for e, r in zip(ranges, spans):
        assert e["dur"] * 1e-6 >= (r.t1 - r.t0) * 0.5 - 1e-4


def test_a_profiler_without_a_log_logs_nothing_and_changes_no_result(prof, monkeypatch):
    cluster, out = _run()
    streams = [[r.output for r in e.done] for e in cluster.engines]
    timeline = list(cluster.timeline)
    calls = dict(prof.calls)
    bare = PhaseProfiler()
    monkeypatch.setattr(metrics, "_DEFAULT_PROFILER", bare)
    cluster2, out2 = _run()
    assert bare.log is None and bare.spans(0.0, 1e30) is None and not bare._open
    assert bare.calls == calls  # the same phases, summed only
    assert out2 == out
    assert [[r.output for r in e.done] for e in cluster2.engines] == streams
    assert list(cluster2.timeline) == timeline
    assert all(not e._submitted for e in cluster2.engines)
