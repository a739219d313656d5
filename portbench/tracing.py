"""The device trace of a short steady sub-window, and its reduction.

:class:`SubWindow` runs ``torch.profiler`` (host and device activity) over
the ticks right after a traced run's window closes, the clients still
closing the loop.  It opens on ``PAD_KERNELS`` spin kernels, since a trace
can lose its first records, and the traced window starts where the last of
them ends; it stops after a synchronize.  :func:`reduce_trace` reads the
exported Chrome trace: the device's busy time (the union of kernels, copies
and sets), the device operations that took most time, the longest idle
gaps named by the harness span the host was in (``engine.prefill``,
``engine.decode``, ``host.h2d``, else ``cluster.control``), and each
kernel's device time and launches, by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PAD_KERNELS = 64
PAD_CYCLES = 200_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("engine.prefill", "engine.decode", "host.h2d")
END_MARK = "portbench.end"
PAD_NAME = "spin_kernel"
#: Kernel-name fragments of the port's kernels: K1's split and combine
#: kernels, K4's three stages.
K1_KERNELS = ("decode_attention_kernel", "decode_combine_kernel")
K1_CALL = "decode_attention_kernel"
K4_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_chunk_kernel")
K4_CALL = "ssd_chunk_kernel"
TOP = 10
#: Characters of a device operation's name kept in the breakdown.
NAME_CHARS = 96


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    #: fragment -> (device seconds, events)
    kernels: Dict[str, Tuple[float, int]]
    pads_lost: int

    def kernel_seconds(self, names: Sequence[str]) -> float:
        return sum(self.kernels.get(n, (0.0, 0))[0] for n in names)

    def launches(self, name: str) -> int:
        return self.kernels.get(name, (0.0, 0))[1]


class SubWindow:
    """``start()`` / ``stop()`` around the profiled ticks; ``data`` holds
    the reduction after ``stop()``."""

    def __init__(self) -> None:
        self.prof = None
        self.data: Optional[TraceData] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(PAD_CYCLES)

    def stop(self) -> None:
        torch.cuda.synchronize()
        with torch.profiler.record_function(END_MARK):
            pass
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        self.data = reduce_trace(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_trace(events: List[dict]) -> TraceData:
    """Reduce Chrome-trace events (times in microseconds) to
    :class:`TraceData`; raises if the trace holds no device operation or no
    end mark."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    pads = [e for e in device if PAD_NAME in e.get("name", "")]
    ends = [e["ts"] for e in events if e.get("name") == END_MARK]
    if not ends:
        raise RuntimeError("the trace holds no end mark")
    start = max((e["ts"] + e["dur"] for e in pads), default=None)
    if start is None:
        raise RuntimeError("the trace lost every padding kernel")
    end = ends[-1]
    work = [e for e in device if PAD_NAME not in e.get("name", "")
            and e["ts"] >= start and e["ts"] + e["dur"] <= end]
    if not work:
        raise RuntimeError("no device operation ran in the traced window")
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in work])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for e in work:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host = [e for e in events if e.get("ph") == "X" and e.get("name") in HOST_SPANS]
    gaps = []
    edges = [start] + [x for iv in busy for x in iv] + [end]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(inside, key=lambda e: e["dur"])["name"] if inside else "cluster.control"
        gaps.append((name, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    kernels = {}
    for frag in K1_KERNELS + K4_KERNELS:
        hits = [e for e in work if frag in e["name"]]
        kernels[frag] = (sum(e["dur"] for e in hits) / 1e6, len(hits))
    return TraceData(window_s=(end - start) / 1e6, busy_s=busy_us / 1e6,
                     device_ops=[(name, us / 1e6) for name, us in ops],
                     idle_gaps=gaps[:TOP], kernels=kernels,
                     pads_lost=PAD_KERNELS - len(pads))
