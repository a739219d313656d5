"""One run of one cell: build the cluster from the port's public classes,
fill it, measure a window, check the outputs, reduce the metrics.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its configuration,
traffic mix, per-layer metric readers and limits are files found by name,
and the configuration names its reference and least-work modules by path
(see :mod:`portbench`).  The cluster is built as ``launch/serve.py``'s
``build_cluster`` builds it (the same ``EngineConfig`` fields, and under
MIKU the same ``MikuController``, estimator settings and ``window_ns``), with
the benchmark's own traffic and :class:`portbench.engine.TimedEngine`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import check, stats, traffic
from portbench.engine import Recorder, TimedEngine, clock
from portbench.tracing import SubWindow
from portbench.weights import make_weights

#: Top-level module names that may not be loaded when a run ends.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    model: Dict[str, Any]  # ModelConfig fields, dtype a string
    mix: traffic.Mix
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    data_dir: Path  # the benchmark's folder: traffic/, limits/, metrics/
    reference: ModuleType  # the configuration's ``logits(m, weights, tokens, positions, ...)``
    counts: ModuleType  # its ``decode_step``, ``prefill`` and ``k4_calls``
    smoke: Dict[str, Any]  # its CPU smoke widths, ModelConfig fields
    weight_rules: Dict[str, Any]  # its scale rules (portbench.weights)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, found
    by name under ``root/portbench``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    raw = json.loads((root / conf["file"]).read_text())
    data = Path(root) / "portbench"
    mix = traffic.load_mix(data / "traffic" / f"{w['traffic']}.json")
    limits = json.loads((data / "limits" / f"{name}.json").read_text())["limits"]
    key = w["config"].replace(".", "_").replace("-", "_")
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], model=raw["model"],
                mix=mix, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], data_dir=data,
                reference=load_module(data / raw["reference"], f"portbench.config.{key}.reference"),
                counts=load_module(data / raw["counts"], f"portbench.config.{key}.counts"),
                smoke=raw["smoke"], weight_rules=raw.get("weights", {}))


def model_config(model: Dict[str, Any]):
    from repro_torch.models.transformer import ModelConfig

    fields = dict(model)
    fields["dtype"] = getattr(torch, fields.get("dtype", "bfloat16"))
    return ModelConfig(**fields)


def load_module(path: Path, name: str) -> ModuleType:
    """The module of the file ``path``, loaded by path and registered as
    ``name`` (a dataclass looks its module up while it is made)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(data_dir: Path, name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module(data_dir / "metrics" / f"{name}.py", f"portbench.metrics.{name}").read


@dataclasses.dataclass
class RunData:
    """What a per-layer metric reader reads."""

    model: Dict[str, Any]
    counts: ModuleType  # the configuration's least-work module
    mix: traffic.Mix
    t_open: float
    t_close: float  # the window's end (its deadline)
    t_return: float  # when the cluster's run returned
    rec: Recorder
    h2d_bytes: int  # the program's counters, deltas over [t_open, t_return]
    h2d_seconds: float
    trace: Any  # tracing.TraceData or None

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close


def _controller(mix: traffic.Mix, weights: Dict):
    if not mix.miku:
        return None
    from repro_torch.core.controller import MikuConfig, MikuController
    from repro_torch.core.littles_law import EstimatorConfig
    from repro_torch.serving.engine import param_bytes

    mk = mix.miku
    chunk_service = param_bytes(weights) / mk["stream_chunks"] / mk["host_link_bytes_per_ns"]
    return MikuController(
        MikuConfig(levels=tuple(mk["levels"])),
        EstimatorConfig(t_fast=mk["t_fast"],
                        slow_read_threshold=mk["slow_read_chunks"] * chunk_service,
                        min_window_inserts=mk["min_window_inserts"],
                        min_slow_inserts=mk["min_slow_inserts"]))


def _h2d(engines) -> tuple:
    """(bytes, device seconds) of every host engine's device-ward copies."""
    offs = [e.offloader for e in engines if e.offloader is not None]
    return sum(o.bytes_to_device for o in offs), sum(o.copy_seconds() for o in offs)


def end_to_end(rec: Recorder, seconds: float) -> Dict[str, Any]:
    """The window's rates and tails over all its work and samples."""
    tokens = sum(1 for t in rec.tracks.values() for s in t.stamps if rec.in_window(s))
    ttft = [t.stamps[0] - t.t_submit for t in rec.tracks.values()
            if rec.in_window(t.t_submit) and t.stamps and rec.in_window(t.stamps[0])]
    itl = [b - a for t in rec.tracks.values() for a, b in zip(t.stamps, t.stamps[1:])
           if rec.in_window(a) and rec.in_window(b)]
    submitted = sum(1 for t in rec.tracks.values() if rec.in_window(t.t_submit))
    out = {"output_tok_s": tokens / seconds, "tokens": tokens, "submitted": submitted,
           "answered": len(ttft), "itl_samples": len(itl)}
    if ttft:
        out["ttft_p50_ms"] = stats.percentile(ttft, 50) * 1e3
        out["ttft_p90_ms"] = stats.percentile(ttft, 90) * 1e3
        out["ttft_mean_ms"] = sum(ttft) / len(ttft) * 1e3
    if itl:
        out["itl_p95_ms"] = stats.percentile(itl, 95) * 1e3
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: torch.device,
             t_start: float, control: bool = False, faults: Optional[Callable] = None
             ) -> Dict[str, Any]:
    """One run; returns the result object (without the import check).
    ``faults(engines)``, for tests only, breaks the timed path underneath."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.serving.engine import EngineConfig, TieredServingCluster

    cfg = model_config(cell.model)
    mix = cell.mix
    weights = make_weights(param_shapes(cfg), seed, device, cell.weight_rules)
    sub = SubWindow() if trace else None
    rec = Recorder(profiler=sub)
    engines: List[TimedEngine] = []
    for i, spec in enumerate(mix.engines):
        pool = traffic.ClientPool(mix, i, cfg.vocab, seed)
        eng = TimedEngine(
            EngineConfig(name=spec.name, model=cfg, max_slots=spec.slots, max_len=mix.max_len,
                         placement=spec.placement,
                         stream_chunks=mix.miku["stream_chunks"] if mix.miku else None),
            weights, index=i, rec=rec, next_request=pool.next)
        for s in pool.warmup():
            eng.submit_spec(s, None)
        engines.append(eng)
    if faults is not None:
        faults(engines)
    cluster = TieredServingCluster(engines, controller=_controller(mix, weights),
                                   window_ns=mix.window_ns)
    # The warm-up fill: every slot prefilled, then one decode step each, so
    # every kernel is built and loaded before the window.
    for eng in engines:
        eng.admit(0.0)
    for eng in engines:
        eng.decode_once(0.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    b0, s0 = _h2d(engines)
    t_open = rec.open(seconds)
    setup_s = t_open - t_start
    cluster.run(max_ticks=1 << 62)
    t_return = clock()
    b1, s1 = _h2d(engines)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e = end_to_end(rec, seconds)
    e2e["setup_s"] = setup_s
    numbers: Dict[str, float] = {}
    staged = [e for e in engines if e.offloader is not None]
    staged_any = bool(staged)
    if staged:
        numbers["staged_weight_diff"] = max(check.staged_weight_diff(e._staging, weights)
                                            for e in staged)
    picked = check.sample(list(rec.tracks.values()), len(engines), seed, rec.in_window)
    data = RunData(model=cell.model, counts=cell.counts, mix=mix, t_open=t_open,
                   t_close=rec.deadline, t_return=t_return, rec=rec, h2d_bytes=b1 - b0,
                   h2d_seconds=s1 - s0, trace=sub.data if sub else None)
    # The program's state goes before the reference runs.
    del cluster, engines, staged, eng, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    numbers.update(check.logit_gaps(cell.reference, cell.model, weights, picked,
                                    control=control))
    ref_s = clock() - t_ref
    # A host-placed engine stages its weights only on a CUDA card.
    limits = {k: v for k, v in cell.limits.items() if k != "staged_weight_diff" or staged_any}
    why = check.verdict(numbers, limits)
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = reader(cell.data_dir, m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {
        "correct": why is None, "attempted": e2e["submitted"], "failed": 0,
        "metrics": metrics, "device": dev}
    if trace and data.trace is not None:
        dev["busy_s"] = data.trace.busy_s
        dev["window_s"] = data.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in data.trace.device_ops],
                               "idle_gaps": [list(x) for x in data.trace.idle_gaps]}
    result["info"] = {"tokens": e2e["tokens"], "answered": e2e["answered"],
                      "itl_samples": e2e["itl_samples"], "reference_s": ref_s,
                      "ttft_ms": {k: e2e.get(f"ttft_{k}_ms") for k in ("p50", "p90", "mean")},
                      "tokens_compared": numbers.pop("tokens_compared"),
                      "requests_compared": numbers.pop("requests_compared"),
                      "pads_lost": data.trace.pads_lost if data.trace else None,
                      "why_not_correct": why}
    result["checks"] = {k: {"value": numbers[k], "limit": limits.get(k)} for k in numbers}
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
