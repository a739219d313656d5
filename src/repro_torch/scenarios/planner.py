"""The scenario planner: axis grid -> cells -> jobs -> result table (a copy
of ``repro.scenarios.planner``'s expansion and dispatch).

Grid axes expand in declaration order, row-major, so the port's rows line
up with ``repro.scenarios.run_scenario``'s.  A grid scenario's jobs run in
one sweep, on the batched lane on the port's device or on the scalar DES;
a ``run_cell`` scenario runs cell by cell.  :func:`run_scenario` returns a
:class:`~repro_torch.scenarios.spec.ResultTable`: the rows, the axis
values, what ran them (``meta``), and under ``trace=True`` or
``perfetto=True`` each grid job's per-window records or sampled request
spans, in the reference's schema.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.device_model import PLATFORMS, PlatformModel
from repro_torch.device import resolve_device
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.obs.metrics import PhaseProfiler, default_registry
from repro_torch.scenarios import registry
from repro_torch.scenarios.spec import ResultTable, Scenario

ScenarioRef = Union[str, Scenario]


def _scenario(ref: ScenarioRef) -> Scenario:
    return registry.get(ref) if isinstance(ref, str) else ref


def resolve_platform(value: Any) -> Tuple[str, PlatformModel]:
    """(label, model) for a platform axis value (a name or a model)."""
    if isinstance(value, PlatformModel):
        return value.name, value
    if value in PLATFORMS:
        return value, PLATFORMS[value]
    raise KeyError(f"unknown platform {value!r}; known platforms: "
                   f"{', '.join(PLATFORMS)}")


def resolve_axes(
    scenario: ScenarioRef, overrides: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Axis values for a run: the defaults overlaid with ``overrides``.  A
    string override parses as a ``--set`` token; a scalar on a grid axis
    becomes a one-point grid."""
    sc = _scenario(scenario)
    values: Dict[str, Any] = {a.name: a.default for a in sc.axes}
    for k, v in (overrides or {}).items():
        axis = sc.axis(k)  # raises with the axis list on unknown names
        if isinstance(v, str):
            v = axis.parse_text(v)
        if axis.is_grid:
            v = tuple(v) if isinstance(v, (tuple, list)) else (v,)
        values[k] = v
    return values


def expand_cells(
    scenario: ScenarioRef, values: Dict[str, Any]
) -> List[Dict[str, Any]]:
    """Cartesian product of the grid axes (declaration order, row-major),
    with the scalar axes constant in every cell."""
    sc = _scenario(scenario)
    grid = [a for a in sc.axes if a.is_grid]
    scalars = {a.name: values[a.name] for a in sc.axes if not a.is_grid}
    cells = []
    for combo in itertools.product(*[values[a.name] for a in grid]):
        cell = dict(scalars)
        cell.update({a.name: v for a, v in zip(grid, combo)})
        cells.append(cell)
    return cells


def _resolved_cells(
    sc: Scenario, values: Dict[str, Any]
) -> List[Tuple[Dict[str, Any], Optional[PlatformModel]]]:
    """Each cell's axis values (its platform by label) and platform model
    (None without a platform axis)."""
    out = []
    for cell in expand_cells(sc, values):
        pm: Optional[PlatformModel] = None
        if "platform" in cell:
            label, pm = resolve_platform(cell["platform"])
            cell = {**cell, "platform": label}
        out.append((cell, pm))
    return out


def plan(
    scenario: ScenarioRef, overrides: Optional[Dict[str, Any]] = None
) -> List[Tuple[Dict[str, Any], Optional[PlatformModel], List[SimJob]]]:
    """Expand a grid scenario into (cell, platform, jobs) without running."""
    sc = _scenario(scenario)
    if sc.build is None:
        raise ValueError(f"scenario {sc.name!r} is multi-stage (run_cell); it has "
                         "no static job plan")
    values = resolve_axes(sc, overrides)
    return [(cell, pm, sc.build(pm, cell)) for cell, pm in _resolved_cells(sc, values)]


def _cell_payloads(planned, results, key: str, attr: str) -> List[Dict[str, Any]]:
    """One ``{"cell", "jobs": [{"job", "workloads", key}]}`` entry per cell,
    ``key`` holding each job's ``SimResult.<attr>``."""
    out, i = [], 0
    for cell, _, jobs in planned:
        chunk = results[i:i + len(jobs)]
        i += len(jobs)
        out.append({
            "cell": {k: getattr(v, "value", v) for k, v in cell.items()},
            "jobs": [{"job": j, "workloads": [w.name for w in job.workloads],
                      key: getattr(res, attr)}
                     for j, (job, res) in enumerate(zip(jobs, chunk))],
        })
    return out


def run_scenario(
    scenario: ScenarioRef, overrides: Optional[Dict[str, Any]] = None, device=None, *,
    trace: bool = False, perfetto: bool = False, profile: bool = False,
    lane: str = "batched", processes: Optional[int] = None,
) -> ResultTable:
    """Run a scenario (a name or a :class:`Scenario`) on ``device`` (the card
    unless ``"cpu"``) and return its :class:`ResultTable`.

    A grid scenario's jobs run in one sweep on ``lane``: ``"batched"`` (the
    jobs it cannot stack fall back to the scalar DES), or ``"scalar"``, one
    DES per job on the host over ``processes`` workers.  ``meta["lane"]``
    names the lane; on the batched lane ``meta`` also counts the jobs it
    ran and the fallbacks by reason, counted after the run (a group that
    fails to stack adds its fallbacks during it).  A ``run_cell`` scenario
    runs cell by cell; on the batched lane its ``meta`` says that the lane
    applies to grid scenarios only.

    ``trace=True`` sets ``record_windows`` on every job and fills
    ``traces``: one ``{"cell", "jobs": [{"job", "workloads", "windows"}]}``
    entry per cell.  ``perfetto=True`` traces every 16th ToR admission of
    every job (so each runs on the scalar DES) and fills
    ``request_traces``, the same schema with ``"trace"``
    (``SimResult.trace``) in place of ``"windows"``.  Both are for grid
    scenarios only: a ``run_cell`` scenario raises ``ValueError``.

    ``profile=True`` records the wall-clock phases (plan, sweep and reduce,
    or run_cell) and each scalar job's own profile into
    ``meta["profile"]``, and snapshots the process's metrics registry into
    ``meta["metrics"]``."""
    sc = _scenario(scenario)
    dev = resolve_device(device)
    values = resolve_axes(sc, overrides)
    rows: List[Dict[str, Any]] = []
    traces = req_traces = None
    results: list = []
    prof = PhaseProfiler() if profile else None
    meta: Dict[str, Any] = {"lane": lane}
    if sc.run_cell is not None:
        if trace:
            raise ValueError(f"scenario {sc.name!r} is multi-stage (run_cell); "
                             "per-window decision tracing supports grid scenarios only")
        if perfetto:
            raise ValueError(f"scenario {sc.name!r} is multi-stage (run_cell); "
                             "request-lifecycle tracing supports grid scenarios only")
        if lane == "batched":
            meta = {"lane": "scalar",
                    "note": "multi-stage (run_cell) scenario; the batched "
                            "lane applies to grid scenarios only"}
        t0 = prof.clock() if prof is not None else 0.0
        for cell, pm in _resolved_cells(sc, values):
            rows.extend(sc.run_cell(pm, cell, dev))
        if prof is not None:
            prof.add("run_cell", prof.clock() - t0)
    else:
        t0 = prof.clock() if prof is not None else 0.0
        over: Dict[str, Any] = {}
        if trace:
            over["record_windows"] = True
        if perfetto:
            over["trace"] = 16  # dense enough that a short cell lands spans
        if profile:
            over["profile"] = True
        planned = [(cell, pm, [dataclasses.replace(j, **over) for j in js] if over else js)
                   for cell, pm, js in plan(sc, overrides)]
        jobs = [j for _, _, js in planned for j in js]
        if prof is not None:
            prof.add("plan", prof.clock() - t0)
            t0 = prof.clock()
        if lane == "batched":
            from repro_torch.memsim.batched import partition_jobs

            partition = partition_jobs(jobs)
            results = run_sweep(jobs, lane=lane, device=dev, processes=processes,
                                partition=partition)
            # After the run: run_sweep_batched appends the groups that failed
            # to stack to the partition's fallbacks.
            counts: Dict[str, int] = {}
            for _, reason in partition[1]:
                counts[reason] = counts.get(reason, 0) + 1
            meta.update(
                batched_jobs=len(jobs) - len(partition[1]),
                scalar_fallback_jobs=len(partition[1]),
                fallback_reasons=sorted(counts),
                fallback_reason_counts=dict(sorted(counts.items())),
            )
        else:
            results = run_sweep(jobs, lane=lane, device=dev, processes=processes)
        if prof is not None:
            prof.add("sweep", prof.clock() - t0)
            t0 = prof.clock()
        i = 0
        for cell, pm, cell_jobs in planned:
            rows.extend(sc.reduce(pm, cell, cell_jobs, results[i:i + len(cell_jobs)]))
            i += len(cell_jobs)
        if trace:
            traces = _cell_payloads(planned, results, "windows", "window_records")
        if perfetto:
            req_traces = _cell_payloads(planned, results, "trace", "trace")
        if prof is not None:
            prof.add("reduce", prof.clock() - t0)
    if prof is not None:
        meta["profile"] = prof.snapshot()
        meta["profile"]["jobs"] = [r.profile for r in results
                                   if getattr(r, "profile", None)]
        meta["metrics"] = default_registry().snapshot()
    return ResultTable(scenario=sc.name, rows=rows, params=values, traces=traces,
                       meta=meta, request_traces=req_traces)


def parse_set_args(scenario: ScenarioRef, pairs: Sequence[str]) -> Dict[str, Any]:
    """``axis=value`` tokens -> an overrides dict (parsed per axis)."""
    sc = _scenario(scenario)
    overrides: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects axis=value, got {pair!r}")
        k, v = pair.split("=", 1)
        overrides[k.strip()] = sc.axis(k.strip()).parse_text(v)
    return overrides
