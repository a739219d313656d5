"""The scenario planner: axis grid -> cells -> jobs -> rows (a copy of
``repro.scenarios.planner``'s expansion and dispatch).

Grid axes expand in declaration order, row-major, so the port's rows line
up with ``repro.scenarios.run_scenario``'s.  A grid scenario's jobs run in
one sweep, on the batched lane on the port's device or on the scalar DES;
a ``run_cell`` scenario runs cell by cell.  ``trace=True`` records every
grid job's per-window telemetry and ``perfetto=True`` its sampled request
spans, each returned beside the rows in the schema of the reference's
``ResultTable.traces`` and ``ResultTable.request_traces``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.device_model import PLATFORMS, PlatformModel
from repro_torch.device import resolve_device
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.scenarios.registry import get as _scenario


def _cells(sc: Scenario, overrides: Optional[Dict[str, Any]]
           ) -> List[Tuple[Dict[str, Any], Optional[PlatformModel]]]:
    """Each cell's axis values and platform (None without a platform axis).
    Overrides replace axis defaults: a scalar on a grid axis becomes a
    one-point grid, a string parses as a ``--set`` token."""
    values = {a.name: a.default for a in sc.axes}
    for k, v in (overrides or {}).items():
        axis = sc.axis(k)
        if isinstance(v, str):
            v = axis.parse_text(v)
        if axis.is_grid:
            v = tuple(v) if isinstance(v, (tuple, list)) else (v,)
        values[k] = v
    grid = [a for a in sc.axes if a.is_grid]
    scalars = {a.name: values[a.name] for a in sc.axes if not a.is_grid}
    out = []
    for combo in itertools.product(*[values[a.name] for a in grid]):
        cell = dict(scalars)
        cell.update({a.name: v for a, v in zip(grid, combo)})
        pm = None
        if "platform" in cell:
            if cell["platform"] not in PLATFORMS:
                raise KeyError(f"unknown platform {cell['platform']!r}; known "
                               f"platforms: {', '.join(PLATFORMS)}")
            pm = PLATFORMS[cell["platform"]]
        out.append((cell, pm))
    return out


def plan(
    name: str, overrides: Optional[Dict[str, Any]] = None
) -> List[Tuple[Dict[str, Any], Optional[PlatformModel], List[SimJob]]]:
    """Expand a grid scenario into (cell, platform, jobs) without running."""
    sc = _scenario(name)
    if sc.build is None:
        raise ValueError(f"scenario {sc.name!r} is multi-stage (run_cell); it has "
                         "no static job plan")
    return [(cell, pm, sc.build(pm, cell)) for cell, pm in _cells(sc, overrides)]


def run_scenario(
    name: str, overrides: Optional[Dict[str, Any]] = None, device=None, *,
    trace: bool = False, perfetto: bool = False, lane: str = "batched",
    processes: Optional[int] = None,
):
    """Run a scenario on ``device`` (the card unless ``"cpu"``) and return
    its rows in cell order: a grid scenario's jobs in one sweep on ``lane``
    (``"batched"``, or ``"scalar"``: one DES per job on the host, over
    ``processes`` workers), a ``run_cell`` scenario cell by cell.

    ``trace=True`` sets ``record_windows`` on every job and returns
    ``(rows, traces)``: one ``{"cell", "jobs": [{"job", "workloads",
    "windows"}]}`` entry per cell, the reference's schema.  ``perfetto=True``
    traces every 16th ToR admission of every job (so each runs on the
    scalar DES) and returns ``(rows, request_traces)``, the same schema with
    ``"trace"`` (``SimResult.trace``) in place of ``"windows"``; with both,
    ``(rows, traces, request_traces)``.  Both are for grid scenarios only:
    a ``run_cell`` scenario raises ``ValueError``."""
    sc = _scenario(name)
    dev = resolve_device(device)
    rows: List[Dict[str, Any]] = []
    if sc.run_cell is not None:
        if trace:
            raise ValueError(f"scenario {sc.name!r} is multi-stage (run_cell); "
                             "per-window decision tracing supports grid scenarios only")
        if perfetto:
            raise ValueError(f"scenario {sc.name!r} is multi-stage (run_cell); "
                             "request-lifecycle tracing supports grid scenarios only")
        for cell, pm in _cells(sc, overrides):
            rows.extend(sc.run_cell(pm, cell, dev))
        return rows
    planned = plan(name, overrides)
    over: Dict[str, Any] = {}
    if trace:
        over["record_windows"] = True
    if perfetto:
        over["trace"] = 16  # dense enough that a short cell lands spans
    if over:
        planned = [(cell, pm, [dataclasses.replace(j, **over) for j in js])
                   for cell, pm, js in planned]
    jobs = [j for _, _, js in planned for j in js]
    results = run_sweep(jobs, lane=lane, device=dev, processes=processes)
    traces: List[Dict[str, Any]] = []
    req_traces: List[Dict[str, Any]] = []
    i = 0
    for cell, pm, cell_jobs in planned:
        chunk = results[i:i + len(cell_jobs)]
        i += len(cell_jobs)
        rows.extend(sc.reduce(pm, cell, cell_jobs, chunk))
        for out, key, attr in ((traces, "windows", "window_records"),
                               (req_traces, "trace", "trace")):
            out.append({
                "cell": {k: getattr(v, "value", v) for k, v in cell.items()},
                "jobs": [{"job": j, "workloads": [w.name for w in job.workloads],
                          key: getattr(res, attr)}
                         for j, (job, res) in enumerate(zip(cell_jobs, chunk))],
            })
    extra = ([traces] if trace else []) + ([req_traces] if perfetto else [])
    return (rows, *extra) if extra else rows


def parse_set_args(name: str, pairs: Sequence[str]) -> Dict[str, Any]:
    """``axis=value`` tokens -> an overrides dict (parsed per axis)."""
    sc = _scenario(name)
    overrides: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects axis=value, got {pair!r}")
        k, v = pair.split("=", 1)
        overrides[k.strip()] = sc.axis(k.strip()).parse_text(v)
    return overrides
