"""Grid scenarios of the port: the co-run sweeps of the batched lane.

A copy of ``corun_sweep`` and ``corun_sweep_1k``
(``repro/scenarios/library.py:1009-1081``) with the reference planner's
axis expansion (grid axes in declaration order, row-major), so that the
port's rows line up with ``repro.scenarios.run_scenario(...,
lane="batched")``'s.  The port keeps its own registry (:data:`SCENARIOS`)
and registers nothing into the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.device_model import PLATFORMS, PlatformModel
from repro_torch.core.littles_law import OpClass
from repro_torch.device import resolve_device
from repro_torch.memsim.sweep import SimJob, run_sweep
from repro_torch.memsim.workloads import bw_test

_DEMAND_CLASSES = (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE)


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {text!r}")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One scenario parameter: a tuple default is a grid axis (the cells
    are the cartesian product of the grid axes), a scalar default a knob
    every cell shares."""

    name: str
    default: Any
    help: str = ""

    @property
    def is_grid(self) -> bool:
        return isinstance(self.default, (tuple, list))

    def parse_text(self, text: str) -> Any:
        """Parse one ``--set`` token (comma lists become grids)."""
        sample = self.default[0] if self.is_grid else self.default
        # bool before int (a bool is an int); an enum parses by its value.
        fn: Callable[[str], Any] = (_parse_bool if isinstance(sample, bool)
                                    else type(sample))
        if self.is_grid:
            return tuple(fn(p.strip()) for p in text.split(","))
        if "," in text:
            raise ValueError(f"axis {self.name!r} is a scalar knob, got list {text!r}")
        return fn(text.strip())


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named grid experiment: ``build(platform, cell)`` gives a cell's
    jobs, ``reduce(platform, cell, jobs, results)`` its rows."""

    name: str
    title: str
    axes: Tuple[Axis, ...]
    build: Callable[..., List[SimJob]]
    reduce: Callable[..., List[Dict[str, Any]]]

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"scenario {self.name!r} has no axis {name!r}; axes: "
                       f"{', '.join(a.name for a in self.axes)}")


def _corun_sweep_build(platform: PlatformModel, cell) -> List[SimJob]:
    op, n = cell["op"], cell["threads"]
    wls = [
        bw_test("ddr", op, n, name="ddr", mlp=cell["mlp"], miku_managed=False),
        bw_test("cxl", op, n, name="cxl", mlp=cell["mlp"]),
    ]
    return [SimJob(platform=platform, workloads=wls, sim_ns=cell["sim_ns"],
                   miku=cell["miku"])]


def _corun_sweep_reduce(platform, cell, jobs, results) -> List[dict]:
    (res,) = results
    return [{
        "platform": cell["platform"],
        "op": cell["op"].value,
        "threads": cell["threads"],
        "mlp": cell["mlp"],
        "miku": cell["miku"],
        "ddr_gbps": res.bandwidth("ddr"),
        "cxl_gbps": res.bandwidth("cxl"),
        "restricted_windows": sum(1 for d in res.decisions if d.restricted),
    }]


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (
        Scenario(
            name="corun_sweep",
            title="Sweep-scale co-run grid (96 cells): threads x op x MIKU x platform",
            axes=(
                Axis("platform", ("A", "B"), "platform name"),
                Axis("op", _DEMAND_CLASSES, "memory instruction class"),
                Axis("threads", (2, 4, 8, 16), "threads per co-running group"),
                Axis("miku", (False, True), "enable the MIKU controller"),
                Axis("mlp", (96, 160), "outstanding cachelines per core"),
                Axis("sim_ns", 300_000.0, "co-run simulated horizon"),
            ),
            build=_corun_sweep_build,
            reduce=_corun_sweep_reduce,
        ),
        Scenario(
            name="corun_sweep_1k",
            title="Kilo-cell co-run grid (1024 cells): the batched lane at scale",
            axes=(
                Axis("platform", ("A", "B"), "platform name"),
                Axis("op", (OpClass.LOAD, OpClass.STORE), "memory instruction class"),
                Axis("threads", (1, 2, 3, 4, 6, 8, 12, 16),
                     "threads per co-running group"),
                Axis("miku", (False, True), "enable the MIKU controller"),
                Axis("mlp", (32, 40, 48, 56, 64, 80, 96, 112,
                             128, 144, 160, 176, 192, 208, 224, 256),
                     "outstanding cachelines per core"),
                Axis("sim_ns", 100_000.0, "co-run simulated horizon"),
            ),
            build=_corun_sweep_build,
            reduce=_corun_sweep_reduce,
        ),
    )
}


def _scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; the port has "
                       f"{', '.join(SCENARIOS)}") from None


def plan(
    name: str, overrides: Optional[Dict[str, Any]] = None
) -> List[Tuple[Dict[str, Any], PlatformModel, List[SimJob]]]:
    """Expand a scenario into (cell, platform, jobs) without running.
    Overrides replace axis defaults (a scalar on a grid axis becomes a
    one-point grid; strings are parsed as ``--set`` tokens)."""
    sc = _scenario(name)
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
        label = cell["platform"]
        if label not in PLATFORMS:
            raise KeyError(f"unknown platform {label!r}; known platforms: "
                           f"{', '.join(PLATFORMS)}")
        pm = PLATFORMS[label]
        out.append((cell, pm, sc.build(pm, cell)))
    return out


def run_scenario(
    name: str, overrides: Optional[Dict[str, Any]] = None, device=None
) -> List[Dict[str, Any]]:
    """Run a scenario on the batched lane on ``device`` (the card unless
    ``"cpu"``) and return its reduced rows, in cell order."""
    sc = _scenario(name)
    dev = resolve_device(device)
    planned = plan(name, overrides)
    jobs = [j for _, _, js in planned for j in js]
    results = run_sweep(jobs, lane="batched", device=dev)
    rows: List[Dict[str, Any]] = []
    i = 0
    for cell, pm, cell_jobs in planned:
        rows.extend(sc.reduce(pm, cell, cell_jobs, results[i:i + len(cell_jobs)]))
        i += len(cell_jobs)
    return rows


def parse_set_args(name: str, pairs: Sequence[str]) -> Dict[str, Any]:
    """``axis=value`` tokens → an overrides dict (parsed per axis)."""
    sc = _scenario(name)
    overrides: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects axis=value, got {pair!r}")
        k, v = pair.split("=", 1)
        overrides[k.strip()] = sc.axis(k.strip()).parse_text(v)
    return overrides
