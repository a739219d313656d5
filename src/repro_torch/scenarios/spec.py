"""Scenario specs: :class:`Axis`, :class:`Metric`, :class:`Scenario` and
:class:`ResultTable` (a copy of ``repro.scenarios.spec``).

A :class:`Scenario` describes one experiment family: its axes (grid axes
expand into cells, scalar axes are knobs every cell shares), the metrics
its rows report, and either

* ``build`` + ``reduce``: ``build(platform, cell)`` gives one cell's
  :class:`~repro_torch.memsim.sweep.SimJob` list and ``reduce(platform,
  cell, jobs, results)`` its rows; the planner runs every cell's jobs in
  one batched sweep; or
* ``run_cell(platform, cell, device)``: one cell run whole, for
  experiments that do not run on the simulated testbed (Fig. 11's serving
  engines).  The reference passes a process count where the port passes
  its device.

The planner returns a :class:`ResultTable`: the rows, the axis values, and
what ran them (``meta``).
"""

from __future__ import annotations

import csv
import dataclasses
import enum
import io
import json
from typing import Any, Callable, Dict, List, Optional, Tuple


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {text!r}")


def _infer_parse(sample: Any) -> Callable[[str], Any]:
    """The ``--set`` parser for an axis whose default is like ``sample``."""
    if isinstance(sample, bool):  # before int: a bool is an int
        return _parse_bool
    if isinstance(sample, enum.Enum):
        return type(sample)  # by value, e.g. OpClass("load")
    if isinstance(sample, int):
        return int
    if isinstance(sample, float):
        return float
    return str


@dataclasses.dataclass(frozen=True)
class Axis:
    """One scenario parameter: a tuple default is a grid axis (the cells
    are the cartesian product of the grid axes), a scalar default a knob
    every cell shares.  ``parse`` converts one ``--set`` token (default:
    inferred from the default's type)."""

    name: str
    default: Any
    help: str = ""
    parse: Optional[Callable[[str], Any]] = None

    @property
    def is_grid(self) -> bool:
        return isinstance(self.default, (tuple, list))

    def parse_text(self, text: str) -> Any:
        """Parse one ``--set`` token (comma lists become grids)."""
        sample = self.default[0] if self.is_grid else self.default
        fn = self.parse or _infer_parse(sample)
        if self.is_grid:
            return tuple(fn(p.strip()) for p in text.split(","))
        if "," in text:
            raise ValueError(f"axis {self.name!r} is a scalar knob, got list {text!r}")
        return fn(text.strip())


@dataclasses.dataclass(frozen=True)
class Metric:
    """One column the scenario's result rows report."""

    name: str
    unit: str = ""
    help: str = ""


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named experiment: exactly one of ``build`` + ``reduce`` (a grid on
    the batched lane) or ``run_cell`` (a cell run whole).  ``slow`` marks
    a heavy scenario."""

    name: str
    title: str
    axes: Tuple[Axis, ...] = ()
    #: The columns its rows report.
    metrics: Tuple[Metric, ...] = ()
    figure: str = ""  # paper figure label, e.g. "Fig. 3"
    #: The reference's benchmarks module that presents this scenario.  The
    #: port has no figure modules: its scenarios leave it empty and neither
    #: the catalog nor ``--list`` prints it.  It stays so that a Scenario
    #: built with the reference's keyword arguments constructs here too.
    module: str = ""
    #: (platform, cell) -> List[SimJob]
    build: Optional[Callable[..., List[Any]]] = None
    #: (platform, cell, jobs, results) -> rows
    reduce: Optional[Callable[..., List[Dict[str, Any]]]] = None
    #: (platform, cell, device) -> rows
    run_cell: Optional[Callable[..., List[Dict[str, Any]]]] = None
    slow: bool = False

    def __post_init__(self):
        grid_form = self.build is not None and self.reduce is not None
        if grid_form == (self.run_cell is not None):
            raise ValueError(f"scenario {self.name!r} needs either build+reduce or "
                             "run_cell (exactly one form)")

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"scenario {self.name!r} has no axis {name!r}; axes: "
                       f"{', '.join(a.name for a in self.axes) or '(none)'}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)


def _plain(v: Any) -> Any:
    """JSON/CSV-safe cell value (enums flatten to their value)."""
    if isinstance(v, enum.Enum):
        return v.value
    return v


def format_default(v: Any) -> str:
    """One axis default as display text: enums by value, sequences
    comma-joined, whole floats without the trailing ``.0``.  The one
    formatter of the catalog and the CLI's listing."""
    if isinstance(v, enum.Enum):
        return str(v.value)
    if isinstance(v, (tuple, list)):
        return ", ".join(format_default(x) for x in v)
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return str(v)


@dataclasses.dataclass
class ResultTable:
    """A uniform result table: one scenario, ordered rows of plain dicts."""

    scenario: str
    rows: List[Dict[str, Any]]
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: Per-window control-plane telemetry, one entry per cell with its
    #: jobs' window records: only under ``run_scenario(..., trace=True)``.
    traces: Optional[List[Dict[str, Any]]] = None
    #: What ran: the lane and, on the batched lane, how many jobs it ran
    #: and how many fell back to the scalar DES and why; under
    #: ``profile=True`` the phase profile and the metrics snapshot.
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: Sampled request spans, one entry per cell with its jobs'
    #: ``SimResult.trace``: only under ``run_scenario(..., perfetto=True)``.
    #: Left out of :meth:`to_json`; the CLI writes it as Chrome trace events.
    request_traces: Optional[List[Dict[str, Any]]] = None

    def __post_init__(self):
        self.rows = [{k: _plain(v) for k, v in r.items()} for r in self.rows]
        self.params = {k: _plain(v) for k, v in self.params.items()}

    @property
    def columns(self) -> List[str]:
        cols: List[str] = []
        for r in self.rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        return cols

    def to_csv(self) -> str:
        """The rows as CSV text (union of row keys, declaration order)."""
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=self.columns, restval="",
                           lineterminator="\n")
        w.writeheader()
        w.writerows(self.rows)
        return buf.getvalue()

    def to_json(self, indent: Optional[int] = 2) -> str:
        """Scenario, params, rows (and non-empty meta) as a JSON document."""
        def default(o: Any) -> Any:
            plain = _plain(o)
            return plain if plain is not o else str(o)

        payload = {"scenario": self.scenario, "params": self.params,
                   "rows": self.rows}
        if self.meta:
            payload["meta"] = self.meta
        return json.dumps(payload, indent=indent, default=default)
