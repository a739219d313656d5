"""Scenario specs: :class:`Axis`, :class:`Metric` and :class:`Scenario` (a
copy of the part of ``repro.scenarios.spec`` the port's registry uses).

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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


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
    #: The columns its rows report (declared by the scenarios that name them).
    metrics: Tuple[Metric, ...] = ()
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
