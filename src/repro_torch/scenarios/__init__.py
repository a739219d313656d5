"""The port's own scenario registry (:mod:`.library`, looked up through
:mod:`.registry`), its specs (:mod:`.spec`), the planner that runs them
(:mod:`.planner`) and the generated catalog (:mod:`.catalog`).

    from repro_torch.scenarios import run_scenario
    table = run_scenario("fig3_bandwidth", {"platform": "A"}, device="cpu")
    print(table.to_csv())
"""

from repro_torch.scenarios.library import SCENARIOS
from repro_torch.scenarios.planner import (
    expand_cells,
    parse_set_args,
    plan,
    resolve_axes,
    resolve_platform,
    run_scenario,
)
from repro_torch.scenarios.registry import (
    UnknownScenarioError,
    all_scenarios,
    get,
    names,
    register,
)
from repro_torch.scenarios.spec import Axis, Metric, ResultTable, Scenario

__all__ = [
    "SCENARIOS", "Axis", "Metric", "ResultTable", "Scenario", "UnknownScenarioError",
    "all_scenarios", "expand_cells", "get", "names", "parse_set_args", "plan", "register",
    "resolve_axes", "resolve_platform", "run_scenario",
]
