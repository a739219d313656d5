"""The port's own scenario registry (:mod:`.library`, looked up through
:mod:`.registry`), its specs (:mod:`.spec`) and the planner that runs them
(:mod:`.planner`)."""

from repro_torch.scenarios.library import SCENARIOS
from repro_torch.scenarios.planner import parse_set_args, plan, run_scenario
from repro_torch.scenarios.registry import UnknownScenarioError, all_scenarios, get, names
from repro_torch.scenarios.spec import Axis, Scenario

__all__ = [
    "SCENARIOS", "Axis", "Scenario", "UnknownScenarioError", "all_scenarios", "get",
    "names", "parse_set_args", "plan", "run_scenario",
]
