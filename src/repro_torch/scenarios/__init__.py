"""The port's own scenario registry (the grid scenarios the batched lane
runs); see :mod:`repro_torch.scenarios.library`."""

from repro_torch.scenarios.library import (
    SCENARIOS,
    Axis,
    Scenario,
    parse_set_args,
    plan,
    run_scenario,
)

__all__ = ["SCENARIOS", "Axis", "Scenario", "parse_set_args", "plan", "run_scenario"]
