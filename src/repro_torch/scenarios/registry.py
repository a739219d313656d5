"""Scenario lookup by name (a port of ``repro.scenarios.registry``).

The port's scenarios live in one dict, :data:`repro_torch.scenarios.library.
SCENARIOS`, in the reference's declaration order; :func:`register` appends
to it.  That order is the presentation order :func:`names` and
:func:`all_scenarios` return.
"""

from __future__ import annotations

import difflib
from typing import List

from repro_torch.scenarios.library import SCENARIOS
from repro_torch.scenarios.spec import Scenario


class UnknownScenarioError(KeyError):
    """Raised by :func:`get` for an unregistered name; ``suggestions``
    holds up to three near misses.  A KeyError, whose ``__str__`` is the
    plain message (KeyError would quote it)."""

    def __init__(self, name: str, known: List[str]):
        self.name = name
        self.known = known
        self.suggestions = difflib.get_close_matches(name, known, n=3)
        msg = f"unknown scenario {name!r}"
        if self.suggestions:
            msg += "; did you mean: " + ", ".join(self.suggestions) + "?"
        msg += f"\nregistered scenarios: {', '.join(known)}"
        super().__init__(msg)

    def __str__(self) -> str:
        return self.args[0]


def register(scenario: Scenario) -> Scenario:
    """Register ``scenario`` under its name (a duplicate name raises
    ``ValueError``)."""
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    """The scenario registered as ``name``; :class:`UnknownScenarioError`
    with near-miss suggestions otherwise."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise UnknownScenarioError(name, names()) from None


def names() -> List[str]:
    """Registered scenario names, in presentation order."""
    return list(SCENARIOS)


def all_scenarios() -> List[Scenario]:
    """Registered scenarios, in presentation order."""
    return list(SCENARIOS.values())
