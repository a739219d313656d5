"""The port's correctness tooling (a port of ``repro.analysis``): the
repo-specific AST lint (:mod:`.lint`, ``python -m repro_torch.analysis
lint``) and the runtime simulation sanitizer (:mod:`.sanitizer`), enabled
per job (``SimJob(sanitize=True)``), per sim (``TieredMemorySim(...,
sanitize=True)``) or process-wide (``REPRO_SANITIZE=1``, or ``=record`` to
collect violations instead of raising)."""

from repro_torch.core.invariants import InvariantViolation, require, sanitize_enabled

from repro_torch.analysis.lint import Finding, run_lint
from repro_torch.analysis.sanitizer import DesSanitizer, QueueSanitizer

__all__ = [
    "DesSanitizer",
    "Finding",
    "InvariantViolation",
    "QueueSanitizer",
    "require",
    "run_lint",
    "sanitize_enabled",
]
