"""Structured invariant errors (a copy of ``repro.core.invariants``'s
:class:`InvariantViolation`, :func:`require` and :func:`sanitize_enabled`).

Imports nothing else of the package, so the core engines never depend on
:mod:`repro_torch.analysis`, which re-exports these names."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


class InvariantViolation(RuntimeError):
    """A mechanically-checked invariant failed; carries the named check and
    free-form key/value context a bare assert loses."""

    def __init__(
        self,
        check: str,
        message: str,
        *,
        window: Optional[int] = None,
        station: Optional[Any] = None,
        context: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.check = check
        self.window = window
        self.station = station
        self.context = dict(context or {})
        parts = [f"[{check}]"]
        if window is not None:
            parts.append(f"window {window}")
        if station is not None:
            parts.append(f"station {station}")
        detail = ""
        if self.context:
            detail = " (" + ", ".join(
                f"{k}={v!r}" for k, v in sorted(self.context.items())
            ) + ")"
        super().__init__(f"{' '.join(parts)}: {message}{detail}")

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe form for ``SimResult.sanitizer``."""
        return {
            "check": self.check,
            "window": self.window,
            "station": self.station,
            "message": str(self),
            "context": dict(self.context),
        }


def require(
    cond: bool,
    check: str,
    message: str,
    *,
    window: Optional[int] = None,
    station: Optional[Any] = None,
    **context: Any,
) -> None:
    """``assert`` that ``python -O`` cannot strip: raise a structured
    :class:`InvariantViolation` when ``cond`` is false."""
    if not cond:
        raise InvariantViolation(
            check, message, window=window, station=station, context=context
        )


def sanitize_enabled() -> Optional[str]:
    """The process-wide sanitizer switch, ``REPRO_SANITIZE``: None when
    unset, empty or ``0``; ``"record"`` collects violations into the result
    instead of raising; any other value means ``"raise"``."""
    val = os.environ.get("REPRO_SANITIZE", "").strip()
    if val in ("", "0"):
        return None
    return "record" if val.lower() == "record" else "raise"
