"""Structured invariant errors (a copy of ``repro.core.invariants``'s
:class:`InvariantViolation` and :func:`require`)."""

from __future__ import annotations

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
