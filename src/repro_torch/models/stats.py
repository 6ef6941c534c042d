"""Side channel for per-forward statistics (early-termination rates etc.),
port of ``repro.models.stats``: layers ``record`` named values into a
context that callers open around a forward pass with ``collect()``.
"""

from __future__ import annotations

import contextlib
from typing import Any

_ACTIVE: list[dict[str, list[Any]]] = []


@contextlib.contextmanager
def collect():
    sink: dict[str, list[Any]] = {}
    _ACTIVE.append(sink)
    try:
        yield sink
    finally:
        _ACTIVE.pop()


def record(name: str, value) -> None:
    if _ACTIVE:
        _ACTIVE[-1].setdefault(name, []).append(value)
