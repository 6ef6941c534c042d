"""Precision context: thread a runtime precision into nested DSLOT layers
(port of ``repro.runtime.context``).

Model code calls layers through entry points whose signatures do not carry a
precision argument.  The caller opens ``precision_scope(n_planes)`` around
the call and layers ask ``current_precision(name, default)`` — the value (a
python int, a ``{layer_name: planes}`` dict, or an i32 tensor such as a
per-slot budget vector) reaches the layer like any other input.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

_ACTIVE: list[Any] = []


@contextlib.contextmanager
def precision_scope(n_planes: Any) -> Iterator[None]:
    """Make ``n_planes`` the active runtime precision for DSLOT layers.

    ``n_planes``: int | i32 tensor (scalar or per-row) | dict mapping
    layer names to either.  ``None`` entries fall through to the layer
    default.  (The argument is named ``n_planes`` everywhere precision
    crosses an API boundary — ``generate``, ``Request``, kernels.)
    """
    _ACTIVE.append(n_planes)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_precision(name: str, default: Any = None) -> Any:
    """Precision for layer ``name`` from the innermost active scope."""
    if not _ACTIVE:
        return default
    value = _ACTIVE[-1]
    if isinstance(value, dict):
        value = value.get(name, value.get("*", None))
    return default if value is None else value
