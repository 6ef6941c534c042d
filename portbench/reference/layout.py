"""Where each layer's weights sit in the port's parameter tree.

The port stacks the layers of a block pattern in groups (``groups[pos]``
holds pattern position ``pos`` of every group on a leading axis) and keeps
the layers past the last whole group in ``rest``.  This is plain bookkeeping
from the configuration's numbers; the benchmark draws its weights into this
layout and the reference reads them back from it.
"""

from __future__ import annotations


def stack_plan(model: dict, pattern: tuple[str, ...], n_layers: int
               ) -> tuple[tuple[str, ...], int, int]:
    """(kinds of one group, number of groups, layers left in ``rest``)."""
    period_kinds = tuple(pattern) * max(1, int(model.get("scan_unroll", 1)))
    period = len(period_kinds)
    if model.get("scan_layers", True) and n_layers >= 2 * period:
        return period_kinds, n_layers // period, n_layers % period
    return period_kinds, 0, n_layers


def layer_kinds(period_kinds: tuple[str, ...], n_layers: int) -> list[str]:
    reps = -(-n_layers // len(period_kinds))
    return list((period_kinds * reps)[:n_layers])


def stacks(model: dict) -> dict[str, tuple[tuple[str, ...], int]]:
    """The model's layer stacks: name -> (pattern, layers)."""
    if model["family"] == "encdec":
        return {"encoder": (("attn",), model["encoder_layers"]),
                "decoder": (("attn_cross",), model["n_layers"])}
    return {"decoder": (tuple(model.get("block_pattern", ("attn",))),
                        model["n_layers"])}


def layer_params(tree: dict, model: dict, pattern, n_layers: int, i: int
                 ) -> tuple[str, dict]:
    """Layer ``i``'s kind and weights (a view of its slice of a group)."""
    period_kinds, n_groups, _ = stack_plan(model, pattern, n_layers)
    period = len(period_kinds)
    kinds = layer_kinds(period_kinds, n_layers)
    if i < n_groups * period:
        g, pos = divmod(i, period)
        return kinds[i], _index(tree["groups"][pos], g)
    return kinds[i], tree["rest"][i - n_groups * period]


def _index(node, g: int):
    if isinstance(node, dict):
        return {k: _index(v, g) for k, v in node.items()}
    return node[g]
