"""Architecture registry: ``--arch <id>`` resolution for every launcher (a
copy of ``repro.configs.registry``)."""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig
from . import (deepseek_67b, granite_moe_1b_a400m, h2o_danube_3_4b,
               internvl2_26b, mamba2_780m, mixtral_8x22b, olmo_1b,
               qwen2_5_3b, recurrentgemma_2b, seamless_m4t_medium)

ARCHS: dict[str, ModelConfig] = {
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "h2o-danube-3-4b": h2o_danube_3_4b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_live(arch: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: which (arch x shape) cells run (DESIGN.md §6)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    return True, ""


def live_cells() -> list[tuple[str, str]]:
    cells = []
    for a, ac in ARCHS.items():
        for s, sc in SHAPES.items():
            ok, _ = cell_is_live(ac, sc)
            if ok:
                cells.append((a, s))
    return cells
