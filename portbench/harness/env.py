"""The run's surroundings: the checkout's paths, its fixed cache
directories, the card check and the check for modules the run must not
hold."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]          # the checkout
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def prepare_paths() -> None:
    """The program's sources first on the path; every build and kernel
    cache at a fixed directory inside the checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"portbench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} present")
