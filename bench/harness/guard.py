"""No JAX in a benchmark run: the program under test is the PyTorch
port, and the JAX package it was ported from is never loaded."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is a
    forbidden one, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
