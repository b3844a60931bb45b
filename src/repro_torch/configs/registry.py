"""--arch registry: name → ArchConfig.

The port's own copy of ``repro/configs/registry.py``, without
``input_specs``: that builds the dry-run's abstract inputs, XLA tooling
that the port does not carry (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

_MODULES = {
    "olmo-1b": "olmo_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "smollm-135m": "smollm_135m",
    "qwen3-4b": "qwen3_4b",
    "whisper-medium": "whisper_medium",
    "internvl2-1b": "internvl2_1b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-1.2b": "zamba2_1_2b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "ArchConfig", "SHAPES", "ShapeConfig", "all_cells",
           "get_config", "shape_applicable"]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_cells():
    """Yield (arch_name, shape_name, applicable, reason)."""
    for a in ARCH_NAMES:
        cfg = get_config(a)
        for s_name, sh in SHAPES.items():
            ok, why = shape_applicable(cfg, sh)
            yield a, s_name, ok, why
