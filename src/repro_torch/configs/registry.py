"""--arch registry: name → ArchConfig, plus input_specs() per shape.

The port of ``repro/configs/registry.py``. ``input_specs(cfg, shape)``
returns ``meta`` tensors (shapes and dtypes, no storage) standing in for
every input of one cell's step, the reference's shapes and dtypes: the
dry run distributes and runs against these. Modality frontends are
stubs: audio/vision entries include precomputed frame/patch embeddings
at ``d_model``.
"""
from __future__ import annotations

import importlib

import torch

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
           "get_config", "input_specs", "shape_applicable"]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str) -> dict:
    """``meta`` tensors for one (arch × shape) cell's step inputs."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape.name}: {why}")
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    if shape.kind in ("train", "prefill"):
        specs = {
            "tokens": _sds((b, s), i32),
            "stratum": _sds((b,), i32),
            "weight": _sds((b,), torch.float32),
        }
        if shape.kind == "train":
            specs["labels"] = _sds((b, s), i32)
        if cfg.family == "encdec":
            # conv frontend stub: precomputed frame embeddings; split the
            # budget: encoder sees s//2 frames, decoder s//2 tokens.
            specs["frames"] = _sds((b, s // 2, cfg.d_model), cfg.param_dtype)
            specs["tokens"] = _sds((b, s // 2), i32)
            if shape.kind == "train":
                specs["labels"] = _sds((b, s // 2), i32)
        if cfg.family == "vlm":
            # vision stub: patch embeddings prepended to the text tokens.
            p = cfg.num_patches
            specs["patches"] = _sds((b, p, cfg.d_model), cfg.param_dtype)
            specs["tokens"] = _sds((b, s - p), i32)
            if shape.kind == "train":
                specs["labels"] = _sds((b, s - p), i32)
        return specs

    # decode: one new token against a cache of seq_len.
    from repro_torch.models import model as model_lib

    return {
        "token": _sds((b, 1), i32),
        "pos": _sds((), i32),
        "cache": model_lib.cache_specs(cfg, b, s),
    }


def all_cells():
    """Yield (arch_name, shape_name, applicable, reason)."""
    for a in ARCH_NAMES:
        cfg = get_config(a)
        for s_name, sh in SHAPES.items():
            ok, why = shape_applicable(cfg, sh)
            yield a, s_name, ok, why
