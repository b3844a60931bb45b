"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig`` (exact published
hyper-parameters) plus a ``reduced()`` variant for CPU smoke tests. Input
shapes are global: the launcher shards them over the mesh. ``long_500k``
is only legal for sub-quadratic archs (``supports_long_context``).

The port's own copy of ``repro/configs/base.py``: the same fields and
numbers, with ``param_dtype`` a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0              # zamba2: shared attn after every k layers
    # enc-dec / multimodal
    encoder_layers: int = 0
    num_patches: int = 0             # vlm: visual tokens per example
    frontend: str = "none"           # none | audio_stub | vision_stub
    # quirks
    norm_type: str = "rmsnorm"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # numerics / perf knobs
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True
    attention_impl: str = "xla"      # xla | pallas
    # ApproxIoT data plane
    num_strata: int = 16

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ---------------------------------------------------------------- props
    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, h, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * (h + 2 * hkv) + h * hd * d
        if self.family in ("dense", "vlm"):
            per_layer = attn + 3 * d * f
            body = l * per_layer
        elif self.family == "moe":
            moe = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            shared = 3 * d * self.num_shared_experts * self.moe_d_ff
            body = l * (attn + moe + shared)
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn + 2 * d * f)
            dec = l * (2 * attn + 2 * d * f)
            body = enc + dec
        elif self.family == "hybrid":
            d_inner = 2 * d
            n = self.ssm_state
            mamba = d * (2 * d_inner + 2 * n + d_inner // self.ssm_head_dim) + d_inner * d
            n_attn = l // max(self.attn_every, 1)
            body = l * mamba + attn  # shared attn counted once
        elif self.family == "ssm":
            body = l * (6 * d * d + 2 * d * self.d_ff + d * 128)
        else:
            raise ValueError(self.family)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return int(body + emb)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, l = self.d_model, self.num_layers
        hd, h, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * (h + 2 * hkv) + h * hd * d
        routed = self.num_experts_per_tok * 3 * d * self.moe_d_ff
        shared = 3 * d * self.num_shared_experts * self.moe_d_ff
        emb = self.vocab_size * d * 2
        return int(l * (attn + routed + shared + d * self.num_experts) + emb)

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ArchConfig":
        """Small same-family config for single-device smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts_per_tok else 0,
            num_shared_experts=min(self.num_shared_experts, 1)
            if self.num_shared_experts else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            num_patches=min(self.num_patches, 8) if self.num_patches else 0,
            param_dtype=torch.float32,
            remat=False,
            num_strata=4,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the DESIGN.md §Arch-applicability rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention — 500k context skipped (DESIGN.md §6)"
    return True, ""
