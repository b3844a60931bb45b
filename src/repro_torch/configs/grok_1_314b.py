"""Grok-1 314B [hf:xai-org/grok-1] — 8 experts top-2, d_ff=32768, GQA kv=8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    num_experts=8, num_experts_per_tok=2, num_shared_experts=0, moe_d_ff=32768,
)
