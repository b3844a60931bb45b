"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention
block applied every 6 layers (weights shared across applications)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, attn_every=6, head_dim=64,
)
