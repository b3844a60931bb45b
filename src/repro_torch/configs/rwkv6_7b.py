"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay; head size 64."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    ssm_state=64, ssm_head_dim=64, norm_type="layernorm", rope_theta=0.0,
)
