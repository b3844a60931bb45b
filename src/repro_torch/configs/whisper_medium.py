"""Whisper-medium [arXiv:2212.04356] — enc-dec audio; conv frontend STUBBED
(input_specs provides precomputed frame embeddings at d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=51865,
    norm_type="layernorm", rope_theta=0.0,  # learned/sinusoidal pos (stubbed)
    frontend="audio_stub",
)
