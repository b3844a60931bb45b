"""InternVL2-1B [arXiv:2404.16821; hf] — VLM; InternViT frontend STUBBED
(input_specs provides precomputed patch embeddings), Qwen2-0.5B-class LM."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, num_patches=256,
    frontend="vision_stub",
)
