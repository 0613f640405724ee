"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: Mistral-Nemo-like decoder
40L d=5120 32H (kv=8, head_dim=128) ff=14336 vocab=131072; pixtral-ViT
vision tower is a stub providing precomputed patch embeddings
(assignment spec); 1024 image tokens prepended."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1000000.0,
    frontend="vision_stub", num_image_tokens=1024,
)
