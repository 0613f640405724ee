"""StableLM-3B [hf:stabilityai]: 32L d=2560 32H (kv=32) ff=6912 vocab=50304."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80, rope_theta=10000.0,
)
