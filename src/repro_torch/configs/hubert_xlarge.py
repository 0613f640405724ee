"""HuBERT-XLarge [arXiv:2106.07447]: 48L d=1280 16H ff=5120, encoder-only,
504 output classes; audio frontend is a stub providing precomputed frame
embeddings (assignment spec)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80, act="gelu",
    causal=False, frontend="audio_stub",
)
