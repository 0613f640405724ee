"""Zamba2-2.7B [arXiv:2411.15242; hf]: 54 Mamba2 layers d=2560 (state=64) with
a SHARED attention(+MLP) block (32H, ff=10240) invoked every 6 layers,
vocab=32000."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256, attn_every=6),
)
