"""DeepSeekMoE-16B [arXiv:2401.06066; hf]: 28L d=2048 16H (kv=16) vocab=102400;
fine-grained MoE: 64 routed top-6 + 2 shared, expert ff=1408, first layer
dense ff=10944."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, expert_d_ff=1408,
                  first_k_dense=1, dense_d_ff=10944, norm_topk=True),
    rope_theta=10000.0,
)
