"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434; hf]: 27L d=2048 16H MLA
(kv_lora=512, rope_dim=64, nope=128, v=128), vocab=102400; MoE: 64 routed
top-6 + 2 shared, expert ff=1408, first layer dense ff=10944 (the JAX
package's copy, ``repro/configs/deepseek_v2_lite_16b.py``)."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, expert_d_ff=1408,
                  first_k_dense=1, dense_d_ff=10944, norm_topk=False),
    rope_theta=10000.0,
)
