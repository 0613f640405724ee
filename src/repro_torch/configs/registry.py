"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

The port's copy of ``repro/configs/registry.py``: all ten configs, in the
reference's order (the dense family, DeepSeek-V2-Lite with MLA,
DeepSeekMoE-16B with GQA, the HuBERT-XLarge encoder over stub frame
embeddings, Zamba2-2.7B's Mamba2 layers with a shared attention block,
xLSTM-1.3B's mLSTM and sLSTM blocks, Pixtral-12B over stub patch
embeddings).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_moe_16b,
    deepseek_v2_lite_16b,
    hubert_xlarge,
    internlm2_20b,
    minicpm_2b,
    phi3_mini_3p8b,
    pixtral_12b,
    stablelm_3b,
    xlstm_1p3b,
    zamba2_2p7b,
)
from repro_torch.configs.base import (
    DEQSettings,
    MLAConfig,
    MoEConfig,
    ModelConfig,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [minicpm_2b.CONFIG, phi3_mini_3p8b.CONFIG, stablelm_3b.CONFIG,
              internlm2_20b.CONFIG,
              deepseek_v2_lite_16b.CONFIG, deepseek_moe_16b.CONFIG,
              hubert_xlarge.CONFIG, zamba2_2p7b.CONFIG, xlstm_1p3b.CONFIG,
              pixtral_12b.CONFIG]
}


def get_config(name: str, *, deq: bool = False, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]
    if deq:
        cfg = dataclasses.replace(cfg, deq=DEQSettings(enabled=True))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def smoke_config(name: str, *, deq: bool = False) -> ModelConfig:
    """Reduced same-family config: small widths/layers/experts, tiny vocab
    (the JAX package's ``smoke_config``: the vlm family keeps 8 image
    tokens)."""
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]
    kw: dict = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=(2 if cfg.num_kv_heads < cfg.num_heads else 4),
        d_ff=(0 if cfg.family == "ssm" else 128),
        vocab_size=503,  # odd on purpose: exercises vocab padding
        head_dim=16,
        max_seq=64,
        num_layers=2,
    )
    if cfg.family == "moe":
        kw["num_layers"] = 3
        kw["moe"] = MoEConfig(
            num_experts=8, num_shared=1, top_k=2, expert_d_ff=32,
            first_k_dense=1, dense_d_ff=128, norm_topk=cfg.moe.norm_topk,
        )
    elif cfg.family == "hybrid":
        kw["num_layers"] = 6  # two units of 3
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16, attn_every=3
        )
    elif cfg.family == "ssm":
        kw["num_layers"] = 8  # two units of 4
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=4, chunk=16)
    if cfg.family == "vlm":
        kw["num_image_tokens"] = 8
    if cfg.attn_type == "mla":
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                              v_head_dim=16)
        kw["head_dim"] = 0
    out = dataclasses.replace(cfg, **kw)
    if deq:
        out = dataclasses.replace(
            out,
            deq=DEQSettings(enabled=True, num_blocks=2, max_steps=8,
                            memory=8, tol=1e-3),
        )
    return out
