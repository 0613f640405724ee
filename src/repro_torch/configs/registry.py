"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

The port's copy of ``repro/configs/registry.py`` for the dense family (the
family this slice serves); the other families join with their slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import minicpm_2b
from repro_torch.configs.base import DEQSettings, ModelConfig

# Dense entries besides MiniCPM, as published (see the JAX package's
# configs/ for the sources): Phi-3-mini [arXiv:2404.14219], StableLM-3B
# [hf:stabilityai], InternLM2-20B [arXiv:2403.17297].
_PHI3_MINI = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96, rope_theta=10000.0,
)
_STABLELM_3B = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80, rope_theta=10000.0,
)
_INTERNLM2_20B = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128, rope_theta=1000000.0,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [minicpm_2b.CONFIG, _PHI3_MINI, _STABLELM_3B, _INTERNLM2_20B]
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
    """Reduced same-family config: small widths/layers, tiny vocab (the
    dense branch of the JAX package's ``smoke_config``)."""
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]
    out = dataclasses.replace(
        cfg,
        d_model=64,
        num_heads=4,
        num_kv_heads=(2 if cfg.num_kv_heads < cfg.num_heads else 4),
        d_ff=128,
        vocab_size=503,  # odd on purpose: exercises vocab padding
        head_dim=16,
        max_seq=64,
        num_layers=2,
    )
    if deq:
        out = dataclasses.replace(
            out,
            deq=DEQSettings(enabled=True, num_blocks=2, max_steps=8,
                            memory=8, tol=1e-3),
        )
    return out
