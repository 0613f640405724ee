"""Config schema for models and the DEQ/SHINE technique.

The port's own copy of ``repro/configs/base.py`` (the port imports nothing
of the JAX package): same frozen dataclasses, same fields, same defaults, so
both packages run identical hyperparameters.  The analytic parameter counts
and ``TrainConfig`` come with the training and dry-run slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class DEQSettings:
    """The paper's technique as a first-class LM feature: replace the layer
    stack by a weight-tied group of ``num_blocks`` blocks solved to a fixed
    point; hypergradient via the selected backward mode."""

    enabled: bool = False
    num_blocks: int = 4
    solver: str = "broyden"
    max_steps: int = 12
    tol: float = 1e-3
    memory: int = 8
    backward: str = "shine_fallback"
    refine_steps: int = 5
    backward_max_steps: int = 16
    unroll: bool = False  # dry-run costing mode
    # storage dtype of the quasi-Newton U/V ring (f32 accumulate regardless)
    qn_dtype: str = "bfloat16"
    # in-loop numerical-fault containment (per-sample detect / restart /
    # freeze inside the solver; see core.solvers.SolverConfig)
    guard: bool = True


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared: int = 0
    top_k: int = 2
    expert_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    aux_weight: float = 1e-3
    z_weight: float = 1e-4


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    absorbed_decode: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    attn_every: int = 0


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int = 2
    d_model: int = 64
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 128
    vocab_size: int = 512
    head_dim: int = 0            # 0 -> d_model // num_heads
    attn_type: str = "gqa"       # gqa | mla
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"            # silu -> SwiGLU; gelu -> plain MLP
    tie_embeddings: bool = False
    causal: bool = True
    frontend: str | None = None
    num_image_tokens: int = 0
    logits_softcap: float = 0.0
    max_seq: int = 4096
    moe: MoEConfig = MoEConfig()
    mla: MLAConfig = MLAConfig()
    ssm: SSMConfig = SSMConfig()
    xlstm: XLSTMConfig = XLSTMConfig()
    deq: DEQSettings = DEQSettings()
    # execution knobs
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"
    schedule: str = "cosine"
    attn_impl: str = "auto"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    attn_unroll: bool = False
    seq_parallel: bool = False

    # ---- derived ----

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    def with_(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
