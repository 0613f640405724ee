"""Config schema for models and the DEQ/SHINE technique.

The port's own copy of ``repro/configs/base.py`` (the port imports nothing
of the JAX package): same frozen dataclasses, same fields, same defaults, so
both packages run identical hyperparameters: the model schema, its
analytic parameter count (``ModelConfig.num_params``) and the trainer's
``TrainConfig``.
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
    attn_every: int = 0          # Zamba2: shared attention block period


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8         # 7:1 mLSTM:sLSTM
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

    # ---- analytic parameter counts (the published model's, which the
    # dry-run prints; a DEQ's tied blocks are not what it counts) ----

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_type == "mla":
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            n = d * self.num_heads * qk                             # W_q
            n += d * (m.kv_lora_rank + m.qk_rope_dim)               # W_dkv
            n += m.kv_lora_rank * self.num_heads * m.qk_nope_dim    # W_uk
            n += m.kv_lora_rank * self.num_heads * m.v_head_dim     # W_uv
            n += self.num_heads * m.v_head_dim * d                  # W_o
            return n
        return d * self.attn_dim * 2 + d * self.kv_dim * 2

    def _mlp_params(self, ff: int) -> int:
        mult = 3 if self.act == "silu" else 2
        return mult * self.d_model * ff

    def _layer_params(self, layer_idx: int) -> int:
        d = self.d_model
        n = 2 * d  # norms
        if self.family == "ssm":  # xLSTM
            x = self.xlstm
            h = self.num_heads
            hd = d // h
            if (layer_idx + 1) % x.slstm_every == 0:
                ffd = int(round(d * x.slstm_proj_factor / 64)) * 64
                return n + 4 * d * d + 4 * h * hd * hd + 3 * d * ffd
            inner = int(d * x.mlstm_proj_factor)
            # block-diagonal qkv: 3 * inner^2 / h
            return (n + 2 * d * inner + inner * d
                    + 3 * inner * inner // h + 2 * inner * h)
        if self.family == "hybrid":  # a Mamba2 layer (shared block: once)
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
            n += conv_dim * s.d_conv + d_in * d + 2 * nh + d_in    # the rest
            return n
        n += self._attn_params()
        if self.family == "moe" and layer_idx >= self.moe.first_k_dense:
            m = self.moe
            n += self._mlp_params(m.expert_d_ff) * m.num_experts
            n += self._mlp_params(m.expert_d_ff * max(m.num_shared, 0))
            n += self.d_model * m.num_experts  # router
        else:
            ff = (self.moe.dense_d_ff
                  if self.family == "moe" and self.moe.dense_d_ff
                  else self.d_ff)
            n += self._mlp_params(ff)
        return n

    def num_params(self, active_only: bool = False) -> int:
        """The published model's parameter count (``active_only``: a MoE
        layer's routed experts counted at ``top_k``)."""
        n = self.padded_vocab * self.d_model  # embed
        if not self.tie_embeddings and self.family != "audio":
            n += self.padded_vocab * self.d_model
        if self.family == "audio":
            n += self.d_model * self.vocab_size  # small classifier head
        for i in range(self.num_layers):
            ln = self._layer_params(i)
            if (active_only and self.family == "moe"
                    and i >= self.moe.first_k_dense):
                m = self.moe
                full_experts = self._mlp_params(m.expert_d_ff) * m.num_experts
                active = self._mlp_params(m.expert_d_ff) * m.top_k
                ln = ln - full_experts + active
            n += ln
        if self.family == "hybrid" and self.ssm.attn_every:
            n += self._attn_params() + self._mlp_params(self.d_ff)
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup_steps: int = 10
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    optimizer: str = "adamw"     # adamw | sgdm
    schedule: str = "cosine"     # cosine | wsd | linear
    grad_accum: int = 1
    z_loss: float = 1e-4
    seed: int = 0
    # distributed-optimization knobs (``zero1``: the dry-run's moment
    # layout; the pod-gradient compression is not ported yet)
    zero1: bool = True
    compress_pod_grads: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    # DEQ persistent solve state across train steps:
    #   "state" -- warm-start the iterate only, the quasi-Newton chain is
    #              rebuilt each step (fresh i.i.d. batches);
    #   "full"  -- iterate and chain (repeated / similar batches);
    #   "off"   -- cold start every step.
    deq_carry: str = "state"
    # checkpoint-lean mode: omit the (m, B, S, d) u/v ring of the carry from
    # saves; restore zero-fills it (a zeroed ring is the identity inverse)
    checkpoint_lean: bool = False
    # storage dtype of the quasi-Newton ring of the trainer's DEQ solves
    qn_dtype: str = "bfloat16"
    # a non-finite loss or gradient norm rejects the whole update; past
    # skip_budget consecutive rejected steps the trainer rolls back to the
    # last checkpoint
    skip_nonfinite: bool = True
    skip_budget: int = 5
