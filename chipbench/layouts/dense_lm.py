"""The dense decoder LM (pre-norm attention and SwiGLU blocks, RMSNorm,
RoPE), as an explicit stack of layers or as SHINE's DEQ of weight-tied
blocks (``deq.enabled`` in the configuration file).

The parameters are laid out as the program takes them: a dict of stacked
leaves.  The distributions are the program's own initialisation: a
truncated normal of standard deviation ``1/sqrt(fan_in)`` (the fan-in
counts the stacked layer axis), the embedding normal at ``embedding_std``,
norm scales ones; every leaf of the DEQ's tied blocks is then scaled by
``deq_block_scale`` so that the solve converges from a random start.

A training step's operations are the model's matrix products (two per
multiply-add); causal attention counts the key positions each query needs
(``(S + 1) / 2`` on average), and a recomputed forward (remat) is not
counted.
"""

from __future__ import annotations


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab_size"] + 255) // 256 * 256


def is_deq(cfg: dict) -> bool:
    return bool(cfg.get("deq", {}).get("enabled"))


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """``(name, shape, init, scale)`` of every leaf, in the order they are
    drawn."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    hk = cfg["num_key_value_heads"] * cfg["head_dim"]
    L = cfg["num_hidden_layers"]
    init = cfg["init"]
    st = "deq_blocks" if is_deq(cfg) else "group0"
    sc = init["deq_block_scale"] if is_deq(cfg) else 1.0
    specs = [("embed.embedding", (padded_vocab(cfg), d), "normal",
              init["embedding_std"]),
             ("final_norm.scale", (d,), "ones", 1.0)]
    if not cfg["tie_word_embeddings"]:
        specs.append(("embed.lm_head", (d, padded_vocab(cfg)), "fan_in", 1.0))
    specs += [(f"{st}.ln1.scale", (L, d), "ones", sc),
              (f"{st}.attn.wq", (L, d, hq), "fan_in", sc),
              (f"{st}.attn.wk", (L, d, hk), "fan_in", sc),
              (f"{st}.attn.wv", (L, d, hk), "fan_in", sc),
              (f"{st}.attn.wo", (L, hq, d), "fan_in", sc),
              (f"{st}.ln2.scale", (L, d), "ones", sc),
              (f"{st}.mlp.wi_g", (L, d, ff), "fan_in", sc),
              (f"{st}.mlp.wi_u", (L, d, ff), "fan_in", sc),
              (f"{st}.mlp.wo", (L, ff, d), "fan_in", sc)]
    return specs


def model_config(cfg: dict):
    """The program's ``ModelConfig``."""
    from repro_torch.configs.base import DEQSettings, ModelConfig

    deq = cfg.get("deq", {})
    settings = DEQSettings()
    if is_deq(cfg):
        settings = DEQSettings(
            enabled=True, num_blocks=cfg["num_hidden_layers"],
            solver=deq["solver"], max_steps=deq["max_steps"], tol=deq["tol"],
            memory=deq["memory"], backward=deq["backward"],
            qn_dtype=deq["qn_dtype"])
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], act="silu",
        tie_embeddings=cfg["tie_word_embeddings"],
        max_seq=cfg["max_position_embeddings"], dtype=cfg["dtype"],
        remat=cfg.get("remat") or "none", schedule=cfg["schedule"],
        deq=settings)


def block_flops(cfg: dict, ctx: float) -> float:
    """One block's forward, per token, with ``ctx`` key positions per
    query."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    hk = cfg["num_key_value_heads"] * cfg["head_dim"]
    proj = 2 * (d * hq + 2 * d * hk + hq * d)
    mlp = 2 * 3 * d * ff
    attn = 4 * ctx * hq
    return proj + mlp + attn


def head_flops(cfg: dict) -> float:
    """The logits' product over the padded vocabulary, per token."""
    return 2 * cfg["hidden_size"] * padded_vocab(cfg)


def train_step_flops(cfg: dict, batch: int, seq: int, iters: int = 0,
                     ctx: float | None = None) -> float:
    """One training step.  The stack: forward and backward (twice the
    forward) of every layer and of the head.  The DEQ with ``iters``
    Broyden iterations: ``iters + 1`` evaluations of the tied blocks in
    the solve, one more at the fixed point under autograd and its
    backward (twice), the head forward and backward."""
    tokens = batch * seq
    ctx = (seq + 1) / 2 if ctx is None else ctx
    blk = block_flops(cfg, ctx)
    head = head_flops(cfg)
    layers = cfg["num_hidden_layers"]
    if is_deq(cfg):
        return tokens * ((iters + 4) * layers * blk + 3 * head)
    return tokens * 3 * (layers * blk + head)
