"""The input-shape suites and their layouts.

The port of ``repro/configs/shapes.py``.  ``input_specs`` gives ``meta``
tensors (shape and dtype, no storage) with a spec each, as the reference's
``ShapeDtypeStruct``s carry a sharding.

    train_4k     seq=4096   global_batch=256   (training)
    prefill_32k  seq=32768  global_batch=32    (inference prefill)
    decode_32k   seq=32768  global_batch=128   (one token vs a 32k cache)
    long_500k    seq=524288 global_batch=1     (long-context decode)

Skips: ``long_500k`` runs only for the sub-quadratic families (ssm,
hybrid); the encoder-only audio family has no autoregressive decode (no
``decode_32k``, no ``long_500k``; its ``prefill_32k`` is a full encode).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.manager import map_with_path
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.layers import act_dtype
from repro_torch.parallel.sharding import (
    DECODE_RULES,
    LONG_CONTEXT_RULES,
    PREFILL_RULES,
    TRAIN_RULES,
    ShardCtx,
    ShardingRules,
)


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSuite("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSuite("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSuite("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSuite) -> str | None:
    if cfg.family == "audio" and shape.kind == "decode":
        return "encoder-only: no autoregressive decode"
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return ("pure full-attention arch: 500k cell reserved for "
                "sub-quadratic archs")
    return None


def valid_cells(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPES if cell_skip_reason(cfg, SHAPES[s]) is None]


def rules_for_shape(shape: ShapeSuite) -> ShardingRules:
    if shape.name == "long_500k":
        return LONG_CONTEXT_RULES
    if shape.kind == "decode":
        return DECODE_RULES
    if shape.kind == "prefill":
        # writes the decode layout's cache; attention stays head-sharded
        return PREFILL_RULES
    return TRAIN_RULES


def make_ctx(cfg: ModelConfig, mesh, shape: ShapeSuite,
             rules: ShardingRules | None = None) -> ShardCtx:
    """The cell's ShardCtx, with the reference's per-arch fixups: KV heads
    that do not divide the TP degree are replicated (weights and
    activations); xLSTM's 4 heads cannot split over tp 16, so its per-head
    weights are replicated; ``seq_parallel`` training splits the residual
    stream's sequence."""
    rules = rules or rules_for_shape(shape)
    if mesh is not None and "model" in mesh.axis_names:
        tp = mesh.shape["model"]
        if cfg.num_kv_heads % tp != 0:
            rules = rules.replace(kv_heads_act=None, kv=None)
        if cfg.family in ("ssm", "hybrid") and cfg.num_heads % tp != 0:
            rules = rules.replace(ssm_heads=None)
        if cfg.seq_parallel and shape.kind == "train":
            rules = rules.replace(seq_res="model")
    return ShardCtx.for_mesh(mesh, rules)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(ctx: ShardCtx, axes) -> tuple | None:
    """An input's spec; ``None`` without a mesh (as the reference's
    ``ShapeDtypeStruct`` then has no sharding)."""
    return None if ctx.mesh is None else ctx.spec(axes)


def input_specs(cfg: ModelConfig, shape: ShapeSuite,
                ctx: ShardCtx) -> tuple[dict, dict]:
    """``(inputs, specs)``: ``meta`` tensors for every model input of this
    (arch, shape) cell and a tree of their specs beside them (``None``
    leaves without a mesh).

    train / prefill: ``{"batch": ...}``; decode: ``{"caches", "tokens",
    "cache_index"}``, the caches built by ``lm.init_cache`` on ``meta``."""
    b, s = shape.global_batch, shape.seq_len
    act_dt = act_dtype(cfg)
    i32 = torch.int32
    tok_axes = ("batch", "seq")

    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {}
        specs: dict[str, Any] = {}
        if cfg.family == "audio":
            batch["embeds"] = _meta((b, s, cfg.d_model), act_dt)
            specs["embeds"] = _spec(ctx, ("batch", "seq", "embed_act"))
        elif cfg.family == "vlm":
            n_img = cfg.num_image_tokens
            batch["tokens"] = _meta((b, s - n_img), i32)
            specs["tokens"] = _spec(ctx, tok_axes)
            batch["image_embeds"] = _meta((b, n_img, cfg.d_model), act_dt)
            specs["image_embeds"] = _spec(ctx, ("batch", "seq", "embed_act"))
        else:
            batch["tokens"] = _meta((b, s), i32)
            specs["tokens"] = _spec(ctx, tok_axes)
        if shape.kind == "train":
            tgt_s = s - cfg.num_image_tokens if cfg.family == "vlm" else s
            batch["targets"] = _meta((b, tgt_s), i32)
            specs["targets"] = _spec(ctx, tok_axes)
        return {"batch": batch}, {"batch": specs}

    caches = lm.init_cache(cfg, b, s, device="meta")
    return ({"caches": caches, "tokens": _meta((b,), i32),
             "cache_index": _meta((b,), i32)},
            {"caches": cache_sharding(cfg, ctx, caches),
             "tokens": _spec(ctx, ("batch",)),
             "cache_index": _spec(ctx, ("batch",))})


def cache_sharding(cfg: ModelConfig, ctx: ShardCtx, caches) -> Any:
    """The spec of every leaf of a cache tree (``lm.init_cache``), keyed on
    its path as the block kinds lay them out: a Mamba state ``(L, n, B, H,
    P, N)`` and conv window ``(L, n, B, ...)``; an mLSTM cell ``(L, n, B,
    H, ...)`` (replicated over "model"); an sLSTM state ``(L, B, H, hd)``;
    a GQA k/v ``(L, B, T, KV, hd)``; an MLA latent ``(L, B, T, rank)``.
    ``None`` everywhere without a mesh."""
    if ctx.mesh is None:
        return map_with_path(lambda p, t: None, caches)

    def spec_for(path: str, t: torch.Tensor):
        nd = t.dim()

        def pad(axes):
            return ctx.spec(tuple(axes) + (None,) * (nd - len(axes)))

        if "mamba" in path:
            if nd >= 6:
                return pad(("layers", None, "batch", "ssm_heads_act"))
            return pad(("layers", None, "batch"))
        if "mlstm" in path:
            return pad(("layers", None, "batch"))
        if "slstm" in path:
            return pad(("layers", "batch"))
        if nd == 5:
            kv_ok = cfg.num_kv_heads % max(
                1, ctx.axis_size("kv_heads_act")) == 0
            kv_ax = "kv_heads_act" if kv_ok else None
            return ctx.spec(("layers", "batch", "kv_seq", kv_ax, None))
        if nd == 4:
            return ctx.spec(("layers", "batch", "kv_seq", None))
        return pad(("layers", "batch"))

    return map_with_path(spec_for, caches)
