"""Layout: logical-axis sharding rules and per-device shapes."""

from repro_torch.parallel.sharding import (
    DECODE_RULES,
    LONG_CONTEXT_RULES,
    TRAIN_RULES,
    ParamDecl,
    ShardCtx,
    ShardingRules,
    named_sharding_tree,
    spec_tree,
    zero1_spec,
)

__all__ = [
    "ParamDecl",
    "ShardCtx",
    "ShardingRules",
    "TRAIN_RULES",
    "DECODE_RULES",
    "LONG_CONTEXT_RULES",
    "spec_tree",
    "named_sharding_tree",
    "zero1_spec",
]
