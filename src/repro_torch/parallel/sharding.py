"""Logical-axis sharding vocabulary: the rules, the specs and the shard
context.

The port of ``repro/parallel/sharding.py``.  Every parameter is declared
once (:class:`~repro_torch.models.layers.ParamDecl`: shape, logical axis
names, initializer); a :class:`ShardingRules` table maps the logical names
onto the axes of a mesh, so one declaration gives the spec of every leaf on
no mesh, the one-card mesh, the (data=16, model=16) single-pod mesh and the
(pod=2, data=16, model=16) multi-pod mesh.

A spec is a plain tuple with one entry per dimension: ``None``
(replicated), a mesh axis name, or a tuple of mesh axis names (the
dimension is split over their product).  It stands in for JAX's
``PartitionSpec``.  A mesh is a description (``launch/mesh.MeshSpec``:
``axis_names`` and an ordered ``shape``): this module computes layouts and
per-device shapes; it runs nothing on a mesh.  ``local_shape`` rounds an
uneven split up, the shard XLA pads to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch

# a mesh axis name, a tuple of them, or None (replicated)
RuleValue = Any
Spec = tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to physical mesh axes."""

    table: Mapping[str, RuleValue]

    def physical(self, logical: str | None) -> RuleValue:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.table[logical]

    def spec(self, axes: Sequence[str | None]) -> Spec:
        """The spec of a tensor whose dims carry these logical names.  A
        mesh axis is used at most once: a later dimension that would use it
        again is replicated (a small tensor with "model" on two dims)."""
        seen: set[str] = set()
        out = []
        for p in (self.physical(a) for a in axes):
            names = _names(p)
            if any(n in seen for n in names):
                out.append(None)
                continue
            seen.update(names)
            out.append(p)
        return tuple(out)

    def replace(self, **updates: RuleValue) -> "ShardingRules":
        new = dict(self.table)
        new.update(updates)
        return ShardingRules(new)


def _names(entry: RuleValue) -> tuple[str, ...]:
    """The mesh axis names of one spec entry."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _base_table(**overrides: RuleValue) -> dict[str, RuleValue]:
    table: dict[str, RuleValue] = {
        # activations
        "batch": ("pod", "data"),  # global batch: DP over pods x data
        "seq": None,               # query / sequence axis
        "seq_res": None,           # residual-stream sequence (SP shards it)
        "kv_seq": None,            # KV-cache length
        "embed_act": None,         # activation d_model
        "heads_act": "model",      # per-head activations (TP)
        "kv_heads_act": "model",   # KV heads (None where indivisible)
        "mlp_act": "model",        # d_ff activations
        "vocab_act": "model",      # logits' vocab axis
        "expert_act": "model",     # per-expert token buffers
        "ssm_heads_act": "model",  # SSM / mLSTM heads
        # weights
        "embed": None,             # d_model of weights (ZeRO-1 shards the
        #                            optimizer state over "data")
        "vocab": "model",
        "heads": "model",          # flattened num_heads * head_dim
        "kv": "model",             # flattened num_kv_heads * head_dim
        "mlp": "model",
        "expert": "model",         # expert-parallel axis of expert stacks
        "expert_mlp": None,        # intra-expert d_ff
        "layers": None,            # stacked-layer leading axis
        "ssm_inner": "model",
        "ssm_heads": "model",      # per-head SSM parameters (A, D, dt bias)
        "ssm_state": None,
        "conv": None,
        "lora": None,              # MLA low-rank bottleneck
        "qn_mem": None,            # quasi-Newton memory axis
        "flat": None,              # flattened DEQ feature axis
        "scale": None,
    }
    table.update(overrides)
    return table


# training / prefill: shard the batch, replicate the sequence
TRAIN_RULES = ShardingRules(_base_table())
# training with sequence parallelism: the residual stream between blocks is
# split over "model" along the sequence
TRAIN_SP_RULES = ShardingRules(_base_table(seq_res="model"))
# decode: the KV cache's length is split over "model" and the attention
# heads are replicated (a second owner of "model" would gather the cache)
DECODE_RULES = ShardingRules(_base_table(
    kv_seq="model", heads_act=None, kv_heads_act=None))
# prefill: writes the decode layout's cache, attention stays head-sharded
PREFILL_RULES = ShardingRules(_base_table(kv_seq="model"))
# long-context decode at batch 1: the cache's length over the DP axes
LONG_CONTEXT_RULES = ShardingRules(_base_table(
    batch=None, kv_seq=("pod", "data"), seq=None))


def rules_for_mesh(rules: ShardingRules, mesh) -> ShardingRules:
    """Drop the mesh axes a mesh lacks (no "pod" on one pod); a 1-tuple
    left over unwraps to its name, so specs compare equal to the plain
    form.  ``mesh=None`` replicates everything."""
    if mesh is None:
        return ShardingRules({k: None for k in rules.table})
    names = set(mesh.axis_names)

    def fix(v: RuleValue) -> RuleValue:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    return ShardingRules({k: fix(v) for k, v in rules.table.items()})


# ---------------------------------------------------------------------------
# Trees of declarations
# ---------------------------------------------------------------------------


def map_decls(fn: Callable, tree):
    """``fn`` applied to every declaration of a (nested dict) tree."""
    if isinstance(tree, dict):
        return {k: map_decls(fn, v) for k, v in tree.items()}
    return fn(tree)


def spec_tree(decls, rules: ShardingRules):
    """The spec of every declaration."""
    return map_decls(lambda d: rules.spec(d.axes), decls)


def shape_tree(decls, dtype: torch.dtype) -> dict:
    """``meta`` tensors of the declared shapes in ``dtype`` (no storage is
    allocated)."""
    return map_decls(
        lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), decls)


def zero1_spec(decl, rules: ShardingRules, zero_axis: str = "data",
               zero_size: int = 0) -> Spec:
    """The ZeRO-1 optimizer-state spec: the parameter's spec with its
    largest replicated dimension also split over ``zero_axis``, when that
    axis is not used yet and (``zero_size`` > 1) divides it.  ``zero_size``
    0 skips the divisibility test."""
    base = rules.spec(decl.axes)
    entries = list(base) + [None] * (len(decl.shape) - len(base))
    used = {n for e in entries for n in _names(e)}
    if zero_axis in used:
        return base
    zdim, best = -1, 0
    for i, (dim, e) in enumerate(zip(decl.shape, entries)):
        divisible = zero_size <= 1 or dim % zero_size == 0
        if e is None and dim > best and divisible:
            zdim, best = i, dim
    if zdim < 0:
        return base
    entries[zdim] = zero_axis
    return tuple(entries)


def zero1_spec_tree(decls, rules: ShardingRules, zero_axis: str = "data",
                    zero_size: int = 0):
    return map_decls(lambda d: zero1_spec(d, rules, zero_axis, zero_size),
                     decls)


# ---------------------------------------------------------------------------
# Per-device shapes
# ---------------------------------------------------------------------------


def entry_size(mesh, entry: RuleValue) -> int:
    """The number of shards one spec entry splits a dimension into."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape[n] for n in _names(entry))


def spec_local_shape(shape: Sequence[int], spec: Spec | None,
                     mesh) -> tuple[int, ...]:
    """One device's shard of ``shape`` under ``spec``: each split dimension
    divided by its shard count, rounded up (an uneven split pads its last
    shard, as XLA does).  ``spec=None`` is replicated."""
    spec = tuple(spec or ())
    spec = spec + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(d) // entry_size(mesh, e)) for d, e in zip(shape,
                                                                  spec))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh description and the rules that map logical axes onto it.
    ``mesh=None`` is no mesh: every spec is replicated and every shard the
    whole tensor."""

    mesh: Any = None
    rules: ShardingRules = TRAIN_RULES

    @staticmethod
    def for_mesh(mesh, rules: ShardingRules = TRAIN_RULES) -> "ShardCtx":
        return ShardCtx(mesh=mesh, rules=rules_for_mesh(rules, mesh))

    def spec(self, axes: Sequence[str | None]) -> Spec:
        return self.rules.spec(axes)

    def axis_size(self, logical: str) -> int:
        """The product of the mesh axis sizes behind a logical axis."""
        if self.mesh is None:
            return 1
        return entry_size(self.mesh, self.rules.physical(logical))

    def local_shape(self, shape: Sequence[int],
                    axes: Sequence[str | None]) -> tuple[int, ...]:
        """One device's shard of a tensor whose dims carry ``axes``."""
        return spec_local_shape(shape, self.spec(axes), self.mesh)


NULL_CTX = ShardCtx(mesh=None,
                    rules=ShardingRules({k: None for k in _base_table()}))
