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
``axis_names`` and an ordered ``shape``); ``local_shape`` rounds an uneven
split up, the shard XLA pads to.

A run on a mesh holds a ``torch.distributed`` ``DeviceMesh`` beside the
description (``ShardCtx.device_mesh``), and the specs become DTensor
placements, PyTorch's counterparts of the reference's pieces:

    reference (JAX)          | here
    -------------------------+---------------------------------------------
    Mesh                     | DeviceMesh
    PartitionSpec            | placements: Shard(d) / Replicate() per mesh
                             | dim; an entry naming several mesh axes gives
                             | Shard(d) on each of them, major to minor
    with_sharding_constraint | ``ShardCtx.constrain``: ``redistribute``
    shard_map                | ``shard_map_compat``: ``local_map``
    GSPMD's partial sums     | ``Partial`` placements

DTensor splits an uneven dimension as ``torch.chunk`` does (the last
shards are smaller, or empty); XLA pads every shard to the rounded-up
size (``spec_local_shape``).  The values are the same; the shapes of the
last shards differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

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


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of one parameter tensor: its shape, the logical axis
    name of each dimension (``parallel/sharding.py`` maps them onto a
    mesh) and its initializer.  The JAX package's ParamDecl without the
    storage dtype: every leaf takes the model's dtype, as the JAX
    package's ``init_tree`` casts it."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"  # fan_in | ones | zeros | normal
    scale: float = 1.0

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")



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


# ---------------------------------------------------------------------------
# Placements: the specs on a DeviceMesh
# ---------------------------------------------------------------------------


def is_device_mesh(mesh) -> bool:
    return mesh is not None and hasattr(mesh, "mesh_dim_names") \
        and hasattr(mesh, "get_group")


def placements(spec: Spec | None, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``MeshSpec`` or a
    ``DeviceMesh``): per mesh dim, ``Shard(d)`` where the spec's entry
    ``d`` names that axis, else ``Replicate()``.  An entry naming several
    axes shards its dim over each, major to minor, so their order must be
    the mesh's."""
    names = tuple(mesh.mesh_dim_names if is_device_mesh(mesh)
                  else mesh.axis_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec or ()):
        used = [n for n in _names(e) if n in names]
        idx = [names.index(n) for n in used]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} orders mesh axes unlike the "
                             f"mesh {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(pls: Sequence, mesh) -> Spec:
    """The inverse of :func:`placements` (``Partial`` reads as replicated)."""
    names = tuple(mesh.mesh_dim_names if is_device_mesh(mesh)
                  else mesh.axis_names)
    dims = [p.dim for p in pls if isinstance(p, Shard)]
    out = [None] * ((max(dims) + 1) if dims else 0)
    for n, p in zip(names, pls):
        if isinstance(p, Shard):
            e = out[p.dim]
            out[p.dim] = n if e is None else (_names(e) + (n,))
    return tuple(out)


def as_dtensor(x, device_mesh):
    """``x`` as a DTensor on ``device_mesh``; a plain tensor is a value
    every rank holds whole (replicated); ``None`` stays ``None``."""
    if x is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def redistribute(x, device_mesh, pls: Sequence):
    """``x`` laid out as ``pls`` (no collective if it already is)."""
    x = as_dtensor(x, device_mesh)
    if tuple(x.placements) == tuple(pls):
        return x
    return x.redistribute(device_mesh, tuple(pls))


def named_sharding_tree(specs, device_mesh):
    """The placements of every leaf of a spec tree (the reference's
    ``NamedSharding`` tree)."""
    return map_decls(lambda s: placements(s, device_mesh), specs)


def distribute_tree(tree, specs, device_mesh):
    """Place a tree of whole tensors (dicts, NamedTuples, dataclasses) by
    the spec at the same place in ``specs``: every rank holds the same
    values (parameters drawn from one seed or converted from JAX, cold
    caches) and keeps its own shard, no collective.  ``None`` stays
    ``None`` (a train state without a carry)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], device_mesh)
                for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(distribute_tree(t, sp, device_mesh)
                            for t, sp in zip(tree, specs)))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: distribute_tree(getattr(tree, f.name),
                                    getattr(specs, f.name), device_mesh)
            for f in dataclasses.fields(tree)})
    return distribute_tensor(tree.detach(), device_mesh,
                             placements(specs, device_mesh),
                             src_data_rank=None)


@contextlib.contextmanager
def spmd(ctx: "ShardCtx"):
    """The region a sharded call runs in: plain tensors mixed with DTensors
    are values every rank holds whole (positions, masks, constants).  A
    no-op off a running mesh."""
    if ctx is None or ctx.device_mesh is None or \
            DTensor._op_dispatcher._allow_implicit_replication:
        yield  # off a mesh, or inside a region already (the context
        return  # manager below switches off on exit, it does not restore)
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def full_tree(tree):
    """Every DTensor leaf of a tree gathered whole (plain tensors as they
    are): what a checkpoint writes and what a rank-0 report reads."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full_tree(v) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: full_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    return tree


def whole(x):
    """A tensor's whole value: a DTensor gathered (no collective when it
    is replicated), a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def laid_out_as(x: torch.Tensor, ref):
    """A whole tensor ``x`` (the same on every rank) laid out as the
    DTensor ``ref`` (each rank keeps its shard, no collective); ``x`` as
    it is when ``ref`` is a plain tensor."""
    if not isinstance(ref, DTensor):
        return x
    return distribute_tensor(x, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (computed, not read
    off a ``meta`` tensor: the dry-run counts every allocation, ``meta``
    ones too)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(d), 1)
    return tuple(reversed(out))


def with_shape(x, shape: Sequence[int]):
    """A DTensor ``x`` with the global ``shape`` it has: ``local_map``
    infers an output's global shape as if every shard were as large as
    this rank's, which an uneven split (36 heads over 16 ranks: 3 a rank,
    none on the last four) overstates.  ``x`` as it is when it agrees."""
    if not isinstance(x, DTensor) or tuple(x.shape) == tuple(shape):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def grad_laid_out_as_value(x):
    """A DTensor ``x`` as it is, whose gradient is redistributed to ``x``'s
    placements where it arrives here (``from_local``'s backward does
    that), before it flows further back; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def reshape_whole(x, shape: Sequence[int], dim: int, parts: int):
    """``x.reshape(shape)``, a view that splits dim ``dim`` of ``x`` into
    ``parts`` leading pieces (heads) or merges ``parts`` pieces into it.
    DTensor cannot view a split that does not divide ``parts`` (36 heads
    over 16 ranks), where GSPMD pads the shards.  So on a mesh with a dim
    that does not divide ``parts``, ``dim`` is gathered whole over such mesh
    dims first (an all-gather, where they split it), and the gradient is
    laid out as the view's value where it flows back through the view (it
    may arrive split there)."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    mesh = x.device_mesh
    bad = [i for i in range(mesh.ndim) if parts % mesh.size(i)]
    if not bad:
        return x.reshape(shape)
    pls = tuple(Replicate() if i in bad and isinstance(p, Shard)
                and p.dim == dim else p for i, p in enumerate(x.placements))
    return grad_laid_out_as_value(redistribute(x, mesh, pls).reshape(shape))


def write_rows_(live, new, ax: int, slots: Sequence[int],
                rows: Sequence[int]) -> None:
    """Rows ``rows`` of ``new`` along ``ax`` into slots ``slots`` of
    ``live``, in place (a copy, so ``new``'s dtype is cast).  A DTensor
    ``live`` split along ``ax`` is written by the ranks whose shard holds
    each slot: ``new`` is laid out as ``live`` with ``ax`` whole (no
    collective when it already is: a wave prefilled with the batch
    replicated), and each rank copies the rows that land in its shard.
    ``slots`` and ``rows`` are host ints, so no rank reads the card to
    find its rows."""
    if not isinstance(live, DTensor):
        new = whole(new)
        for slot, row in zip(slots, rows):
            live.narrow(ax, slot, 1).copy_(new.narrow(ax, row, 1))
        return
    pls = tuple(Replicate() if isinstance(p, Shard) and p.dim == ax else p
                for p in live.placements)
    src = redistribute(new, live.device_mesh, pls).to_local()
    local = live.to_local()
    start = shard_offset(live.shape, live.device_mesh, live.placements)[ax]
    for slot, row in zip(slots, rows):
        if start <= slot < start + local.shape[ax]:
            local.narrow(ax, slot - start, 1).copy_(src.narrow(ax, row, 1))


def local_shard(global_shape, device_mesh, pls) -> tuple[tuple[int, ...],
                                                         tuple[int, ...]]:
    """This rank's shard of a tensor of ``global_shape`` laid out as
    ``pls``: its shape and its global offset (torch.chunk splits)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    shape, offset = compute_local_shape_and_global_offset(
        tuple(global_shape), device_mesh, tuple(pls))
    return tuple(shape), tuple(offset)


def shard_offset(global_shape, device_mesh, pls) -> tuple[int, ...]:
    """The global offset of this rank's shard (torch.chunk splits)."""
    return local_shard(global_shape, device_mesh, pls)[1]


def shard_map_compat(f, mesh, *, in_specs, out_specs, in_grad_specs=None):
    """Per-device mapping: ``f`` runs on each rank's local shards, as the
    reference's ``shard_map``; collectives inside are ``f``'s own.
    ``in_specs`` holds one spec per argument (``None`` for a non-tensor);
    ``out_specs`` is one spec, or a list of specs for several outputs.
    ``in_grad_specs`` (per argument) lays out the inputs' gradients where
    they differ from the inputs (a replicated weight of sharded rows gets
    ``Partial`` sums: pass the placements themselves)."""
    def pl(s):
        if s is None:
            return None
        if isinstance(s, tuple) and s and not isinstance(s[0], (str, tuple,
                                                               type(None))):
            return s  # placements already
        return placements(s, mesh)

    # local_map reads a tuple as several outputs' placements
    out = (tuple(pl(s) for s in out_specs) if isinstance(out_specs, list)
           else list(pl(out_specs)))
    grads = (None if in_grad_specs is None
             else tuple(pl(s) for s in in_grad_specs))
    from torch.distributed.tensor.experimental import local_map
    return local_map(f, out_placements=out,
                     in_placements=tuple(pl(s) for s in in_specs),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def even_placements(ctx: "ShardCtx", axes: Sequence[str | None],
                    shape: Sequence[int]) -> tuple:
    """The placements of a tensor of ``shape`` whose dims carry ``axes``,
    with a dim its mesh dims do not divide left whole: ``local_map`` takes
    even shards (it infers the global shape from this rank's)."""
    spec = list(ctx.spec(axes))
    spec += [None] * (len(shape) - len(spec))
    for i, e in enumerate(spec):
        if e is not None and int(shape[i]) % entry_size(ctx.mesh, e):
            spec[i] = None
    return placements(tuple(spec), ctx.device_mesh)


def grad_of_replicated(pls: Sequence, outs: Sequence[Sequence]) -> tuple:
    """An input's gradient placements for a ``local_map``: ``Partial`` on
    each mesh dim where the input is replicated but an output is split or
    a partial sum (each rank's output part contributes its share), else
    the input's own."""
    return tuple(Partial() if isinstance(p, Replicate)
                 and any(isinstance(o[i], (Shard, Partial)) for o in outs)
                 else p for i, p in enumerate(pls))


def map_local(fn: Callable, ctx: "ShardCtx", args: Sequence,
              in_axes: Sequence, out_like: Sequence[int],
              summed: str | None = None):
    """``fn`` over each rank's local shards of ``args`` (tensors, the same
    values on every rank where replicated), laid out by ``in_axes`` (one
    tuple of logical axes per argument) as ``even_placements``; output
    ``j`` is laid out as argument ``out_like[j]`` (its dims whole where
    that argument's are).  For work that is independent across the split
    dims (rows, heads): it runs as plain tensor code on each rank, where
    DTensor's rules for some ops (a batched matmul over two split dims, a
    cumsum's backward) fail to plan on some PyTorch versions.  One output
    comes back as a tensor, several as a tuple.  ``summed``: a logical
    axis over whose mesh dims ``fn`` splits the work itself (the
    arguments whole over them, ``ShardCtx.entry_rank`` its share): each
    rank's outputs hold its share and zeros, partial sums over those dims,
    as the arguments' gradients are."""
    mesh = ctx.device_mesh
    in_pls = [even_placements(ctx, a, t.shape)
              for a, t in zip(in_axes, args)]
    out_pls = [in_pls[i] for i in out_like]
    if summed is not None:
        dims = ctx.mesh_dims(summed)
        out_pls = [tuple(Partial() if i in dims else p
                         for i, p in enumerate(pls)) for pls in out_pls]
    mapped = shard_map_compat(
        fn, mesh, in_specs=tuple(in_pls),
        out_specs=out_pls if len(out_pls) > 1 else out_pls[0],
        in_grad_specs=tuple(grad_of_replicated(p, out_pls) for p in in_pls))
    return mapped(*(as_dtensor(t, mesh) for t in args))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh and the rules that map logical axes onto it.  ``mesh`` is
    the description (``MeshSpec``), ``device_mesh`` the ``DeviceMesh`` of a
    run on it (``None``: layouts only, as the dry-run's).  ``mesh=None``
    is no mesh: every spec is replicated, every shard the whole tensor and
    ``constrain`` a no-op."""

    mesh: Any = None
    rules: ShardingRules = TRAIN_RULES
    device_mesh: Any = None

    @staticmethod
    def for_mesh(mesh, rules: ShardingRules = TRAIN_RULES) -> "ShardCtx":
        """``mesh``: a ``MeshSpec``, a ``DeviceMesh`` (the run's) or None."""
        dm = None
        if is_device_mesh(mesh):
            from repro_torch.launch.mesh import mesh_spec
            dm, mesh = mesh, mesh_spec(mesh)
        return ShardCtx(mesh=mesh, rules=rules_for_mesh(rules, mesh),
                        device_mesh=dm)

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

    @property
    def running(self) -> bool:
        """Whether this context runs on a process mesh."""
        return self.device_mesh is not None

    def sharding(self, axes: Sequence[str | None]):
        """The placements of a tensor whose dims carry ``axes`` (``None``
        off a running mesh): the reference's ``NamedSharding``."""
        if self.device_mesh is None:
            return None
        return placements(self.spec(axes), self.device_mesh)

    def constrain(self, x, axes: Sequence[str | None]):
        """``x`` redistributed to ``rules.spec(axes)``; a no-op off a
        running mesh.  A plain tensor is taken as replicated."""
        if self.device_mesh is None:
            return x
        return redistribute(x, self.device_mesh, self.sharding(axes))

    def mesh_dims(self, logical: str) -> tuple[int, ...]:
        """The indices of the running mesh's dims behind a logical axis."""
        names = tuple(self.device_mesh.mesh_dim_names)
        return tuple(names.index(n) for n in
                     _names(self.rules.physical(logical)) if n in names)

    def entry_rank(self, logical: str) -> int:
        """This rank's shard of a dim that carries ``logical``: its index
        over the mesh axes behind it, major to minor (0 off a running
        mesh)."""
        idx = 0
        for name in _names(self.rules.physical(logical)):
            idx = idx * self.mesh_size(name) + self.axis_rank(name)
        return idx

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along one mesh axis (0 if absent)."""
        if self.device_mesh is None or axis not in self.mesh.axis_names:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def mesh_size(self, axis: str) -> int:
        """The size of one mesh axis (1 if absent)."""
        if self.mesh is None:
            return 1
        return self.mesh.shape.get(axis, 1)


NULL_CTX = ShardCtx(mesh=None,
                    rules=ShardingRules({k: None for k in _base_table()}))
