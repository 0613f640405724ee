"""Dry-run: lay out and cost every (arch x shape x mesh) cell on the host.

The port of ``repro/launch/dryrun.py``.  The reference compiles each cell
for a forced-CPU mesh of 256 or 512 devices and reads XLA's memory and cost
analyses and the compiled HLO.  Eager PyTorch has no single-process SPMD
compiler, so the port runs the real sharded step in a world of its own: a
``single`` or ``multi`` cell opens a ``fake`` process group of 256 or 512
ranks in one process (``launch/mesh.init_fake_world``; collectives move
nothing), builds the ``DeviceMesh`` of the cell's ``MeshSpec``, places the
cell's ``meta`` structs on it (``parallel/sharding.distribute_tree``) and
runs the step every rank runs (``steps.build_train_step(ctx=)``,
``build_prefill``, ``build_decode_step``) as rank 0.  ``one`` opens no
group and runs the unsharded step.

  * ``memory`` -- per-device bytes on the chosen mesh (``launch/mesh.py``:
    ``single`` (data=16, model=16), ``multi`` (pod=2, data=16, model=16),
    ``one`` (data=1, model=1), one H100).  ``argument_bytes`` sums the
    step's inputs (``launch/steps.py``'s struct trees, ``configs/shapes.py``'s
    inputs) over each leaf's shard (``parallel/sharding.py``'s
    ``spec_local_shape``, uneven splits rounded up); ZeRO-1 moments follow
    ``zero1_spec``.  ``output_bytes`` sums the step's outputs the same way
    and ``alias_bytes`` the donated inputs (the train state; a decode
    step's caches).  ``temp_bytes`` is rank 0's peak of the bytes the step
    allocates in its local shards (``LiveBytes``: every storage rounded up
    to the caching allocator's 512-byte block; the step's outputs and the
    collectives' buffers count among them, XLA's temp does not);
    ``argument_bytes + temp_bytes`` is the peak one device would see.
    ``run_seconds`` is that run's wall time.  ``collectives`` holds every
    collective the step issued (``Collectives``: DTensor's functional ones
    and the plain ``c10d`` calls) as per-device link bytes and counts by
    kind (``collective_bytes``), every layer and solver step counted as
    it runs; the reference's ``collectives_loop_counted_once`` reads a
    scanned body once.
  * ``cost`` -- the real step on ``meta`` under ``FlopCounterMode`` at two
    reduced depths ``L0`` and ``L0 + p`` (``p`` the arch's layer period; a
    DEQ at 2 and 4 solver steps with ``unroll``, whose cost is linear in
    the iterations), extrapolated as the reference does: ``cost(L) =
    cost(L0) + (L - L0) * delta``, ``delta`` per layer (or solver step).
    ``flops`` counts the whole step's matrix products (the global batch,
    all devices together; the unsharded step).  ``bytes`` sums every aten
    op's input and output bytes (views excluded): eager PyTorch runs every
    op unfused, where XLA counts after fusion.  ``collective_bytes`` is the
    sharded step's per-device link bytes at each depth on the cell's fake
    mesh (0 on ``one``), extrapolated the same way.

On ``meta`` nothing is computed: kernel ops take the CPU's routes
(``kernels/ops.py``), attention by ``attention_route``'s CPU policy (the
plain version, or the chunked ``flash_xla`` path at 2^20 score cells and
more), and a DEQ solve runs ``unroll``'s ``max_steps`` iterations.

    python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k \\
        --variant cost --mesh single
    python -m repro_torch.launch.dryrun --all [--jobs 8]

Results go to ``results/dryrun_torch/`` (``--out``), one JSON per cell.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import signal
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    ShapeSuite,
    cache_sharding,
    cell_skip_reason,
    input_specs,
    make_ctx,
    valid_cells,
)
from repro_torch.launch import steps
from repro_torch.launch.mesh import (
    ONE_CARD,
    build_device_mesh,
    init_fake_world,
    make_production_mesh,
)
from repro_torch.models import lm
from repro_torch.models.layers import act_dtype
from repro_torch.parallel.sharding import (
    distribute_tree,
    spec_local_shape,
)

RESULTS_DIR = Path("results/dryrun_torch")
# the CUDA caching allocator's block: every allocation rounds up to it
BLOCK = 512
MESHES = ("single", "multi", "one")


def mesh_for(kind: str):
    if kind == "one":
        return ONE_CARD
    if kind not in ("single", "multi"):
        raise ValueError(f"mesh {kind!r}; expected one of {MESHES}")
    return make_production_mesh(multi_pod=kind == "multi")


@contextlib.contextmanager
def fake_world(mesh):
    """A ``fake`` process group of ``mesh.size`` ranks, this process rank
    0, and the ``DeviceMesh`` of ``mesh`` on it (CPU); the group is
    destroyed on exit."""
    import torch.distributed as dist

    init_fake_world(mesh.size)
    try:
        yield build_device_mesh(mesh, "cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# trees and bytes
# ---------------------------------------------------------------------------


def leaves_with_specs(tree, specs=None) -> list[tuple[torch.Tensor, Any]]:
    """Every tensor of ``tree`` (dicts, NamedTuples, dataclasses, None)
    with the spec at the same place in ``specs`` (``None``: replicated)."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_specs(
            v, None if specs is None else specs[k])]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree) for x in leaves_with_specs(
            v, None if specs is None else specs[i])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in leaves_with_specs(
                    getattr(tree, f.name),
                    None if specs is None else getattr(specs, f.name))]
    return []


def _round(n: int, block: int) -> int:
    return -(-n // block) * block


def tree_bytes(tree, specs, mesh, block: int = 1) -> int:
    """One device's bytes of a tree on ``mesh``: each leaf's shard, rounded
    up to ``block`` bytes (``BLOCK``: as the caching allocator holds it)."""
    return sum(_round(math.prod(spec_local_shape(t.shape, s, mesh))
                      * t.element_size(), block)
               for t, s in leaves_with_specs(tree, specs))


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------


def _layer_period(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.ssm.attn_every
    if cfg.family == "ssm":
        return cfg.xlstm.slstm_every
    return 1


def _reduced_depths(cfg: ModelConfig) -> tuple[int, int]:
    """Two depths whose difference is one whole layer period."""
    p = _layer_period(cfg)
    if cfg.family == "moe":
        base = cfg.moe.first_k_dense + 1
        return base, base + 1
    return p, 2 * p


def _costing_config(cfg: ModelConfig, num_layers: int) -> ModelConfig:
    """``cfg`` at ``num_layers`` as it runs on ``meta``: a DEQ solve
    unrolled (no host read can be made there).  ``scan_layers`` and
    ``attn_unroll`` are the reference's; the eager port runs either
    way."""
    kw = dict(scan_layers=False, attn_unroll=True, num_layers=num_layers)
    if cfg.deq.enabled:
        kw["deq"] = dataclasses.replace(cfg.deq, unroll=True)
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass
class Cell:
    """A step on ``meta`` inputs: ``fn(*args)``, a spec tree beside each
    argument, the donated arguments and the spec of each output."""

    fn: Callable
    args: tuple
    specs: tuple
    donate: tuple[int, ...]
    out_specs: Callable  # the step's outputs -> their spec tree


def build_cell(cfg: ModelConfig, shape: ShapeSuite, mesh,
               tcfg: TrainConfig) -> Cell:
    """The cell's step and its ``meta`` inputs.  Donation follows the
    production step: the train state and a decode step's caches are
    updated in place (the outputs alias them).  ``mesh`` a ``MeshSpec``
    (or None): the unsharded step, with the specs of that mesh; a
    ``DeviceMesh`` (a fake world's): the sharded step, its inputs placed
    as DTensors over ``meta`` shards."""
    ctx = make_ctx(cfg, mesh, shape)
    inputs, in_specs = input_specs(cfg, shape, ctx)
    if shape.kind == "train":
        state, sspec = steps.train_state_structs(cfg, tcfg, ctx)
        cell = Cell(steps.build_train_step(cfg, tcfg, ctx=ctx),
                    (state, inputs["batch"]), (sspec, in_specs["batch"]),
                    (0,), lambda out: (sspec, {k: () for k in out[1]}))
    else:
        params, pspec = steps.param_structs(cfg, ctx)
        if shape.kind == "prefill":
            def prefill_specs(out):
                return (ctx.spec(("batch", "seq", "vocab_act")),
                        cache_sharding(cfg, ctx, out[1]),
                        ctx.spec(("batch",)))

            cell = Cell(steps.build_prefill(cfg, ctx, shape.seq_len),
                        (params, inputs["batch"]),
                        (pspec, in_specs["batch"]), (), prefill_specs)
        else:
            cell = Cell(steps.build_decode_step(cfg, ctx),
                        (params, inputs["caches"], inputs["tokens"],
                         inputs["cache_index"]),
                        (pspec, in_specs["caches"], in_specs["tokens"],
                         in_specs["cache_index"]), (1,),
                        lambda out: (ctx.spec(("batch", "vocab_act")),
                                     in_specs["caches"]))
    if ctx.running:
        cell.args = tuple(distribute_tree(a, sp, ctx.device_mesh)
                          for a, sp in zip(cell.args, cell.specs))
    return cell


def output_structs(cfg: ModelConfig, shape: ShapeSuite, tcfg: TrainConfig,
                   cell: Cell):
    """The step's outputs as ``meta`` tensors, without running it: the
    new train state and its 0-d metrics; a prefill's logits, fresh caches
    and lengths; a decode step's logits and caches."""
    dt = act_dtype(cfg)
    b = shape.global_batch
    scalar = torch.empty((), dtype=torch.float32, device="meta")
    if shape.kind == "train":
        return cell.args[0], {k: scalar for k in train_metrics(cfg, tcfg)}
    if shape.kind == "prefill":
        seq = shape.seq_len  # the audio encoder's: a full encode
        logits = torch.empty((b, seq, cfg.padded_vocab), dtype=dt,
                             device="meta")
        return (logits, lm.init_cache(cfg, b, seq, device="meta"),
                torch.empty((b,), dtype=torch.int32, device="meta"))
    return (torch.empty((b, cfg.padded_vocab), dtype=dt, device="meta"),
            cell.args[1])


def train_metrics(cfg: ModelConfig, tcfg: TrainConfig) -> list[str]:
    """The names of the 0-d tensors a train step's metrics hold."""
    names = ["nll", "z", "tokens"]
    names += ["deq_residual"] if cfg.deq.enabled else ["moe_aux", "moe_z"]
    names += ["loss", "grad_norm", "lr"]
    if tcfg.skip_nonfinite:
        names += ["update_skipped", "consec_skips"]
    return names


# ---------------------------------------------------------------------------
# running a step on meta
# ---------------------------------------------------------------------------


def _on_dtensors(types) -> bool:
    """Whether an op has DTensor operands: a mode then lets DTensor run it
    first and sees the local ops (and collectives) it turns into."""
    return any(issubclass(t, DTensor) for t in types)


def _propagating() -> bool:
    """Whether DTensor is propagating shardings: it runs the op on fake
    tensors of the global shapes, which allocate nothing."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages ops allocate while it is on, each rounded
    up to ``block``, with their peak; a storage leaves the count when it is
    freed.  An op's output that shares an input's storage (a view, an
    in-place op) allocates nothing, so storages that existed before (the
    step's arguments) are never counted.  On a mesh it counts the local
    shards' storages (DTensor's wrappers hold none), this rank's."""

    def __init__(self, block: int = BLOCK):
        super().__init__()
        self.block = block
        self.live: dict[int, weakref.ref] = {}
        self.current = 0
        self.peak = 0

    def _freed(self, key: int, n: int) -> None:
        if self.live.pop(key, None) is not None:
            self.current -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _propagating():
            return out
        outs = (out,) if isinstance(out, torch.Tensor) else tree_flatten(
            out)[0]
        inputs = None
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata
                          for a in tree_flatten((args, kwargs))[0]
                          if isinstance(a, torch.Tensor)}
            if key in inputs:
                continue
            n = _round(st.nbytes(), self.block)
            self.live[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._freed(key, n))
            self.current += n
            self.peak = max(self.peak, self.current)
        return out


class OpBytes(TorchDispatchMode):
    """The sum of every op's tensor input and output bytes (views, which
    move nothing, excluded): the traffic of the step run op by op."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
        return out


class Collective(NamedTuple):
    """One collective as issued: its kind (the reference's HLO names), the
    bytes of its result (all its tensors; an all-reduce's in place) and
    the size of its group."""

    kind: str
    nbytes: int
    group: int


_FUNCTIONAL = {  # _c10d_functional op -> kind
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_C10D = {  # c10d op -> kind; its result tensors are its first argument
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
}


def collective_kind(op_name: str) -> str | None:
    """The kind of a collective op by its name (a functional collective's,
    ``all_reduce``, or a ``c10d`` op's, ``allreduce_``), as
    ``CommDebugMode`` names them; None for any other op."""
    return _FUNCTIONAL.get(op_name) or _C10D.get(op_name)


def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _group_size(args) -> int:
    """The size of the group an op runs over: a ``c10d`` op's process group
    (a ``ScriptObject`` at dispatch), or a functional collective's group
    name."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            return ProcessGroup.unbox(a).size()
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    raise ValueError("a collective without a group")


class Collectives(TorchDispatchMode):
    """Every collective issued while it is on, as a :class:`Collective`:
    DTensor's redistributions and ``local_map`` bodies as they reach the
    functional ops (``_c10d_functional``), and direct ``torch.distributed``
    calls as their ``c10d`` ops (the solver's stop tests, the sharded
    decode's gather)."""

    def __init__(self):
        super().__init__()
        self.records: list[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        table = {"_c10d_functional": _FUNCTIONAL,
                 "c10d": _C10D}.get(func.namespace, {})
        if name in table:
            result = out if table is _FUNCTIONAL else args[0]
            self.records.append(Collective(
                table[name], _tensor_bytes(result),
                _group_size(list(args) + list(kwargs.values()))))
        return out


# per-device link bytes of one collective of ``n`` result bytes over ``g``
# devices, the ring algorithm's (the reference's ``collective_bytes``)
RING = {
    "all-gather": lambda n, g: n * (g - 1) / g,
    "all-reduce": lambda n, g: 2 * n * (g - 1) / g,
    "reduce-scatter": lambda n, g: n * (g - 1),
    "all-to-all": lambda n, g: n * (g - 1) / g,
    "collective-permute": lambda n, g: n,
    "broadcast": lambda n, g: n * (g - 1) / g,
}


def collective_bytes(records) -> dict:
    """Per-device link bytes and counts by collective kind, with the
    reference's ring factors: all-gather out x (g-1)/g, all-reduce 2 x size
    x (g-1)/g, reduce-scatter out x (g-1), all-to-all out x (g-1)/g,
    permute out (a broadcast, which XLA has not, as an all-gather).  Groups
    of one move nothing and are skipped, as the reference skips them.
    ``records``: ``Collective``s or ``(kind, bytes, group)`` triples."""
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for kind, n, g in records:
        if g <= 1 and kind != "collective-permute":
            continue
        totals[kind] = totals.get(kind, 0.0) + RING[kind](n, g)
        counts[kind] = counts.get(kind, 0) + 1
    totals["total"] = sum(totals.values())
    return {"bytes": totals, "counts": counts}


def count_cost(cell: Cell) -> dict:
    """Run the cell once on ``meta`` under the FLOP and byte counters."""
    t0 = time.time()
    with FlopCounterMode(display=False) as flops, OpBytes() as nbytes:
        cell.fn(*cell.args)
    return {"seconds": round(time.time() - t0, 2),
            "flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.total)}


def run_step(cell: Cell) -> tuple[int, Any, list]:
    """``(peak allocated bytes, outputs, collectives)`` of one run of the
    cell (rank 0's, on a mesh)."""
    with LiveBytes() as live, Collectives() as coll:
        out = cell.fn(*cell.args)
    return live.peak, out, coll.records


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _train_config(shape: ShapeSuite, grad_accum: int) -> TrainConfig:
    return TrainConfig(global_batch=shape.global_batch,
                       seq_len=shape.seq_len, grad_accum=grad_accum,
                       zero1=True)


def memory_cell(cfg: ModelConfig, shape: ShapeSuite, mesh,
                tcfg: TrainConfig, *, run: bool, world=None) -> dict:
    """The ``memory`` variant's numbers; ``run``: also run the step on
    ``meta`` for ``temp_bytes`` and its collectives (and hold its outputs
    to the ones counted without running); ``world``: the ``DeviceMesh`` it
    runs on (the sharded step), else the unsharded step."""
    cell = build_cell(cfg, shape, world if run and world is not None
                      else mesh, tcfg)
    outs = output_structs(cfg, shape, tcfg, cell)
    arg = sum(tree_bytes(a, s, mesh) for a, s in zip(cell.args, cell.specs))
    mem = {
        "argument_bytes": arg,
        "output_bytes": tree_bytes(outs, cell.out_specs(outs), mesh),
        "alias_bytes": sum(tree_bytes(cell.args[i], cell.specs[i], mesh)
                           for i in cell.donate),
        "temp_bytes": None,
        "argument_bytes_blocks": sum(
            tree_bytes(a, s, mesh, BLOCK)
            for a, s in zip(cell.args, cell.specs)),
    }
    if run:
        t0 = time.time()
        mem["temp_bytes"], got, records = run_step(cell)
        mem["run_seconds"] = round(time.time() - t0, 2)
        mem["collectives"] = collective_bytes(records)
        want = [(tuple(t.shape), t.dtype) for t, _ in leaves_with_specs(outs)]
        if shape.kind == "train":  # the metrics' host numbers dropped
            got = got[0], {k: v for k, v in got[1].items()
                           if isinstance(v, torch.Tensor) and v.dim() == 0}
        have = [(tuple(t.shape), t.dtype) for t, _ in leaves_with_specs(got)]
        if want != have:
            raise AssertionError(f"outputs {have} != counted {want}")
    return mem


def cost_cell(cfg: ModelConfig, shape: ShapeSuite, mesh,
              tcfg: TrainConfig, world=None) -> dict:
    """The ``cost`` variant: counts at two reduced depths (DEQ: solver
    steps) and the exact extrapolation to the full one.  FLOPs and bytes
    count the unsharded step; ``world`` (a ``DeviceMesh``) also runs the
    sharded step at each depth for its collectives."""
    depths = (2, 4) if cfg.deq.enabled else _reduced_depths(cfg)
    runs = {}
    for n in depths:
        if cfg.deq.enabled:
            ccfg = _costing_config(cfg, cfg.num_layers)
            ccfg = dataclasses.replace(ccfg, deq=dataclasses.replace(
                ccfg.deq, max_steps=n, unroll=True))
        else:
            ccfg = _costing_config(cfg, n)
        runs[n] = count_cost(build_cell(ccfg, shape, mesh, tcfg))
        records = []
        if world is not None:
            t0 = time.time()
            cell = build_cell(ccfg, shape, world, tcfg)
            with Collectives() as coll:
                cell.fn(*cell.args)
            records = coll.records
            runs[n]["sharded_seconds"] = round(time.time() - t0, 2)
        coll = collective_bytes(records)
        runs[n]["collective_bytes"] = coll["bytes"]["total"]
        runs[n]["collective_counts"] = coll["counts"]
    full = cfg.deq.max_steps if cfg.deq.enabled else cfg.num_layers
    return {"depths": {str(k): v for k, v in runs.items()},
            "extrapolated": extrapolate(runs, full), "num_layers": full,
            "extrapolation_axis": ("solver_steps" if cfg.deq.enabled
                                   else "layers"),
            "flops_scope": "the whole step: global batch, all devices",
            "collective_scope": "per device, the sharded step as issued"}


def extrapolate(runs: dict, full: int) -> dict:
    """``cost(L) = cost(L0) + (L - L0) * delta``, ``delta`` the per-layer
    (per-step) difference of the two counted depths."""
    (l0, r0), (l1, r1) = sorted(runs.items())
    out = {}
    for key in ("flops", "bytes", "collective_bytes"):
        delta = (r1[key] - r0[key]) / (l1 - l0)
        out[key] = r0[key] + (full - l0) * delta
        out[key + "_per_layer"] = delta
    return out


def _apply_overrides(cfg: ModelConfig, overrides: dict | None) -> ModelConfig:
    if not overrides:
        return cfg
    flat = {k: v for k, v in overrides.items() if "." not in k}
    if flat:
        cfg = dataclasses.replace(cfg, **flat)
    for k, v in overrides.items():
        if "." in k:  # nested, e.g. mla.absorbed_decode=true
            outer, inner = k.split(".", 1)
            sub = dataclasses.replace(getattr(cfg, outer), **{inner: v})
            cfg = dataclasses.replace(cfg, **{outer: sub})
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str, *,
             deq: bool = False, grad_accum: int = 1,
             seq_parallel: bool = False, overrides: dict | None = None,
             shape: ShapeSuite | None = None,
             tcfg: TrainConfig | None = None) -> dict:
    """One cell's record.  ``shape`` replaces the named suite (a custom
    batch and length) and ``tcfg`` the train config the suite implies."""
    shape = shape or SHAPES[shape_name]
    cfg = get_config(arch, deq=deq)
    if seq_parallel:
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    cfg = _apply_overrides(cfg, overrides)
    skip = cell_skip_reason(cfg, shape)
    if skip:
        return {"skipped": skip}
    mesh = mesh_for(mesh_kind)
    tcfg = tcfg or _train_config(shape, grad_accum)
    out: dict = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "variant": variant, "deq": deq, "grad_accum": tcfg.grad_accum,
        "seq_parallel": seq_parallel, "chips": mesh.size,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "params": int(cfg.num_params()),
        "params_active": int(cfg.num_params(active_only=True)),
    }
    if variant not in ("memory", "cost"):
        raise ValueError(variant)
    t0 = time.time()
    with (fake_world(mesh) if mesh_kind != "one"
          else contextlib.nullcontext()) as world:
        if variant == "memory":
            out["memory"] = memory_cell(_costing_config(cfg, cfg.num_layers),
                                        shape, mesh, tcfg, run=True,
                                        world=world)
            out["collectives"] = out["memory"].pop("collectives")
        else:
            out.update(cost_cell(cfg, shape, mesh, tcfg, world=world))
    out["seconds"] = round(time.time() - t0, 2)
    return out


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def cell_path(arch, shape, mesh_kind, variant, deq, tag="",
              out_dir: Path = RESULTS_DIR) -> Path:
    name = f"{arch}__{shape}__{mesh_kind}__{variant}"
    if deq:
        name += "__deq"
    if tag:
        name += f"__{tag}"
    return Path(out_dir) / f"{name}.json"


def all_cells(include_deq_archs=("minicpm-2b", "deepseek-moe-16b",
                                 "zamba2-2.7b")) -> list[tuple]:
    """The reference's matrix (memory on both production meshes, cost on
    the single pod, the DEQ form of three archs at ``train_4k``) plus
    memory on one card for every valid (arch, shape)."""
    jobs = []
    for arch in ARCHS:
        for shape in SHAPES:
            jobs.append((arch, shape, "single", "memory", False))
            jobs.append((arch, shape, "multi", "memory", False))
            jobs.append((arch, shape, "single", "cost", False))
    for arch in include_deq_archs:
        jobs.append((arch, "train_4k", "single", "memory", True))
        jobs.append((arch, "train_4k", "single", "cost", True))
        jobs.append((arch, "train_4k", "multi", "memory", True))
    for arch, cfg in ARCHS.items():
        for shape in valid_cells(cfg):
            jobs.append((arch, shape, "one", "memory", False))
    return jobs


def _alarm(signum, frame):
    raise TimeoutError("cell time limit")


def _run_job(job: tuple, out_dir: str, timeout: int) -> tuple:
    """One cell of ``--all`` in a worker: its record written, or its
    traceback in a ``.err`` file beside it."""
    arch, shape, mesh_kind, variant, deq = job
    path = cell_path(*job, out_dir=Path(out_dir))
    t0 = time.time()
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(timeout)
    try:
        res = run_cell(arch, shape, mesh_kind, variant, deq=deq)
        path.write_text(json.dumps(res, indent=2))
        return job, "skipped" if "skipped" in res else "ok", \
            res.get("skipped"), time.time() - t0
    except Exception:  # noqa: BLE001 -- a failed cell is reported, not fatal
        path.with_suffix(".err").write_text(traceback.format_exc())
        return job, "FAIL", None, time.time() - t0
    finally:
        signal.alarm(0)


def cell_name(job: tuple) -> str:
    """``arch/shape/mesh/variant`` (``/deq`` for the DEQ form)."""
    arch, shape, mesh_kind, variant, deq = job
    return "/".join((arch, shape, mesh_kind, variant) + (("deq",) if deq
                                                       else ()))


def cell_weight(job: tuple) -> float:
    """A rough relative cost of a cell, to start the longest first: the
    positions a step runs on ``meta`` times the layers it runs (a ``one``
    memory cell: all of them; a cost cell: its two depths), three times for
    a train step; xLSTM's sLSTM loop and HuBERT's non-causal attention
    weigh more.  Layout-only cells weigh nothing."""
    arch, shape_name, mesh_kind, variant, deq = job
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    if variant == "memory" and mesh_kind != "one":
        return 0.0
    if deq:
        layers = 6 * cfg.deq.num_blocks
    elif variant == "cost":
        layers = sum(_reduced_depths(cfg))
    else:
        layers = cfg.num_layers
    seq = 1 if shape.kind == "decode" else shape.seq_len
    family = {"ssm": 8.0, "audio": 2.0}.get(cfg.family, 1.0)
    return seq * layers * (3.0 if shape.kind == "train" else 1.0) * family


def run_all(out_dir: Path, jobs: int, timeout: int,
            exclude: tuple[str, ...] = ()) -> dict:
    """Every cell of ``all_cells`` not yet written and not in ``exclude``
    (``cell_name``s), ``jobs`` at a time in forked workers, the heaviest
    first (``cell_weight``).  Returns the summary printed as the last
    line."""
    cells = all_cells()
    unknown = set(exclude) - {cell_name(j) for j in cells}
    if unknown:
        raise ValueError(f"--exclude names no cell: {sorted(unknown)}")
    todo = sorted((j for j in cells
                   if not cell_path(*j, out_dir=out_dir).exists()
                   and cell_name(j) not in exclude),
                  key=cell_weight, reverse=True)
    print(f"dryrun --all: {len(cells)} cells, {len(todo)} to run, "
          f"{len(exclude)} excluded, {jobs} workers", flush=True)
    t0 = time.time()
    failures, skipped, slowest = [], {}, []
    ctx = multiprocessing.get_context("fork")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
        futs = [ex.submit(_run_job, j, str(out_dir), timeout) for j in todo]
        for i, fut in enumerate(concurrent.futures.as_completed(futs)):
            job, status, reason, secs = fut.result()
            arch, shape, mesh_kind, variant, deq = job
            print(f"[{i + 1}/{len(todo)}] {arch} {shape} {mesh_kind} "
                  f"{variant}{' deq' if deq else ''}: {status} "
                  f"({secs:.1f}s)", flush=True)
            slowest.append((round(secs, 1), cell_name(job)))
            if status == "FAIL":
                failures.append(cell_name(job))
            elif status == "skipped":
                skipped[cell_name(job)] = reason
    slowest.sort(reverse=True)
    return {"cells": len(cells), "ran": len(todo),
            "excluded": sorted(exclude),
            "failures": failures, "skipped": skipped,
            "seconds": round(time.time() - t0, 1), "slowest": slowest[:5]}


def _parse_overrides(pairs: list[str]) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("true", "false"):
            v = v == "true"
        else:
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
        overrides[k] = v
    return overrides


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=MESHES, default="single")
    ap.add_argument("--variant", choices=("memory", "cost"),
                    default="memory")
    ap.add_argument("--deq", action="store_true",
                    help="dry-run the DEQ/SHINE model form")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (int/float/bool/str)")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--all", action="store_true",
                    help="run every cell of the matrix (resumable: cells "
                         "already written are skipped)")
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1),
                    help="worker processes for --all")
    ap.add_argument("--exclude", action="append", default=[],
                    help="with --all: leave out this cell "
                         "(arch/shape/mesh/variant[/deq])")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="seconds a cell may take")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the result files")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        summary = run_all(out_dir, max(1, args.jobs), args.timeout,
                          tuple(args.exclude))
        print(f"done; {len(summary['failures'])} failures", flush=True)
        print(json.dumps({"dryrun_all": summary}), flush=True)
        return 1 if summary["failures"] else 0
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape are required without --all")
    res = run_cell(args.arch, args.shape, args.mesh, args.variant,
                   deq=args.deq, grad_accum=args.grad_accum,
                   seq_parallel=args.seq_parallel,
                   overrides=_parse_overrides(args.set) or None)
    path = cell_path(args.arch, args.shape, args.mesh, args.variant,
                     args.deq, args.tag, out_dir=out_dir)
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
