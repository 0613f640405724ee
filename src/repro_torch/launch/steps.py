"""The train step and its state.

The port of ``repro/launch/steps.py``: ``TrainState`` (with the
persistent solve carry of DEQ models), ``train_carry_enabled``,
``build_train_step`` and ``init_train_state``, the serving steps
``build_prefill`` and ``build_decode_step``, and the struct helpers the
dry-run lays out: ``param_structs``, ``train_state_structs`` (``meta``
trees, leaf for leaf what ``init_params`` and ``init_train_state`` build)
with ``param_shardings``, ``carry_shardings`` and ``state_shardings`` (the
spec trees beside them; ZeRO-1 splits the moments over "data").

Eager PyTorch needs no jit: the step is a plain function.  It writes the
new parameters and moments into the state's own tensors (the reference jits
its step with the state donated), so the state it was given is used up;
``init_train_state`` copies the parameters it is handed, once.  The qN ring
of a carry is updated in place on the card by the solve that takes it, so
the step copies it first where the pre-step carry must survive a rejected
update (``deq_carry="full"`` with ``skip_nonfinite``).

On a running mesh (``ctx.device_mesh``) the state's leaves are DTensors
placed by ``state_shardings``: parameters TP-split and DP-replicated, the
AdamW moments also split over "data" by ``zero1_spec`` when
``tcfg.zero1``, the carry's ring batch-split.  The step differentiates the
sharded loss, lays every gradient out as its moments (a reduce-scatter
or an all-reduce over the DP axes), clips by the norm of the whole
gradient, and updates each rank's shards in place
(``optim/optimizers``).  The loss, gradient norm and ``ok`` verdict are
replicated values, the same on every rank.  With ``grad_accum`` k each
microbatch is the reference's rows of the global batch, laid out over the
DP axes by itself, and the gradient sum lies where the moments do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.lowrank import LowRank
from repro_torch.core.solvers import SolveCarry, carry_state_only, torch_dtype
from repro_torch.models import lm
from repro_torch.models.layers import act_dtype
from repro_torch.obs import tracing as obs_tracing
from repro_torch.optim.optimizers import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_schedule,
    sgdm_update,
    tree_leaves,
    tree_map,
)
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ShardCtx,
    distribute_tree,
    map_decls,
    named_sharding_tree,
    shape_tree,
    spec_tree,
    spmd,
    whole,
    zero1_spec_tree,
)

Tree = Any

# logical axes of the DEQ solver state; the qN memory prepends "qn_mem"
_CARRY_STATE_AXES = ("batch", "seq_res", "embed_act")


class TrainState(NamedTuple):
    step: torch.Tensor                # () int32
    params: Tree
    opt: OptState
    # the warm-start carry threaded across train steps (DEQ models)
    carry: SolveCarry | None = None
    # consecutive rejected (non-finite) updates; None without skip_nonfinite
    skips: torch.Tensor | None = None


def train_carry_enabled(cfg: ModelConfig, tcfg: TrainConfig) -> bool:
    """Whether the train step threads a persistent solve carry: a DEQ
    model, ``deq_carry != "off"``, no gradient accumulation (microbatches
    slice the batch, so one carry cannot follow them all) and a family
    whose solver state has ``seq_len`` positions."""
    if tcfg.deq_carry not in ("state", "full", "off"):
        raise ValueError(
            f"deq_carry={tcfg.deq_carry!r}; expected state | full | off")
    return bool(cfg.deq.enabled) and tcfg.deq_carry != "off" \
        and tcfg.grad_accum == 1 and cfg.family != "vlm"


# ---------------------------------------------------------------------------
# structs and specs (the dry-run's)
# ---------------------------------------------------------------------------


def param_shardings(cfg: ModelConfig, ctx: ShardCtx):
    """The spec tree of the parameters (``None`` leaves without a mesh)."""
    decl = lm.model_decl(cfg)
    if ctx.mesh is None:
        return map_decls(lambda d: None, decl)
    return spec_tree(decl, ctx.rules)


def param_structs(cfg: ModelConfig, ctx: ShardCtx) -> tuple[Tree, Tree]:
    """``(meta parameter tree, its specs)``."""
    return (shape_tree(lm.model_decl(cfg), act_dtype(cfg)),
            param_shardings(cfg, ctx))


def carry_shardings(cfg: ModelConfig, ctx: ShardCtx) -> SolveCarry | None:
    """The specs of the train state's solve carry: the iterate in the
    activation layout, the (U, V) ring batch-split beside it."""
    if ctx.mesh is None:
        return None
    vec = ctx.spec(("batch",))
    mem = ctx.spec(("qn_mem",) + _CARRY_STATE_AXES)
    return SolveCarry(
        z=ctx.spec(_CARRY_STATE_AXES),
        lowrank=LowRank(alpha=(), u=mem, v=mem, count=vec),
        warm=vec, age=vec)


def state_shardings(cfg: ModelConfig, tcfg: TrainConfig, ctx: ShardCtx):
    """The TrainState's spec tree: parameters TP-split and DP-replicated,
    the moments also split over "data" under ZeRO-1, the carry (where
    ``train_carry_enabled``) batch-split.  ``None`` without a mesh."""
    if ctx.mesh is None:
        return None
    decl = lm.model_decl(cfg)
    pspec = spec_tree(decl, ctx.rules)
    zsize = ctx.mesh.shape.get("data", 0)
    ospec = (zero1_spec_tree(decl, ctx.rules, zero_size=zsize)
             if tcfg.zero1 else pspec)
    return TrainState(
        step=(), params=pspec,
        opt=OptState(step=(), mu=ospec, nu=ospec),
        carry=(carry_shardings(cfg, ctx)
               if train_carry_enabled(cfg, tcfg) else None),
        skips=(() if tcfg.skip_nonfinite else None))


def train_state_structs(cfg: ModelConfig, tcfg: TrainConfig,
                        ctx: ShardCtx) -> tuple[TrainState, Any]:
    """``(TrainState of meta tensors, state_shardings)``: leaf for leaf
    what ``init_train_state`` builds (parameters in the model dtype, f32
    moments, the carry's iterate, ring and counters)."""
    decl = lm.model_decl(cfg)
    dt = act_dtype(cfg)
    meta = lambda shape, dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device="meta")
    scalar = lambda: meta((), torch.int32)  # noqa: E731
    carry = None
    if train_carry_enabled(cfg, tcfg):
        b, s, d, m = (tcfg.global_batch, tcfg.seq_len, cfg.d_model,
                      cfg.deq.memory)
        ring = torch_dtype(cfg.deq.qn_dtype)
        carry = SolveCarry(
            z=meta((b, s, d), dt),
            lowrank=LowRank(alpha=meta((), torch.float32),
                            u=meta((m, b, s, d), ring),
                            v=meta((m, b, s, d), ring),
                            count=meta((b,), torch.int32)),
            warm=meta((b,), torch.bool), age=meta((b,), torch.int32))
    state = TrainState(
        scalar(), shape_tree(decl, dt),
        OptState(scalar(), shape_tree(decl, torch.float32),
                 shape_tree(decl, torch.float32)),
        carry, scalar() if tcfg.skip_nonfinite else None)
    return state, state_shardings(cfg, tcfg, ctx)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _copy_carry(carry: SolveCarry) -> SolveCarry:
    return dataclasses.replace(carry, lowrank=carry.lowrank.clone())


def _keep_carry(ok: torch.Tensor, new: SolveCarry,
                old: SolveCarry) -> SolveCarry:
    lr_n, lr_o = new.lowrank, old.lowrank
    w = lambda n, o: torch.where(ok, n, o)  # noqa: E731
    return SolveCarry(
        z=w(new.z, old.z),
        lowrank=dataclasses.replace(lr_n, u=w(lr_n.u, lr_o.u),
                                    v=w(lr_n.v, lr_o.v),
                                    count=w(lr_n.count, lr_o.count)),
        warm=w(new.warm, old.warm), age=w(new.age, old.age))


def _zero_grads(params, moment_pls, ctx: ShardCtx):
    """The f32 gradient sum's zeros; on a mesh laid out as the moments
    (each microbatch's gradient is already)."""
    if moment_pls is None:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    from torch.distributed.tensor import zeros as dzeros
    return tree_map(lambda p, pl: dzeros(p.shape, dtype=torch.float32,
                                         device_mesh=ctx.device_mesh,
                                         placements=pl), params, moment_pls)


def _micro_ctx(ctx: ShardCtx, rows: int) -> ShardCtx:
    """The layout of a microbatch of ``rows``: ``ctx``, or, where the rows
    do not divide over the DP axes, ``ctx`` with the batch replicated (each
    data rank computes the whole microbatch; its gradients then need no DP
    sum).  DTensor's uneven shards of the batch cannot run the model: a
    rank left with no row fails the matmuls' reshape of the sharded batch
    dimension, where the reference pads its shards."""
    if not ctx.running or rows % ctx.axis_size("batch") == 0:
        return ctx
    return dataclasses.replace(ctx, rules=ctx.rules.replace(batch=None))


def _microbatch(batch: dict, k: int, i: int, ctx: ShardCtx) -> dict:
    """Microbatch ``i`` of ``k``: rows ``[i B/k, (i+1) B/k)`` of the global
    batch, as the reference's reshape takes them.  On a mesh the batch is
    taken whole and each microbatch laid out by ``ctx`` (``_micro_ctx``)
    by itself, not as each rank's slice of its local rows: a batch-split
    DEQ solve's stop tests are global over the rows that solve together."""
    out = {}
    for n, a in batch.items():
        a = whole(a)
        m = a.reshape((k, a.shape[0] // k) + a.shape[1:])[i]
        out[n] = ctx.constrain(m, ("batch",) + (None,) * (m.ndim - 1))
    return out


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                     loss_fn: Callable | None = None,
                     ctx: ShardCtx = NULL_CTX) -> Callable:
    """``(state, batch) -> (state, metrics)``: gradients (with
    accumulation) -> clip -> AdamW/SGDM on the ``tcfg`` schedule.  Metrics
    are 0-d tensors on the device (reading them is the caller's host sync).

    With a carry in the state the default loss threads it into the forward
    solve and the updated carry rides back into the new state.  A custom
    ``loss_fn(params, batch) -> (loss, aux)`` leaves the carry untouched.
    ``ctx`` runs the step on its mesh (the state from ``init_train_state``
    with the same ``ctx``; the batch whole or laid out by ``"batch"``)."""
    if loss_fn is None:
        def loss_with_carry(p, b, c, lctx):
            return lm.loss_fn(p, b, cfg, z_loss=tcfg.z_loss, carry=c,
                              ctx=lctx)
    else:
        def loss_with_carry(p, b, c, lctx):
            return loss_fn(p, b)
    sched = make_schedule(tcfg)

    moment_pls = None
    if ctx.running:
        moment_pls = named_sharding_tree(
            state_shardings(cfg, tcfg, ctx).opt.mu, ctx.device_mesh)

    def grads_of(params, batch, carry, lctx=ctx):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with spmd(lctx):
            loss, aux = loss_with_carry(leaves, batch, carry, lctx)
            grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                             allow_unused=True))

        def grad_of(p):  # a parameter the loss does not use gets zeros
            g = next(grads)
            return torch.zeros_like(p) if g is None else g

        grads = tree_map(grad_of, leaves)
        if moment_pls is not None:
            # the DP sums: each gradient laid out as its moments
            grads = tree_map(lambda g, pl: g.redistribute(ctx.device_mesh,
                                                          pl),
                             grads, moment_pls)
        return whole(loss.detach()), aux, grads

    def train_step(state: TrainState, batch: dict):
        params = state.params
        new_carry = state.carry
        if tcfg.grad_accum > 1:
            k = tcfg.grad_accum
            gsum = _zero_grads(params, moment_pls, ctx)
            lsum = 0.0
            mctx = _micro_ctx(ctx, next(iter(batch.values())).shape[0] // k)
            for i in range(k):
                micro = _microbatch(batch, k, i, mctx)
                l, _, g = grads_of(params, micro, None, mctx)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / k, gsum)
            loss, aux = lsum / k, {}
        else:
            carry_in = state.carry
            if carry_in is not None and tcfg.deq_carry == "state":
                # fresh-batch regime: reuse the iterate, rebuild the chain
                carry_in = carry_state_only(carry_in)
            elif carry_in is not None and tcfg.skip_nonfinite:
                # without the solver's guard the solve consumes the ring in
                # place (with it, the entry repair selects it into new
                # buffers); a rejected step must give back the pre-step
                # carry (under "state" the ring's contents are never read:
                # its count is zeroed)
                carry_in = _copy_carry(carry_in)
            loss, aux, grads = grads_of(params, batch, carry_in)
            new_carry = aux.pop("solve_carry", new_carry)

        with spmd(ctx):
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = sched(state.step)
        # a non-finite loss or gradient norm rejects the whole update
        # (params, optimizer state, carry keep their pre-step values) by a
        # select on the device: no host read on the hot path.  The trainer
        # reads the consecutive-skip count at its metrics fetch and rolls
        # back past tcfg.skip_budget.
        ok = (torch.isfinite(loss) & torch.isfinite(gnorm)
              if tcfg.skip_nonfinite else None)
        # the update writes into the state's own tensors (the old state is
        # gone after it, as the reference's donated one is)
        update = sgdm_update if tcfg.optimizer == "sgdm" else adamw_update
        with spmd(ctx):
            new_params, opt = update(grads, state.opt, params, lr,
                                     weight_decay=tcfg.weight_decay, ok=ok)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        metrics.update({k: (whole(v.detach())
                            if isinstance(v, torch.Tensor) else v)
                        for k, v in aux.items()
                        if not isinstance(v, torch.Tensor) or v.ndim == 0})
        new_state = TrainState(state.step + 1, new_params, opt, new_carry,
                               state.skips)
        if ok is not None:
            prev = state.skips if state.skips is not None else \
                torch.zeros((), dtype=torch.int32, device=ok.device)
            with spmd(ctx):
                kept = (_keep_carry(ok, new_carry, state.carry)
                        if new_carry is not None else None)
            new_state = TrainState(
                state.step + 1, new_params,
                opt._replace(step=torch.where(ok, opt.step, state.opt.step)),
                kept, torch.where(ok, torch.zeros_like(prev), prev + 1))
            metrics["update_skipped"] = (~ok).float()
            metrics["consec_skips"] = new_state.skips.float()
        # the optimizer phase ends when the new optimizer state is computed
        # (forward_solve and implicit_backward are marked inside the solve)
        obs_tracing.phase_done("optimizer", new_state.opt.step)
        return new_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *,
                     seed: int | None = None, params: Tree | None = None,
                     device=None, ctx: ShardCtx = NULL_CTX) -> TrainState:
    """A fresh state: parameters drawn from ``seed`` (default
    ``tcfg.seed``) on ``device``, or a copy of the given ``params``; zero
    moments; a cold carry where ``train_carry_enabled``.  The state owns
    its tensors (the train step updates them in place), so the caller's
    ``params`` stay as they are.  On a running ``ctx`` every leaf is placed
    by ``state_shardings`` (each rank keeps its shards: the parameters
    drawn or given whole, the same on every rank)."""
    if params is None:
        params = lm.init_params(cfg, seed=tcfg.seed if seed is None else seed,
                                device=device)
    else:
        params = tree_map(lambda p: p.detach().clone(
            memory_format=torch.contiguous_format), params)
    dev = lm.params_device(params)
    carry = (lm.deq_solve_carry(cfg, tcfg.global_batch, tcfg.seq_len, dev)
             if train_carry_enabled(cfg, tcfg) else None)
    skips = (torch.zeros((), dtype=torch.int32, device=dev)
             if tcfg.skip_nonfinite else None)
    if ctx.running:
        return _place_state(cfg, tcfg, ctx, params, carry, skips)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      adamw_init(params), carry, skips)


def _place_state(cfg, tcfg, ctx, params, carry, skips) -> TrainState:
    """A fresh state's leaves placed on ``ctx``'s mesh: the moments made
    as zero shards where they lie."""
    from torch.distributed.tensor import zeros as dzeros

    mesh = ctx.device_mesh
    specs = state_shardings(cfg, tcfg, ctx)
    op = named_sharding_tree(specs.opt.mu, mesh)
    params = distribute_tree(params, specs.params, mesh)
    moments = lambda: tree_map(  # noqa: E731
        lambda p, pl: dzeros(p.shape, dtype=torch.float32,
                             device_mesh=mesh, placements=pl), params, op)
    dev = lm.params_device(params)
    if carry is not None:
        carry = distribute_tree(carry, specs.carry, mesh)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      OptState(torch.zeros((), dtype=torch.int32,
                                           device=dev), moments(), moments()),
                      carry, skips)



# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def build_prefill(cfg: ModelConfig, ctx: ShardCtx, max_len: int) -> Callable:
    """``(params, batch) -> (logits, caches, lengths)``: ``lm.prefill`` into
    caches of ``max_len`` through ``ctx`` (its mesh, if it runs on one)."""
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, max_len, ctx=ctx)
    return prefill_step


def build_decode_step(cfg: ModelConfig, ctx: ShardCtx) -> Callable:
    """``(params, caches, tokens, cache_index) -> (logits, caches)``:
    ``lm.decode_step`` through ``ctx``, the caches written in place."""
    def decode_step(params, caches, tokens, cache_index):
        return lm.decode_step(params, caches, tokens, cache_index, cfg,
                              ctx=ctx)
    return decode_step
