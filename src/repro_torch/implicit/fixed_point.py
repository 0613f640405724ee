"""The differentiable fixed point ``z* = f(params, x, z*)``: SHINE's forward
and backward.

The port of ``repro/implicit/fixed_point.py``.  The registered forward
solver runs under ``torch.no_grad()``; when an input requires grad, the
solve sits inside a ``torch.autograd.Function`` whose backward implements
Theorem 1's hypergradient with the registered cotangent estimator
(``implicit/estimators.py``):

  * ``z*`` is returned bit for bit as the solver gives it;
  * the forward's quasi-Newton inverse (``LowRank``) is saved as it is, not
    copied -- nothing writes to it between the forward and the backward;
  * the backward evaluates ``f`` once at ``z*`` under autograd and reuses
    that graph for every VJP the estimator asks for;
  * non-finite cotangent rows are zeroed (and, with metrics on, counted in
    ``backward_cotangents_zeroed_total``) so one poisoned sample cannot NaN
    the whole batch's gradient;
  * with metrics on, the forward solve and the backward estimate are
    recorded (``obs_metrics.record_solve("forward", ...)``,
    ``record_backward``) without a host read of their own;
  * the cotangent flows to ``params`` and ``x``; ``z0`` and the carry get
    none (a warm start never perturbs the gradient);
  * ``outer_grad(params, x, z) -> dL/dz``, bound per call, reaches the
    forward solver (the adjoint-Broyden OPA updates);
  * with tracing on, ``forward_solve`` and ``implicit_backward`` are marked
    as phases (``obs/tracing.phase_done``).

Memory is the paper's O(1): saved are ``params``, ``x``, ``z*`` and the
qN chain, no unrolled activations.

On a running mesh (``ctx``) the state is a DTensor whose batch is split
over the DP axes (``SolveLayout``, the reference's ``solve_sharding``):
the solver runs on every rank's rows as local tensors, so its ring ``(U,
V)`` is batch-split beside the state and the qN kernels launch on local
shards, ``f`` takes and returns the DTensor state, and every stop and
restart test is one collective (``core.solvers.stop_tests_over``).  The
SHINE backward's ``H^T w`` runs on the same shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# populate the registries with the built-in solvers and estimators
from repro_torch.implicit import estimators as _builtin_estimators  # noqa: F401
from repro_torch.implicit import solvers as _builtin_solvers
from repro_torch.core.lowrank import LowRank, _expand
from repro_torch.core.solvers import (
    SolveCarry,
    SolveResult,
    init_solve_carry,
    stop_tests_over,
)
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.estimators import estimate_cotangent
from repro_torch.implicit.pytree import prepare_flat_problem, ravel_state
from repro_torch.implicit.registry import SOLVERS
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.tape import SolveTape
from repro_torch.parallel.sharding import contiguous_stride, redistribute


class ImplicitStats(NamedTuple):
    residual: torch.Tensor    # (B,) forward residual at z*
    n_steps: int              # forward iterations
    converged: torch.Tensor   # (B,)
    trace: torch.Tensor       # (max_steps, B)
    tape: SolveTape | None = None
    status: torch.Tensor | None = None  # (B,) STATUS_* codes


_MESH_GROUPS: dict = {}


def _mesh_group(mesh):
    """The process group of a mesh's ranks (the stop tests' group): the
    world's, or (a mesh over some of the world's ranks, as an elastic
    re-mesh leaves) one made by those ranks alone, once."""
    import torch.distributed as dist
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == dist.get_world_size():
        return None
    key = tuple(ranks)
    if key not in _MESH_GROUPS:
        _MESH_GROUPS[key] = dist.new_group(ranks,
                                           use_local_synchronization=True)
    return _MESH_GROUPS[key]


class SolveLayout:
    """How a solve's state lies on a running mesh: split along its batch
    over the DP axes (the ``batch`` entry of ``state_axes``; other axes of
    the state are gathered, so every rank holds whole rows), the ring
    ``(m, B, ...)`` split along B beside it, per-row vectors along B.
    ``local`` takes a DTensor (or a whole tensor) to this rank's rows,
    ``place`` puts local rows back."""

    def __init__(self, ctx, state_axes, z: torch.Tensor):
        self.mesh = ctx.device_mesh
        pls = ctx.sharding(tuple(state_axes))
        self.state = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                           else Replicate() for p in pls)
        self.batch = z.shape[0]
        self.group = _mesh_group(self.mesh)

    @staticmethod
    def make(ctx, state_axes, z) -> "SolveLayout | None":
        if ctx is None or not ctx.running:
            return None
        if state_axes is None:
            state_axes = ("batch",) + (None,) * (z.dim() - 1)
        return SolveLayout(ctx, state_axes, z)

    def rows(self, dim: int) -> tuple:
        """The placements of a tensor whose batch is dim ``dim``."""
        return tuple(Shard(dim) if isinstance(p, Shard) else p
                     for p in self.state)

    def local(self, t, dim: int = 0):
        if t is None or not isinstance(t, torch.Tensor):
            return t
        return redistribute(t, self.mesh, self.rows(dim)).to_local()

    def place(self, t, dim: int = 0):
        if t is None or not isinstance(t, torch.Tensor):
            return t
        shape = list(t.shape)
        shape[dim] = self.batch
        return DTensor.from_local(t, self.mesh, self.rows(dim),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    def _carry(self, carry, fn):
        if carry is None:
            return None
        lr = carry.lowrank
        alpha = lr.alpha.full_tensor() if isinstance(lr.alpha, DTensor) \
            else lr.alpha
        return SolveCarry(
            z=fn(carry.z, 0),
            lowrank=LowRank(alpha=alpha, u=fn(lr.u, 1), v=fn(lr.v, 1),
                            count=fn(lr.count, 0)),
            warm=fn(carry.warm, 0), age=fn(carry.age, 0))

    def local_carry(self, carry):
        return self._carry(carry, self.local)

    def place_carry(self, carry):
        return self._carry(carry, self.place)

    def place_result(self, res: SolveResult) -> SolveResult:
        """The solve's result with its state, per-row vectors and carry as
        DTensors; the inverse estimate stays local (the backward's)."""
        return res._replace(
            z=self.place(res.z), residual=self.place(res.residual),
            converged=self.place(res.converged),
            trace=self.place(res.trace, 1), status=self.place(res.status),
            carry=self.place_carry(res.carry))


def solve_forward(f_z, z0, cfg: ImplicitConfig, *, outer_grad=None,
                  freeze_mask=None, carry=None, layout=None):
    """The registered forward solver; with a ``layout`` it runs on this
    rank's rows (``f_z`` and ``outer_grad`` keep their DTensor states) and
    the result comes back placed, its ``lowrank`` local."""
    solver = SOLVERS.get(cfg.forward.solver)
    if layout is None:
        res = _builtin_solvers.call_solver(
            solver, f_z, z0, cfg.solver_cfg(), outer_grad=outer_grad,
            freeze_mask=freeze_mask, carry=carry)
        obs_tracing.phase_done("forward_solve", res.z)
        return res
    lay = layout
    outer = None if outer_grad is None else \
        (lambda zl: lay.local(outer_grad(lay.place(zl))))
    with stop_tests_over(lay.group):
        res = _builtin_solvers.call_solver(
            solver, lambda zl: lay.local(f_z(lay.place(zl))),
            lay.local(z0), cfg.solver_cfg(), outer_grad=outer,
            freeze_mask=lay.local(freeze_mask),
            carry=lay.local_carry(carry))
    obs_tracing.phase_done("forward_solve", res.z)
    return lay.place_result(res)


def _bind_outer(outer_grad, params, x):
    if outer_grad is None:
        return None
    return lambda z: outer_grad(params, x, z)


def _flatten(tree) -> tuple[list, Callable[[list], Any]]:
    """Leaves of a tree of dicts, lists and tuples (tensors and other
    values), and the function that rebuilds the tree from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]

    def rebuild(new: list):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


class _Problem:
    """What the autograd function needs besides its tensor inputs."""

    def __init__(self, f_flat, cfg: ImplicitConfig, carry, rebuild,
                 outer_flat=None, layout=None):
        self.f_flat, self.cfg, self.carry = f_flat, cfg, carry
        self.rebuild, self.outer_flat = rebuild, outer_flat
        self.layout = layout
        self.result = None

    def f(self, leaves: list, z: torch.Tensor) -> torch.Tensor:
        tree = self.rebuild(list(leaves))
        return self.f_flat(tree[0], tree[1], z)


class _ImplicitFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, prob: _Problem, z0, *leaves):
        # the solve sees detached leaves: a solver that turns gradients on
        # (adjoint Broyden's VJP in z) builds no graph into the parameters
        fixed = [t.detach() if isinstance(t, torch.Tensor) else t
                 for t in leaves]
        outer = None
        if prob.outer_flat is not None:
            p, xx = prob.rebuild(list(fixed))
            outer = _bind_outer(prob.outer_flat, p, xx)
        with torch.no_grad():
            res = solve_forward(lambda z: prob.f(fixed, z), z0, prob.cfg,
                                outer_grad=outer, carry=prob.carry,
                                layout=prob.layout)
        prob.result = res
        ctx.prob = prob
        ctx.H, ctx.status = res.lowrank, res.status
        tensors = [t if isinstance(t, torch.Tensor) else None
                   for t in leaves]
        ctx.others = [None if isinstance(t, torch.Tensor) else t
                      for t in leaves]
        ctx.save_for_backward(res.z, *tensors)
        return res.z

    @staticmethod
    def backward(ctx, w):
        z_star, *tensors = ctx.saved_tensors
        prob = ctx.prob
        lay = prob.layout
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [
                o if t is None else
                t.detach().requires_grad_(bool(n) and t.is_floating_point())
                for t, o, n in zip(tensors, ctx.others, needs)]
            zr = z_star.detach().requires_grad_(True)
            y = prob.f(leaves, zr)

        def vjp_z(u):
            return torch.autograd.grad(y, zr, u.to(y.dtype),
                                       retain_graph=True)[0]

        cfg = prob.cfg
        if lay is None:
            adj = estimate_cotangent(cfg, vjp_z, w, ctx.H,
                                     forward_status=ctx.status)
        else:  # on this rank's rows, beside the forward's local ring
            with stop_tests_over(lay.group):
                adj = estimate_cotangent(
                    cfg, lambda ul: lay.local(vjp_z(lay.place(ul))),
                    lay.local(w), ctx.H,
                    forward_status=lay.local(ctx.status))
        obs_metrics.record_backward(cfg.backward.estimator, adj)
        obs_tracing.phase_done("implicit_backward", adj.u)
        u = adj.u
        row_ok = torch.isfinite(u).reshape(u.shape[0], -1).all(dim=1)
        u = torch.where(_expand(row_ok, u), u,
                        torch.zeros((), dtype=u.dtype, device=u.device))
        obs_metrics.emit_scalar("backward_cotangents_zeroed_total",
                                (~row_ok).sum(), kind="counter")
        if lay is not None:
            u = lay.place(u)
        wanted = [i for i, t in enumerate(leaves)
                  if isinstance(t, torch.Tensor) and t.requires_grad]
        grads = torch.autograd.grad(y, [leaves[i] for i in wanted],
                                    u.to(y.dtype), allow_unused=True)
        out = [None] * len(leaves)
        for i, g in zip(wanted, grads):
            out[i] = g
        ctx.H = ctx.prob = None
        # no gradient to z0: the start point does not move z*
        return (None, None, *out)


def implicit_fixed_point(
    f: Callable[[Any, Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: Any,
    z0: torch.Tensor,
    cfg: ImplicitConfig,
    *,
    outer_grad: Callable[[Any, Any, torch.Tensor], torch.Tensor] | None = None,
    carry: SolveCarry | None = None,
    ctx=None,
    state_axes=None,
):
    """Differentiable fixed point of ``z = f(params, x, z)``.  Returns
    ``(z*, stats)``, or ``(z*, stats, new_carry)`` when ``carry`` is given;
    the returned carry holds no gradient.

    ``outer_grad(params, x, z) -> dL/dz`` (the state's shape) enables the
    OPA extra updates of the adjoint-Broyden forward (paper §2.3); other
    solvers ignore it.

    Everything that needs a gradient must flow through ``params`` and
    ``x`` (trees of dicts, lists and tuples of tensors), never through
    ``f``'s closure.

    ``ctx`` (a ``ShardCtx``) and ``state_axes`` (the state's logical axes)
    lay the solve out on a running mesh (``SolveLayout``); the returned
    carry's leaves are then DTensors, its ring batch-split."""
    z0_flat, unravel, f_flat = prepare_flat_problem(f, z0)
    layout = SolveLayout.make(ctx, state_axes, z0_flat)
    outer_flat = None
    if outer_grad is not None:
        def outer_flat(p, xx, z_flat):
            return ravel_state(outer_grad(p, xx, unravel(z_flat)))[0]
    leaves, rebuild = _flatten((params, x))
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in leaves):
        prob = _Problem(f_flat, cfg, carry, rebuild, outer_flat, layout)
        z = _ImplicitFn.apply(prob, z0_flat.detach(), *leaves)
        res = prob.result
    else:
        with torch.no_grad():
            res = solve_forward(lambda zz: f_flat(params, x, zz), z0_flat,
                                cfg, outer_grad=_bind_outer(outer_flat,
                                                            params, x),
                                carry=carry, layout=layout)
        z = res.z
    obs_metrics.record_solve("forward", res, carry=carry)
    stats = ImplicitStats(res.residual, res.n_steps, res.converged,
                          res.trace, res.tape, res.status)
    if carry is None:
        return unravel(z), stats
    new_carry = res.carry
    if new_carry is not None:
        new_carry = dataclasses.replace(new_carry, z=new_carry.z.detach())
    return unravel(z), stats, new_carry


def carry_for_state(z0: Any, cfg: ImplicitConfig, *,
                    dtype=None) -> SolveCarry:
    """An all-cold :class:`SolveCarry` for the flat solver state of
    ``z0`` (a single-leaf state keeps its shape; a multi-leaf state packs
    to ``(B, D)``) with ``cfg.memory`` ring slots in ``cfg.qn_dtype``, on
    ``z0``'s device."""
    z0_flat = ravel_state(z0)[0]
    return init_solve_carry(
        z0_flat.shape[0], tuple(z0_flat.shape[1:]), cfg.memory,
        dtype=dtype or z0_flat.dtype, qn_dtype=cfg.qn_dtype,
        device=z0_flat.device)
