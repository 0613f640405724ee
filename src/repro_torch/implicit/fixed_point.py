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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

# populate the registries with the built-in solvers and estimators
from repro_torch.implicit import estimators as _builtin_estimators  # noqa: F401
from repro_torch.implicit import solvers as _builtin_solvers
from repro_torch.core.lowrank import _expand
from repro_torch.core.solvers import SolveCarry
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.estimators import estimate_cotangent
from repro_torch.implicit.pytree import prepare_flat_problem, ravel_state
from repro_torch.implicit.registry import SOLVERS
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.tape import SolveTape


class ImplicitStats(NamedTuple):
    residual: torch.Tensor    # (B,) forward residual at z*
    n_steps: int              # forward iterations
    converged: torch.Tensor   # (B,)
    trace: torch.Tensor       # (max_steps, B)
    tape: SolveTape | None = None
    status: torch.Tensor | None = None  # (B,) STATUS_* codes


def solve_forward(f_z, z0, cfg: ImplicitConfig, *, outer_grad=None,
                  freeze_mask=None, carry=None):
    solver = SOLVERS.get(cfg.forward.solver)
    res = _builtin_solvers.call_solver(
        solver, f_z, z0, cfg.solver_cfg(), outer_grad=outer_grad,
        freeze_mask=freeze_mask, carry=carry)
    obs_tracing.phase_done("forward_solve", res.z)
    return res


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
                 outer_flat=None):
        self.f_flat, self.cfg, self.carry = f_flat, cfg, carry
        self.rebuild, self.outer_flat = rebuild, outer_flat
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
                                outer_grad=outer, carry=prob.carry)
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
        adj = estimate_cotangent(cfg, vjp_z, w, ctx.H,
                                 forward_status=ctx.status)
        obs_metrics.record_backward(cfg.backward.estimator, adj)
        obs_tracing.phase_done("implicit_backward", adj.u)
        u = adj.u
        row_ok = torch.isfinite(u).reshape(u.shape[0], -1).all(dim=1)
        u = torch.where(_expand(row_ok, u), u,
                        torch.zeros((), dtype=u.dtype, device=u.device))
        obs_metrics.emit_scalar("backward_cotangents_zeroed_total",
                                (~row_ok).sum(), kind="counter")
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
):
    """Differentiable fixed point of ``z = f(params, x, z)``.  Returns
    ``(z*, stats)``, or ``(z*, stats, new_carry)`` when ``carry`` is given;
    the returned carry holds no gradient.

    ``outer_grad(params, x, z) -> dL/dz`` (the state's shape) enables the
    OPA extra updates of the adjoint-Broyden forward (paper §2.3); other
    solvers ignore it.

    Everything that needs a gradient must flow through ``params`` and
    ``x`` (trees of dicts, lists and tuples of tensors), never through
    ``f``'s closure."""
    z0_flat, unravel, f_flat = prepare_flat_problem(f, z0)
    outer_flat = None
    if outer_grad is not None:
        def outer_flat(p, xx, z_flat):
            return ravel_state(outer_grad(p, xx, unravel(z_flat)))[0]
    leaves, rebuild = _flatten((params, x))
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in leaves):
        prob = _Problem(f_flat, cfg, carry, rebuild, outer_flat)
        z = _ImplicitFn.apply(prob, z0_flat.detach(), *leaves)
        res = prob.result
    else:
        with torch.no_grad():
            res = solve_forward(lambda zz: f_flat(params, x, zz), z0_flat,
                                cfg, outer_grad=_bind_outer(outer_flat,
                                                            params, x),
                                carry=carry)
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
