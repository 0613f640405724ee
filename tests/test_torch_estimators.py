"""The port's SHINE backward against the JAX package's.

A small tanh DEQ, ``z = tanh(z W^T + x)`` with ``B=4, D=12`` and numpy
inputs from one seed, goes through both packages on the CPU with an f32
quasi-Newton ring:

  * every registered estimator's cotangent ``u`` and ``fallback_mask``
    (``estimate_cotangent`` on each package's own forward solve), with a
    fallback ratio that fires on some rows and not others, and a forward
    status that flags one row for ``shine_cascade``;
  * every estimator's gradient of a loss through ``implicit_fixed_point``
    with respect to ``W`` and ``x``;
  * the backward's contract: ``z*`` bit for bit as the solver gives it, no
    gradient to ``z0`` or the carry, and non-finite cotangent rows zeroed
    and counted.

Tolerances.  The estimators take the JAX forward solve's ``z*`` and ``H``
in both packages, so they are held at rtol 1e-4, atol 1e-5 (f32, only the
summation order differs), with identical step counts and masks.  End to
end, each package builds its own ``H`` from ~10 Broyden pairs whose
denominators ``s^T H y`` shrink as the solve converges: f32 rounding of the
two solvers' iterates (their residual traces agree to ~3e-4 relative) moves
the last pairs, and with them ``H^T w``, by ~1e-3 of the gradient's scale.
So the gradients of the estimators that apply ``H`` are held at rtol 2e-3
plus an atol of 1e-3 x the largest entry; ``jfb``, ``jfb_refine`` and
``full`` do not apply ``H`` and stay at the tight tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as jsol
from repro.implicit import AdjointResult as JAdjointResult
from repro.implicit import BackwardConfig as JBackwardConfig
from repro.implicit import ForwardConfig as JForwardConfig
from repro.implicit import ImplicitConfig as JImplicitConfig
from repro.implicit import implicit_fixed_point as j_implicit
from repro.implicit.estimators import estimate_cotangent as j_estimate
from repro_torch.core import solvers as tsol
from repro_torch.implicit import (
    BackwardConfig,
    ESTIMATORS,
    ForwardConfig,
    ImplicitConfig,
    implicit_fixed_point,
    init_solve_carry,
    register_estimator,
)
from repro_torch.implicit.estimators import AdjointResult, estimate_cotangent
from repro_torch.obs import metrics as obs_metrics

B, D = 4, 12
TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = ["full", "jfb", "jfb_refine", "shine", "shine_cascade",
         "shine_fallback", "shine_refine"]

_rng = np.random.default_rng(0)
W = (0.9 * _rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
X = _rng.standard_normal((B, D)).astype(np.float32)
C = _rng.standard_normal((B, D)).astype(np.float32)   # loss weights
WCOT = _rng.standard_normal((B, D)).astype(np.float32)  # a cotangent


def fj(p, x, z):
    return jnp.tanh(z @ p.T + x)


def ft(p, x, z):
    return torch.tanh(z @ p.T + x)


def _cfgs(name, ratio=1.3):
    kw = dict(max_steps=40, tol=1e-4)
    bk = dict(estimator=name, max_steps=20, refine_steps=4, tol=1e-7,
              fallback_ratio=ratio)
    return (JImplicitConfig(forward=JForwardConfig(**kw),
                            backward=JBackwardConfig(**bk), memory=8,
                            qn_dtype="float32"),
            ImplicitConfig(forward=ForwardConfig(**kw),
                           backward=BackwardConfig(**bk), memory=8,
                           qn_dtype="float32"))


@pytest.fixture(scope="module")
def forward_solve():
    """The JAX forward solve of the tanh DEQ (its ``z*`` and ``H`` feed both
    packages' estimators), and the fallback ratio that splits the rows
    (midway across the widest gap of the ``||H^T w|| / ||w||`` ratios)."""
    jcfg, _ = _cfgs("shine")
    rj = jsol.broyden_solve(lambda z: z - fj(W, X, z),
                            jnp.zeros((B, D)), jcfg.solver_cfg())
    u = np.asarray(rj.lowrank.rmatvec(jnp.asarray(WCOT)))
    r = np.sort(np.linalg.norm(u, axis=1) / np.linalg.norm(WCOT, axis=1))
    gap = int(np.argmax(np.diff(r)))
    assert r[gap + 1] - r[gap] > 1e-2, r
    return rj, float((r[gap] + r[gap + 1]) / 2)


@pytest.mark.parametrize("name", NAMES)
def test_estimator_cotangent_and_fallback_match_jax(forward_solve, name):
    rj, ratio = forward_solve
    jcfg, tcfg = _cfgs(name, ratio)
    status = np.array([0, 2, 0, 1], np.int32)  # row 1 faulted (DIVERGED)
    def jax_estimate(z, lowrank, w, st):
        _, vjp = jax.vjp(lambda zz: fj(W, X, zz), z)
        return j_estimate(jcfg, lambda u: vjp(u)[0], w, lowrank,
                          forward_status=st)

    aj = jax.jit(jax_estimate)(rj.z, rj.lowrank, jnp.asarray(WCOT),
                               jnp.asarray(status))

    lr = rj.lowrank
    H = tsol.LowRank(alpha=torch.tensor(float(lr.alpha)),
                     u=torch.from_numpy(np.array(lr.u)),
                     v=torch.from_numpy(np.array(lr.v)),
                     count=torch.from_numpy(np.array(lr.count)))
    zt = torch.from_numpy(np.array(rj.z)).requires_grad_(True)
    with torch.enable_grad():
        y = ft(torch.from_numpy(W), torch.from_numpy(X), zt)
    at = estimate_cotangent(
        tcfg, lambda u: torch.autograd.grad(y, zt, u, retain_graph=True)[0],
        torch.from_numpy(WCOT), H, forward_status=torch.from_numpy(status))
    np.testing.assert_allclose(at.u.numpy(), np.asarray(aj.u), **TOL)
    np.testing.assert_array_equal(at.fallback_mask.numpy(),
                                  np.asarray(aj.fallback_mask))
    assert at.n_steps == int(aj.n_steps)
    if name in ("shine_fallback", "shine_refine"):
        assert 0 < int(at.fallback_mask.sum()) < B
    if name == "shine_cascade":
        assert bool(at.fallback_mask[1])  # the faulted row escalates


@pytest.mark.parametrize("name", NAMES)
def test_estimator_gradient_through_fixed_point_matches_jax(name):
    jcfg, tcfg = _cfgs(name)

    def jloss(p, x):
        z, _ = j_implicit(fj, p, x, jnp.zeros((B, D)), jcfg)
        return jnp.sum(z * z * C)

    lj, (gwj, gxj) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(W), jnp.asarray(X))
    p = torch.from_numpy(W).requires_grad_(True)
    x = torch.from_numpy(X).requires_grad_(True)
    z, stats = implicit_fixed_point(ft, p, x, torch.zeros(B, D), tcfg)
    lt = (z * z * torch.from_numpy(C)).sum()
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    for got, want in ((p.grad, gwj), (x.grad, gxj)):
        want = np.asarray(want)
        tol = (TOL if name in ("jfb", "jfb_refine", "full") else
               dict(rtol=2e-3, atol=1e-3 * np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, **tol)


def test_backward_contract_solver_z_no_grad_to_z0_or_carry():
    _, tcfg = _cfgs("shine_fallback")
    p = torch.from_numpy(W).requires_grad_(True)
    x = torch.from_numpy(X).requires_grad_(True)
    z0 = torch.zeros(B, D, requires_grad=True)
    carry = init_solve_carry(B, D, 8, qn_dtype="float32")
    z, stats, new_carry = implicit_fixed_point(ft, p, x, z0, tcfg,
                                               carry=carry)
    with torch.no_grad():
        ref = implicit_fixed_point(ft, p, x, z0, tcfg,
                                   carry=init_solve_carry(
                                       B, D, 8, qn_dtype="float32"))
    assert torch.equal(z.detach(), ref[0])  # the solver's z*, bit for bit
    assert not new_carry.z.requires_grad and new_carry.z.grad_fn is None
    (z * torch.from_numpy(C)).sum().backward()
    assert z0.grad is None and p.grad is not None and x.grad is not None
    assert torch.equal(new_carry.z, ref[2].z)


def test_nonfinite_cotangent_rows_are_zeroed_and_counted():
    name = "_test_poison_row0"

    @register_estimator(name)
    def _poison(cfg, ctx):
        u = ctx.w.clone()
        u[0] = float("nan")
        return AdjointResult(u, ctx.nan_residual, 0, ctx.no_fallback)

    # the count lands through the metrics bridge, which is off by default
    obs_metrics.set_enabled(True)
    try:
        base = _cfgs("jfb")[1]
        cfg = dataclasses.replace(
            base, backward=dataclasses.replace(base.backward, estimator=name))
        reg = obs_metrics.default_registry()
        counter = reg.counter("backward_cotangents_zeroed_total")
        before = counter.value
        grads = {}
        for est, c in (("poison", cfg), ("jfb", base)):
            p = torch.from_numpy(W).requires_grad_(True)
            z, _ = implicit_fixed_point(ft, p, torch.from_numpy(X),
                                        torch.zeros(B, D), c)
            cot = torch.from_numpy(C).clone()
            if est == "jfb":
                cot[0] = 0.0  # the row the poisoned estimator loses
            (z * cot).sum().backward()
            grads[est] = p.grad
        reg.flush()
        assert counter.value == before + 1
        assert torch.isfinite(grads["poison"]).all()
        np.testing.assert_allclose(grads["poison"].numpy(),
                                   grads["jfb"].numpy(), rtol=1e-6,
                                   atol=1e-7)
    finally:
        obs_metrics.set_enabled(False)
        ESTIMATORS._entries.pop(name, None)


def test_registered_estimators_match_the_jax_package():
    from repro.implicit import ESTIMATORS as JESTIMATORS
    assert ESTIMATORS.names() == sorted(NAMES) == [
        n for n in JESTIMATORS.names() if not n.startswith("_")]
    assert JAdjointResult._fields == AdjointResult._fields
