"""The port's Picard, Anderson and adjoint-Broyden solvers against the JAX
package's.

Identical numpy problems (a linear map and a tanh map, as in
``tests/test_solvers.py``) go through ``repro.core.solvers`` (jitted) and
``repro_torch.core.solvers`` on the CPU: cold, warm-started from a carry
with a frozen row, through the guard's entry repair of a NaN carry, and
with a Picard damping or Anderson mixing factor other than 1.  Then the
smoke LM's ``loss_fn`` and every gradient leaf with each solver under the
``shine_fallback`` and ``jfb`` backwards, the registry, and the identity
inverse Picard and Anderson hand the backward.

Tolerances.  Picard: the same step count and statuses, the residual trace
at rtol 1e-4 (atol 1e-6, the f32 floor of an O(1) residual) and the
iterate at rtol 1e-4 (atol 1e-5).  Anderson: the same, but the trace at
rtol 1e-2: its weights come from a small solve over a window that grows
nearly collinear, which moves last-bit differences (the two tanh, the two
LU solves) to ~1e-2 of a residual.  Adjoint Broyden applies two f32
chains built from VJPs that the packages round differently: the same step
count and statuses, the trace at rtol 5e-3 (atol 1e-6), the iterate at
rtol 1e-4 (atol 1e-5) and ``H^T w`` at rtol 2e-2 plus 2e-3 of its largest
entry.  The LM: the loss at rtol 1e-5 and the same forward steps; gradients
at rtol 1e-2 plus 1e-3 of each leaf's largest entry, as
``tests/test_torch_training.py`` holds the Broyden arm.

Two differences from the reference, each held here:

  * Anderson's ridge.  Jitted on the CPU, XLA folds the Gram matrix's
    diagonal term ``ridge + (1 - valid)`` into ``(ridge + 1) - valid``,
    which is 0 in f32 for a live slot: the compiled reference solves
    without the ridge.  The port keeps the ridge as written; it matches the
    reference run eagerly (``jax.disable_jit``) and, with ``ridge=0``, the
    jitted reference.
  * The placeholder inverse of Picard and Anderson.  The reference's
    ``(1, B, 1)`` ring does not broadcast against the LM's ``(B, S, d)``
    state, so its ``shine_fallback`` backward raises there.  The port's
    placeholder has the state's shape and gives ``H^T w = w`` exactly: its
    ``shine_fallback`` gradient is the reference's ``jfb`` gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import solvers as jsol
from repro.data.pipeline import SyntheticTokenDataset as JDataset
from repro.implicit import SOLVERS as JSOLVERS
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx
from repro_torch.configs.registry import smoke_config
from repro_torch.core import solvers as tsol
from repro_torch.implicit import SOLVERS as TSOLVERS
from repro_torch.implicit import ImplicitConfig
from repro_torch.implicit.estimators import estimate_cotangent
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import lm as tlm

CTX = ShardCtx.for_mesh(None)


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched inside the block; a host read is an
    ``aten._local_scalar_dense``."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))

    @property
    def reads(self) -> int:
        return self.ops.count("aten._local_scalar_dense.default")
TOL_TRACE = dict(rtol=1e-4, atol=1e-6)
TOL_Z = dict(rtol=1e-4, atol=1e-5)
TOL_TRACE_ANDERSON = dict(rtol=1e-2, atol=1e-6)
TOL_TRACE_ADJOINT = dict(rtol=5e-3, atol=1e-6)


def _linear(seed, bsz=4, d=24, contraction=0.5):
    rng = np.random.default_rng(seed)
    a = (contraction * rng.standard_normal((d, d)) / np.sqrt(d)
         ).astype(np.float32)
    b = rng.standard_normal((bsz, d)).astype(np.float32)
    z_star = np.linalg.solve(np.eye(d) - a.astype(np.float64),
                             b.T.astype(np.float64)).T
    return a, b, z_star


def _maps(kind, a, b):
    """``(f_jax, f_torch)``: ``z A^T + b`` or ``tanh(z A^T) + b``."""
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    if kind == "linear":
        return (lambda z: z @ aj.T + bj), (lambda z: z @ at.T + bt)
    return (lambda z: jnp.tanh(z @ aj.T) + bj,
            lambda z: torch.tanh(z @ at.T) + bt)


def _problem(kind, seed):
    if kind == "linear":
        a, b, _ = _linear(seed, contraction=0.4)
    else:
        rng = np.random.default_rng(seed)
        a = (0.6 * rng.standard_normal((20, 20)) / np.sqrt(20)
             ).astype(np.float32)
        b = rng.standard_normal((2, 20)).astype(np.float32)
    return a, b


def _residual(f):
    return lambda z: z - f(z)


def _cfgs(**kw):
    return jsol.SolverConfig(**kw), tsol.SolverConfig(**kw)


def _jax_solve(name, fn, z0, cfg, **kw):
    """The JAX solver, jitted over the start point and the carry."""
    solve = getattr(jsol, f"{name}_solve")
    carry = kw.pop("carry", None)
    return jax.jit(lambda z, c: solve(fn, z, cfg, carry=c, **kw))(
        jnp.asarray(z0), carry)


def _torch_solve(name, fn, z0, cfg, **kw):
    return getattr(tsol, f"{name}_solve")(fn, torch.from_numpy(z0), cfg,
                                          **kw)


def _assert_same(rt, rj, trace_tol=TOL_TRACE):
    assert int(rt.n_steps) == int(rj.n_steps)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace),
                               **trace_tol)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               **trace_tol)
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), **TOL_Z)


def _torch_carry(jc):
    """A JAX carry's arrays as a port carry (numpy round trip)."""
    lr = jc.lowrank
    dt = torch.bfloat16 if lr.u.dtype == jnp.bfloat16 else torch.float32
    ring = (lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
            .to(dt))
    return tsol.SolveCarry(
        z=torch.from_numpy(np.array(jc.z)),
        lowrank=tsol.LowRank(alpha=torch.tensor(float(lr.alpha)),
                             u=ring(lr.u), v=ring(lr.v),
                             count=torch.from_numpy(np.array(lr.count))),
        warm=torch.from_numpy(np.array(jc.warm)),
        age=torch.from_numpy(np.array(jc.age)))


# ---------------------------------------------------------------------------
# Picard and Anderson
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "tanh"])
def test_fixed_point_matches_jax(kind):
    a, b = _problem(kind, 4)
    fj, ft = _maps(kind, a, b)
    jcfg, tcfg = _cfgs(max_steps=200, tol=1e-5)
    z0 = np.zeros(b.shape, np.float32)
    rj = _jax_solve("fixed_point", fj, z0, jcfg)
    rt = _torch_solve("fixed_point", ft, z0, tcfg)
    _assert_same(rt, rj)
    assert int(rt.n_steps) > 5 and bool(rt.converged.all())
    # unroll runs all max_steps iterations with no early exit; the converged
    # rows stop moving, so the iterate and trace are the early exit's
    ru = _torch_solve("fixed_point", ft, z0,
                      dataclasses.replace(tcfg, unroll=True))
    assert ru.n_steps == tcfg.max_steps
    assert torch.equal(ru.z, rt.z) and torch.equal(ru.trace, rt.trace)


@pytest.mark.parametrize("kind,carried", [("linear", False),
                                          ("tanh", True)])
def test_fixed_point_unroll_matches_jax_without_a_host_read(kind, carried):
    """``unroll=True``: the reference's unrolled loop (max_steps bodies,
    run eagerly: jitting them takes longer than the test), no host read,
    converged rows bit for bit the early exit's iterate."""
    a, b = _problem(kind, 4)
    fj, ft = _maps(kind, a, b)
    jcfg, tcfg = _cfgs(max_steps=30, tol=1e-5, unroll=True)
    z0 = np.zeros(b.shape, np.float32)
    jc = tc = None
    if carried:
        jc = jsol.init_solve_carry(b.shape[0], b.shape[1], 4,
                                   qn_dtype="float32")
        jc = dataclasses.replace(jc, z=jnp.full(b.shape, 0.1, jnp.float32),
                                 warm=jnp.asarray([True, False][:b.shape[0]]
                                                  + [True] * (b.shape[0] - 2)))
        tc = _torch_carry(jc)
    with jax.disable_jit():
        rj = jsol.fixed_point_solve(fj, jnp.asarray(z0), jcfg, carry=jc)
    with _OpLog() as log:
        rt = _torch_solve("fixed_point", ft, z0, tcfg, carry=tc)
    assert log.reads == 0
    _assert_same(rt, rj)
    assert rt.n_steps == 30 and bool(rt.converged.all())
    early = _torch_solve("fixed_point", ft, z0,
                         dataclasses.replace(tcfg, unroll=False),
                         carry=None if jc is None else _torch_carry(jc))
    assert early.n_steps < 30
    assert torch.equal(rt.z, early.z) and torch.equal(rt.trace, early.trace)


@pytest.mark.parametrize("kind", ["linear", "tanh"])
def test_anderson_matches_jax(kind):
    a, b = _problem(kind, 4)
    fj, ft = _maps(kind, a, b)
    jcfg, tcfg = _cfgs(max_steps=40, tol=1e-4, memory=5)
    z0 = np.zeros(b.shape, np.float32)
    # the ridge as written: the reference run eagerly
    with jax.disable_jit():
        rj = jsol.anderson_solve(fj, jnp.asarray(z0), jcfg)
    rt = _torch_solve("anderson", ft, z0, tcfg)
    _assert_same(rt, rj, TOL_TRACE_ANDERSON)
    # the compiled reference drops the ridge (module docstring)
    rj0 = _jax_solve("anderson", fj, z0, jcfg)
    rt0 = _torch_solve("anderson", ft, z0, tcfg, ridge=0.0)
    _assert_same(rt0, rj0, TOL_TRACE_ANDERSON)
    # without the ridge (the arithmetic the reference's own test runs)
    # Anderson needs fewer iterations than Picard
    rp = _torch_solve("fixed_point", ft, z0,
                      dataclasses.replace(tcfg, max_steps=200))
    assert bool(rt.converged.all()) and bool(rt0.converged.all())
    assert int(rt0.n_steps) < int(rp.n_steps)
    np.testing.assert_array_equal(rt.tape.qn_count.numpy(),
                                  np.asarray(rj.tape.qn_count))


# ---------------------------------------------------------------------------
# Adjoint Broyden and OPA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "tanh"])
def test_adjoint_broyden_matches_jax(kind):
    a, b = _problem(kind, 5)
    fj, ft = _maps(kind, a, b)
    jcfg, tcfg = _cfgs(max_steps=40, tol=1e-4, memory=20)
    z0 = np.zeros(b.shape, np.float32)
    rj = _jax_solve("adjoint_broyden", _residual(fj), z0, jcfg)
    rt = _torch_solve("adjoint_broyden", _residual(ft), z0, tcfg)
    _assert_same(rt, rj, TOL_TRACE_ADJOINT)
    assert int(rt.n_steps) > 5 and bool(rt.converged.all())
    # both chains are f32 whatever qn_dtype says; B rides in aux
    assert rt.lowrank.u.dtype == torch.float32
    assert rt.aux["B"].u.dtype == torch.float32
    np.testing.assert_array_equal(rt.lowrank.count.numpy(),
                                  np.asarray(rj.lowrank.count))
    w = np.random.default_rng(6).standard_normal(b.shape).astype(np.float32)
    for got, want in ((rt.lowrank.rmatvec(torch.from_numpy(w)),
                       rj.lowrank.rmatvec(jnp.asarray(w))),
                      (rt.aux["B"].rmatvec(torch.from_numpy(w)),
                       rj.aux["B"].rmatvec(jnp.asarray(w)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                                   atol=2e-3 * np.abs(want).max())


def test_adjoint_broyden_converges_and_B_secant():
    """``tests/test_solvers.py``'s check on the port: H = B^{-1} inverts J
    along J^T sigma (cos > 0.5)."""
    a, b, z_star = _linear(5)
    _, ft = _maps("linear", a, b)
    cfg = tsol.SolverConfig(max_steps=60, tol=1e-8, memory=60)
    res = _torch_solve("adjoint_broyden", _residual(ft), np.zeros_like(b),
                       cfg)
    np.testing.assert_allclose(res.z.numpy(), z_star, rtol=1e-3, atol=1e-3)
    J = np.eye(a.shape[0]) - a
    w = np.random.default_rng(6).standard_normal(b.shape).astype(np.float32)
    hw = res.lowrank.rmatvec(torch.from_numpy(w)).numpy()
    target = np.linalg.solve(J.T, w.T).T
    cos = (hw * target).sum(-1) / (np.linalg.norm(hw, axis=-1)
                                   * np.linalg.norm(target, axis=-1))
    assert cos.min() > 0.5


def test_adjoint_broyden_opa_improves_prescribed_direction():
    """Theorem 4 on the port: with OPA updates along ``v_n = dL/dz B^-1``
    the inverse is at least as good along ``dL/dz`` (q1 > q0 - 0.05) and
    good (q1 > 0.75); ``H^T w`` with OPA matches the reference's."""
    rng = np.random.default_rng(7)
    bsz, d = 2, 20
    a = (0.6 * rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    b = rng.standard_normal((bsz, d)).astype(np.float32)
    w = rng.standard_normal((bsz, d)).astype(np.float32)
    fj, ft = _maps("tanh", a, b)
    z0 = np.zeros((bsz, d), np.float32)
    jcfg0, tcfg0 = _cfgs(max_steps=25, tol=1e-10, memory=50)
    jcfg1, tcfg1 = _cfgs(max_steps=25, tol=1e-10, memory=50, opa_freq=2)
    wt = torch.from_numpy(w)
    r0 = _torch_solve("adjoint_broyden", _residual(ft), z0, tcfg0)
    r1 = _torch_solve("adjoint_broyden", _residual(ft), z0, tcfg1,
                      outer_grad=lambda z: wt)

    def quality(res):
        J = torch.autograd.functional.jacobian(
            lambda z: _residual(ft)(z[None])[0], res.z[0])
        true = torch.linalg.solve(J.T, wt[0])
        est = res.lowrank.rmatvec(wt)[0]
        return float(true @ est / (true.norm() * est.norm()))

    q0, q1 = quality(r0), quality(r1)
    assert q1 > q0 - 0.05 and q1 > 0.75
    rj1 = _jax_solve("adjoint_broyden", _residual(fj), z0, jcfg1,
                     outer_grad=lambda z: jnp.asarray(w))
    assert r1.n_steps == int(rj1.n_steps)
    want = np.asarray(rj1.lowrank.rmatvec(jnp.asarray(w)))
    np.testing.assert_allclose(r1.lowrank.rmatvec(wt).numpy(), want,
                               rtol=2e-2, atol=2e-3 * np.abs(want).max())
    # OPA appends extra pairs: more than one per iteration
    assert int(r1.lowrank.count.min()) > int(r0.lowrank.count.max()) \
        or int(r1.lowrank.count.min()) > r1.n_steps


# ---------------------------------------------------------------------------
# Guard and carry
# ---------------------------------------------------------------------------


SOLVER_FAMILY = ["fixed_point", "anderson", "adjoint_broyden"]


def _family_problem(name, seed):
    a, b = _problem("tanh", seed)
    b = np.concatenate([b, b[::-1] * 0.5])  # B = 4
    fj, ft = _maps("tanh", a, b)
    if name == "adjoint_broyden":
        fj, ft = _residual(fj), _residual(ft)
    kw = dict(max_steps=60, tol=1e-4, memory=5)
    if name == "fixed_point":
        kw["max_steps"] = 200
    return a, b, fj, ft, _cfgs(**kw)


def _trace_tol(name):
    return {"adjoint_broyden": TOL_TRACE_ADJOINT,
            "anderson": TOL_TRACE_ANDERSON}.get(name, TOL_TRACE)


def _warm_carry(name, b, fj, jcfg):
    z0 = np.zeros(b.shape, np.float32)
    jc = jsol.init_solve_carry(b.shape[0], b.shape[1], jcfg.memory,
                               qn_dtype="float32")
    if name == "anderson":
        with jax.disable_jit():
            return jsol.anderson_solve(fj, jnp.asarray(z0), jcfg,
                                       carry=jc).carry
    return _jax_solve(name, fj, z0, jcfg, carry=jc).carry


def _jax_family(name, fj, z0, jcfg, **kw):
    if name == "anderson":  # the ridge as written (module docstring)
        with jax.disable_jit():
            kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in kw.items()}
            return jsol.anderson_solve(fj, jnp.asarray(z0), jcfg, **kw)
    return _jax_solve(name, fj, z0, jcfg, **kw)


@pytest.mark.parametrize("name", SOLVER_FAMILY)
def test_guard_entry_repairs_nan_carry_like_jax(name):
    a, b, fj, ft, (jcfg, tcfg) = _family_problem(name, 2)
    warm = _warm_carry(name, b, fj, jcfg)
    zbad = np.array(warm.z)
    zbad[1, 3] = np.nan
    bad = dataclasses.replace(warm, z=jnp.asarray(zbad))
    z0 = np.zeros(b.shape, np.float32)
    rj = _jax_family(name, fj, z0, jcfg, carry=bad)
    rt = _torch_solve(name, ft, z0, tcfg, carry=_torch_carry(bad))
    assert int(rt.status[1]) == tsol.STATUS_NONFINITE
    _assert_same(rt, rj, _trace_tol(name))
    np.testing.assert_array_equal(rt.aux["restarts"].numpy(),
                                  np.asarray(rj.aux["restarts"]))
    assert int(rt.aux["restarts"][1]) == 1
    assert np.isfinite(rt.z.numpy()).all()


@pytest.mark.parametrize("name", SOLVER_FAMILY)
def test_iterate_only_carry_reuse_keeps_frozen_rows(name):
    a, b, fj, ft, (jcfg, tcfg) = _family_problem(name, 3)
    warm = _warm_carry(name, b, fj, jcfg)
    b2 = b + np.float32(0.05)
    fj2, ft2 = _maps("tanh", a, b2)
    if name == "adjoint_broyden":
        fj2, ft2 = _residual(fj2), _residual(ft2)
    z0 = np.zeros(b.shape, np.float32)
    frz = np.array([True, False, False, False])
    tc = _torch_carry(warm)
    ring = tc.lowrank.clone()
    rj = _jax_family(name, fj2, z0, jcfg, carry=warm, freeze_mask=frz)
    rt = _torch_solve(name, ft2, z0, tcfg, carry=tc,
                      freeze_mask=torch.from_numpy(frz))
    _assert_same(rt, rj, _trace_tol(name))
    # the frozen row starts at its carried iterate and never moves
    assert torch.equal(rt.z[0], tc.z[0])
    assert torch.equal(rt.carry.z[0], tc.z[0])
    assert np.isinf(rt.trace[:, 0].numpy()).all()
    assert int(rt.carry.age[0]) == int(tc.age[0])
    np.testing.assert_array_equal(rt.carry.age.numpy(),
                                  np.asarray(rj.carry.age))
    np.testing.assert_array_equal(rt.carry.lowrank.count.numpy(),
                                  np.asarray(rj.carry.lowrank.count))
    if name == "adjoint_broyden":
        # the new H chain, cast to the carry's ring dtype
        assert rt.carry.lowrank.u.dtype == tc.lowrank.u.dtype
        assert torch.equal(rt.carry.lowrank.u, rt.lowrank.u.to(
            tc.lowrank.u.dtype))
    else:
        # iterate-only: the carried ring passes through untouched
        assert torch.equal(rt.carry.lowrank.u, ring.u)
        assert torch.equal(rt.carry.lowrank.v, ring.v)
        assert torch.equal(rt.carry.lowrank.count, ring.count)
    # the warm start helps the live rows
    assert int(rt.n_steps) < int(_torch_solve(name, ft2, z0, tcfg).n_steps)


@pytest.mark.parametrize("name", ["fixed_point", "anderson"])
def test_bf16_state_keeps_its_dtype_through_restart_damping(name):
    """The f32 restart scale must not widen a bf16 state (the JAX
    package's while_loop refuses the widened iterate; the port casts the
    damped mixture back)."""
    a, b, _, ft, (_, tcfg) = _family_problem(name, 4)
    tcfg = dataclasses.replace(tcfg, restart_damping=0.5, tol=5e-2)
    zc = torch.zeros(b.shape, dtype=torch.bfloat16)
    zc[2, 0] = float("nan")
    carry = tsol.SolveCarry(
        z=zc, lowrank=tsol.LowRank.identity(b.shape[0], b.shape[1], 5,
                                            dtype=torch.bfloat16),
        warm=torch.ones(b.shape[0], dtype=torch.bool),
        age=torch.zeros(b.shape[0], dtype=torch.int32))
    fb = lambda z: ft(z.float()).to(torch.bfloat16)  # noqa: E731
    res = getattr(tsol, f"{name}_solve")(
        fb, torch.zeros(b.shape, dtype=torch.bfloat16), tcfg, carry=carry)
    assert res.z.dtype == torch.bfloat16
    assert int(res.status[2]) == tsol.STATUS_NONFINITE
    assert torch.isfinite(res.z.float()).all()
    assert bool(res.converged.all())


@pytest.mark.parametrize("nan_carry", [False, True])
@pytest.mark.parametrize("name,knob,value", [
    ("fixed_point", "damping", 0.7),
    ("anderson", "mixing", 0.5),
])
def test_damping_and_mixing_match_jax(name, knob, value, nan_carry):
    """A damping or mixing factor other than 1 gives the reference's
    iterates, alone and (``nan_carry``) composed with the guard's restart
    damping of a repaired row."""
    a, b, fj, ft, (jcfg, tcfg) = _family_problem(name, 5)
    kw = {knob: value}
    z0 = np.zeros(b.shape, np.float32)
    tkw = dict(kw)
    if nan_carry:
        jcfg = dataclasses.replace(jcfg, restart_damping=0.5)
        tcfg = dataclasses.replace(tcfg, restart_damping=0.5)
        warm = _warm_carry(name, b, fj, jcfg)
        zbad = np.array(warm.z)
        zbad[2, 1] = np.nan
        kw["carry"] = dataclasses.replace(warm, z=jnp.asarray(zbad))
        tkw["carry"] = _torch_carry(kw["carry"])
    rj = _jax_family(name, fj, z0, jcfg, **kw)
    rt = _torch_solve(name, ft, z0, tcfg, **tkw)
    _assert_same(rt, rj, _trace_tol(name))
    assert bool(rt.converged.all())
    # the knob is live: a different iteration count from the default
    assert int(rt.n_steps) != int(_torch_solve(name, ft, z0, tcfg,
                                               **{**tkw, knob: 1.0}).n_steps)
    if nan_carry:
        assert int(rt.status[2]) == tsol.STATUS_NONFINITE
        np.testing.assert_array_equal(rt.aux["restarts"].numpy(),
                                      np.asarray(rj.aux["restarts"]))


# ---------------------------------------------------------------------------
# The placeholder inverse and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fixed_point", "anderson"])
def test_placeholder_inverse_is_the_identity(name):
    """Picard and Anderson hand the backward ``H = I`` with the state's
    feature shape (the LM's is ``(B, S, d)``): ``H^T w`` is ``w`` bit for
    bit through ``qn_apply_multi``, one stream call, and a
    ``shine_fallback`` estimate is the JFB one."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, generator=g)
    res = getattr(tsol, f"{name}_solve")(
        lambda z: 0.5 * torch.tanh(z) + x, torch.zeros_like(x),
        tsol.SolverConfig(max_steps=30, tol=1e-5, memory=4))
    H = res.lowrank
    assert tuple(H.u.shape) == (1, 2, 3, 8)
    assert int(H.count.max()) == 0
    w = torch.randn(2, 3, 8, generator=g)
    kernel_ops.reset_qn_stream_stats()
    assert torch.equal(H.rmatvec(w), w)
    assert kernel_ops.qn_stream_stats().calls == 1
    cfg = ImplicitConfig.from_strings(solver=name,
                                      backward="shine_fallback")
    adj = estimate_cotangent(cfg, lambda u: 0.5 * u, w, H,
                             forward_status=res.status)
    assert torch.equal(adj.u, w) and not bool(adj.fallback_mask.any())


def test_registry_names_match_jax():
    assert TSOLVERS.names() == JSOLVERS.names()
    assert set(TSOLVERS.names()) == {"broyden", "adjoint_broyden",
                                     "fixed_point", "anderson"}


# ---------------------------------------------------------------------------
# The smoke LM, each solver and backward
# ---------------------------------------------------------------------------


def _lm_cfg(make, solver, backward):
    cfg = make("minicpm-2b", deq=True)
    return dataclasses.replace(
        cfg, dtype="float32",
        deq=dataclasses.replace(cfg.deq, qn_dtype="float32", solver=solver,
                                backward=backward))


@pytest.fixture(scope="module")
def lm_params():
    """JAX parameters (blocks x0.3) as a JAX tree and as numpy."""
    p = jlm.init_params(_lm_cfg(jax_smoke_config, "broyden", "jfb"),
                        jax.random.PRNGKey(0))
    p["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                             p["deq_blocks"])
    return p, jax.tree_util.tree_map(np.asarray, p)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("solver,backward", [
    ("adjoint_broyden", "shine_fallback"), ("adjoint_broyden", "jfb"),
    ("anderson", "shine_fallback"), ("anderson", "jfb"),
    ("fixed_point", "shine_fallback"), ("fixed_point", "jfb")])
def test_lm_loss_and_every_gradient_leaf_match_jax(lm_params, solver,
                                                   backward):
    jp, npp = lm_params
    tcfg = _lm_cfg(smoke_config, solver, backward)
    # the identity placeholder makes Picard/Anderson's shine_fallback the
    # JFB backward; the reference's own raises on the LM state
    ref_backward = ("jfb" if solver != "adjoint_broyden" else backward)
    jcfg = _lm_cfg(jax_smoke_config, solver, ref_backward)
    toks = JDataset(jcfg.vocab_size, 0).batch(0, 2, 9)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "targets": torch.from_numpy(toks[:, 1:])}

    def jax_grads(cfg):
        return jax.jit(jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jb, cfg, CTX, z_loss=1e-4),
            has_aux=True))(jp)

    if ref_backward != backward:
        with pytest.raises(ValueError, match="broadcast"):
            jax_grads(_lm_cfg(jax_smoke_config, solver, backward))
    (lj, mj), gj = jax_grads(jcfg)
    tp = jax.tree_util.tree_map(
        lambda a: a.requires_grad_(True), tlm.params_from_jax(npp, "cpu"))
    lt, mt = tlm.loss_fn(tp, tb, tcfg, z_loss=1e-4)
    lt.backward()
    assert mt["deq_steps"] == float(mj["deq_steps"]) > 1
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    jleaves = dict(_leaves(gj))
    n = 0
    for path, t in _leaves(tp):
        want = np.asarray(jleaves[path])
        assert t.grad is not None, path
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-2,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=path)
        n += 1
    assert n == len(jleaves) == 11


@pytest.mark.parametrize("with_grad", [False, True])
def test_outer_grad_reaches_opa_through_implicit_fixed_point(with_grad):
    """``implicit_fixed_point(outer_grad=...)`` binds ``dL/dz`` per call and
    hands it to adjoint Broyden's OPA updates, on the inference path and
    inside the autograd function, as the reference does."""
    from repro.implicit import ImplicitConfig as JImplicitConfig
    from repro.implicit import implicit_fixed_point as jifp
    from repro_torch.implicit import implicit_fixed_point as tifp
    rng = np.random.default_rng(8)
    a = (0.6 * rng.standard_normal((20, 20)) / np.sqrt(20)).astype(np.float32)
    x = rng.standard_normal((2, 20)).astype(np.float32)
    w = rng.standard_normal((2, 20)).astype(np.float32)
    kw = dict(solver="adjoint_broyden", backward="shine", max_steps=25,
              tol=1e-6, memory=20)
    jcfg = dataclasses.replace(
        JImplicitConfig.from_strings(**kw), forward=dataclasses.replace(
            JImplicitConfig.from_strings(**kw).forward, opa_freq=2))
    tcfg = dataclasses.replace(
        ImplicitConfig.from_strings(**kw), forward=dataclasses.replace(
            ImplicitConfig.from_strings(**kw).forward, opa_freq=2))
    zj, sj = jax.jit(lambda p, xx: jifp(
        lambda p_, x_, z: jnp.tanh(z @ p_.T) + x_, p, xx,
        jnp.zeros_like(xx), jcfg,
        outer_grad=lambda p_, x_, z: jnp.asarray(w)))(jnp.asarray(a),
                                                     jnp.asarray(x))
    at = torch.from_numpy(a).requires_grad_(with_grad)
    wt = torch.from_numpy(w)
    seen = []

    def outer(p, xx, z):
        seen.append(p.requires_grad)
        return wt

    zt, st = tifp(lambda p_, x_, z: torch.tanh(z @ p_.T) + x_, at,
                  torch.from_numpy(x), torch.zeros(2, 20), tcfg,
                  outer_grad=outer)
    assert seen and not any(seen)  # called with detached parameters
    assert int(st.n_steps) == int(sj.n_steps)
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj), **TOL_Z)
    np.testing.assert_allclose(st.trace.numpy(), np.asarray(sj.trace),
                               **TOL_TRACE_ADJOINT)
    # without outer_grad the solve takes another path
    _, s0 = tifp(lambda p_, x_, z: torch.tanh(z @ p_.T) + x_, at,
                 torch.from_numpy(x), torch.zeros(2, 20), tcfg)
    assert not torch.equal(s0.trace, st.trace)
