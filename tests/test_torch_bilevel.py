"""The port's bi-level side (L-BFGS, CG, the hypergradient estimators, the
HOAG loop) and its DEQ hypergradients, against the JAX package's.

Parity, on identical data (``make_logreg_problem``'s numpy draws, one seed
for both packages; the JAX side jitted):

  * ``lbfgs_solve`` cold and warm (``mem0``), with and without OPA: the
    same ``n_steps`` and status, ``z`` and the memory at rtol 1e-4;
  * ``_cg``: the same iteration count, the result at rtol 1e-4;
  * ``estimate_hypergrad_cotangent`` for every HOAG mode, fed the JAX
    solve's ``z`` and memory: ``u`` at rtol 1e-3, the same HVP count;
  * 3 outer steps of ``run_hoag`` per mode: ``theta`` and ``val_loss`` at
    rtol 1e-3, equal ``inner_steps`` and ``backward_hvp_calls``.

One difference is recorded, not a tolerance: the Armijo line search
compares inner-objective values in f32.  Once the gradient norm falls to
~2e-4 on this problem the decrease it tests for is a few ulps of the
objective (~0.69), and the packages' summation orders decide the test
differently: the reference then backtracks to a null step and runs its
budget out while the port may stop (``test_line_search_floor_...``).  The
parity runs therefore stop the inner solves at 3e-4 and start at theta
0.05, where every decision is clear of that floor.

Host reads (the stop tests of the reference's ``while_loop``s, counted on
the CPU as ``aten._local_scalar_dense``): L-BFGS makes one per iteration
plus one per line-search test, and one more when it stops early; CG one
per iteration and one more when it stops early.

Then the behavioural checks of ``tests/test_bilevel.py`` and
``tests/test_hypergrad.py`` on the port, the latter against the JAX
package's dense-algebra hypergradient (Theorem 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import bilevel as jb
from repro.core import solvers as js
from repro.implicit import estimate_hypergrad_cotangent as j_estimate
from repro.implicit.estimators import _cg as j_cg
from repro_torch.core import bilevel as tb
from repro_torch.core import solvers as ts
from repro_torch.core.deq import DEQConfig, deq_fixed_point
from repro_torch.core.hypergrad import BackwardConfig as LegacyBackward
from repro_torch.core.hypergrad import estimate_cotangent as legacy_estimate
from repro_torch.core.hypergrad import fallback_cotangent
from repro_torch.core.lowrank import LowRank
from repro_torch.implicit import estimate_hypergrad_cotangent
from repro_torch.implicit.estimators import _cg

TOL = dict(rtol=1e-4, atol=1e-6)
TOL_HOAG = dict(rtol=1e-3, atol=1e-7)
MODES = ["full_cg", "shine", "shine_opa", "jfb", "shine_refine"]
PROBLEM = dict(n_train=400, n_val=120, n_test=120, dim=80, seed=0)


@pytest.fixture(scope="module")
def problems():
    return (jb.make_logreg_problem(**PROBLEM),
            tb.make_logreg_problem(**PROBLEM, device="cpu"))


class _Reads(TorchDispatchMode):
    """Counts host reads (``aten._local_scalar_dense``) inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += str(func) == "aten._local_scalar_dense.default"
        return func(*args, **(kwargs or {}))


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _mem_to_torch(mem) -> ts.LBFGSMemory:
    return ts.LBFGSMemory(*[_t(a) for a in mem])


def _jax_lbfgs(jp, theta, cfg, z0, mem0=None, opa=False):
    def run(t, z, m):
        return js.lbfgs_solve(
            lambda zz: jp.inner_grad(zz, t), z, cfg,
            value_fn=lambda zz: jp.inner_value(zz, t),
            dg_dtheta=(lambda zz: jp.dg_dtheta(zz, t)) if opa else None,
            mem0=m)
    return jax.jit(run)(jnp.float32(theta), jnp.asarray(z0), mem0)


def _port_lbfgs(tp, theta, cfg, z0, mem0=None, opa=False, value_calls=None):
    t = torch.tensor(theta, dtype=torch.float32)

    def value(zz):
        if value_calls is not None:
            value_calls.append(1)
        return tp.inner_value(zz, t)

    return ts.lbfgs_solve(
        lambda zz: tp.inner_grad(zz, t), torch.tensor(z0), cfg,
        value_fn=value,
        dg_dtheta=(lambda zz: tp.dg_dtheta(zz, t)) if opa else None,
        mem0=mem0)


def _assert_memory_close(tm, jm):
    for a, b in zip(tm[:3], jm[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))
    assert int(tm.count) == int(jm.count)


def test_problem_data_match_jax(problems):
    jp, tp = problems
    rng = np.random.default_rng(1)
    z = rng.normal(size=80).astype(np.float32) * 0.3
    for th in (0.05, 1.0):
        np.testing.assert_allclose(
            float(tp.inner_value(_t(z), torch.tensor(th))),
            float(jp.inner_value(jnp.asarray(z), th)), rtol=1e-6)
        np.testing.assert_allclose(
            tp.inner_grad(_t(z), torch.tensor(th)).numpy(),
            np.asarray(jp.inner_grad(jnp.asarray(z), jnp.float32(th))),
            rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tp.outer_loss(_t(z))),
                               float(jp.outer_loss(jnp.asarray(z))),
                               rtol=1e-6)
    jn = jb.make_nlls_problem(n_train=60, n_val=20, n_test=20, dim=10)
    tn = tb.make_nlls_problem(n_train=60, n_val=20, n_test=20, dim=10,
                              device="cpu")
    np.testing.assert_allclose(
        float(tn.inner_value(_t(z[:10]), torch.tensor(0.1))),
        float(jn.inner_value(jnp.asarray(z[:10]), 0.1)), rtol=1e-6)


@pytest.mark.parametrize("opa", [False, True])
def test_lbfgs_solve_matches_jax_cold_and_warm(problems, opa):
    """theta 1e-3, memory 8: 10-12 iterations (OPA pushes at iterations 4
    and 9 and the ring wraps), then a warm solve at 0.7 x theta from the
    first solve's iterate and memory."""
    jp, tp = problems
    kw = dict(max_steps=200, tol=3e-4, memory=8, opa_freq=5 if opa else 0)
    jcfg, tcfg = js.SolverConfig(**kw), ts.SolverConfig(**kw)
    z0 = np.zeros(80, np.float32)
    jr = _jax_lbfgs(jp, 1e-3, jcfg, z0, opa=opa)
    tr = _port_lbfgs(tp, 1e-3, tcfg, z0, opa=opa)
    assert tr.n_steps == int(jr.n_steps) >= 10
    assert int(tr.status) == int(jr.status) == ts.STATUS_CONVERGED
    np.testing.assert_allclose(tr.z.numpy(), np.asarray(jr.z), **TOL)
    _assert_memory_close(tr.memory, jr.memory)
    assert int(tr.memory.count) > 8  # the ring wrapped

    jw = _jax_lbfgs(jp, 7e-4, jcfg, np.asarray(jr.z), mem0=jr.memory,
                    opa=opa)
    tw = _port_lbfgs(tp, 7e-4, tcfg, np.asarray(jr.z),
                     mem0=_mem_to_torch(jr.memory), opa=opa)
    assert tw.n_steps == int(jw.n_steps) > 0
    np.testing.assert_allclose(tw.z.numpy(), np.asarray(jw.z), **TOL)
    _assert_memory_close(tw.memory, jw.memory)
    np.testing.assert_allclose(tw.trace.numpy(), np.asarray(jw.trace),
                               rtol=1e-3, atol=1e-7)


def test_lbfgs_reads_per_iteration(problems):
    """One stop test per iteration, one per line-search test, and one
    more for the test that ends an early stop; no other host read."""
    _, tp = problems
    cfg = ts.SolverConfig(max_steps=200, tol=3e-4, memory=10)
    calls = []
    with _Reads() as reads:
        res = _port_lbfgs(tp, 1e-3, cfg, np.zeros(80, np.float32),
                          value_calls=calls)
    # value_fn runs once per iteration for f(z), then once per line-search
    # test
    ls_tests = len(calls) - res.n_steps
    assert ls_tests >= res.n_steps
    assert reads.n == res.n_steps + ls_tests + 1


def test_lbfgs_rejects_a_mismatched_memory():
    mem = ts.empty_lbfgs_memory(5, 7)
    with pytest.raises(ValueError, match="mem0 holds"):
        ts.lbfgs_solve(lambda z: z, torch.zeros(8),
                       ts.SolverConfig(memory=5), mem0=mem)


def test_two_loop_multi_matches_jax_and_single():
    rng = np.random.default_rng(2)
    m, d = 6, 9
    s = rng.normal(size=(m, d)).astype(np.float32)
    y = (s + 0.1 * rng.normal(size=(m, d))).astype(np.float32)
    rho = (1.0 / np.sum(s * y, axis=1)).astype(np.float32)
    vs = rng.normal(size=(3, d)).astype(np.float32)
    for count in (0, 4, 9):
        jm = js.LBFGSMemory(jnp.asarray(s), jnp.asarray(y), jnp.asarray(rho),
                            jnp.int32(count))
        tm = _mem_to_torch(jm)
        gam = ts._lbfgs_gamma(tm)
        np.testing.assert_allclose(float(gam), float(js._lbfgs_gamma(jm)),
                                   rtol=1e-6)
        got = ts.lbfgs_two_loop_multi(tm, [_t(v) for v in vs], gam)
        want = js.lbfgs_two_loop_multi(jm, [jnp.asarray(v) for v in vs],
                                       js._lbfgs_gamma(jm))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        torch.testing.assert_close(ts.lbfgs_two_loop(tm, _t(vs[1]), gam),
                                   got[1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def solved(problems):
    """The JAX package's inner solve at theta 0.05 (tol 1e-6), shared by
    the CG and estimator parity tests."""
    jp, _ = problems
    cfg = js.SolverConfig(max_steps=400, tol=1e-6, memory=30)
    return _jax_lbfgs(jp, 0.05, cfg, np.zeros(80, np.float32))


def test_cg_matches_jax(problems, solved):
    jp, tp = problems
    rng = np.random.default_rng(4)
    b = rng.normal(size=80).astype(np.float32)
    z = solved.z
    th = jnp.float32(0.05)
    for steps, tol in ((100, 1e-8), (7, 1e-8), (100, 1e-3)):
        jx, jk = jax.jit(lambda bb, x0: j_cg(
            lambda v: jp.hvp(z, th, v), bb, x0, steps, tol))(
            jnp.asarray(b), jnp.zeros(80))
        with _Reads() as reads:
            tx, tk = _cg(lambda v: tp.hvp(_t(z), torch.tensor(0.05), v),
                         _t(b), torch.zeros(80), steps, tol)
        assert tk == int(jk)
        assert reads.n == tk + (tk < steps)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jx).max()))


@pytest.mark.parametrize("mode", MODES + ["shine_fallback"])
def test_hypergrad_cotangent_matches_jax(problems, solved, mode):
    jp, tp = problems
    th = jnp.float32(0.05)
    z, mem = solved.z, solved.memory
    w = jax.grad(jp.outer_loss)(z)
    jcfg = jb.HOAGConfig(mode=mode).implicit_cfg()
    tcfg = tb.HOAGConfig(mode=mode).implicit_cfg()
    ja = j_estimate(jcfg, lambda v: jp.hvp(z, th, v), w, mem)
    ta = estimate_hypergrad_cotangent(
        tcfg, lambda v: tp.hvp(_t(z), torch.tensor(0.05), v), _t(w),
        _mem_to_torch(mem))
    assert int(ta.n_steps) == int(ja.n_steps)
    np.testing.assert_allclose(ta.u.numpy(), np.asarray(ja.u), rtol=1e-3,
                               atol=1e-3 * float(np.abs(ja.u).max()))
    assert bool(ta.fallback_mask) == bool(ja.fallback_mask)


@pytest.mark.parametrize("mode", MODES)
def test_run_hoag_matches_jax(problems, mode):
    jp, tp = problems
    kw = dict(mode=mode, outer_steps=3, outer_lr=0.5)
    inner = dict(max_steps=150, tol=3e-4, memory=30)
    jh = jb.run_hoag(jp, 0.05, jb.HOAGConfig(
        inner=js.SolverConfig(**inner), **kw))
    th = tb.run_hoag(tp, 0.05, tb.HOAGConfig(
        inner=ts.SolverConfig(**inner), **kw))
    assert [r.step for r in th] == [0, 1, 2]
    np.testing.assert_allclose([r.theta for r in th],
                               [r.theta for r in jh], **TOL_HOAG)
    np.testing.assert_allclose([r.val_loss for r in th],
                               [r.val_loss for r in jh], **TOL_HOAG)
    assert [r.inner_steps for r in th] == [r.inner_steps for r in jh]
    assert [r.backward_hvp_calls for r in th] == \
        [r.backward_hvp_calls for r in jh]


def test_line_search_floor_is_a_recorded_difference(problems):
    """Theta 1.0, inner tol 1e-4 x 0.78: the warm solve starts at a
    gradient norm of ~1.8e-4, where Armijo's tested decrease is below the
    f32 spacing of the objective.  Both packages end finite with the same
    outer hyperparameter path to 1e-4; their inner step counts part there
    (the reference backtracks to null steps and spends its budget of 150,
    the port's values pass the test at once)."""
    jp, tp = problems
    kw = dict(mode="shine", outer_steps=3, outer_lr=0.5)
    inner = dict(max_steps=150, tol=1e-4, memory=30)
    jh = jb.run_hoag(jp, 1.0, jb.HOAGConfig(
        inner=js.SolverConfig(**inner), **kw))
    th = tb.run_hoag(tp, 1.0, tb.HOAGConfig(
        inner=ts.SolverConfig(**inner), **kw))
    np.testing.assert_allclose([r.theta for r in th],
                               [r.theta for r in jh], rtol=1e-4)
    assert all(np.isfinite(r.val_loss) for r in th)
    assert th[0].inner_steps == jh[0].inner_steps


# ---------------------------------------------------------------------------
# behavioural checks of tests/test_bilevel.py, on the port
# ---------------------------------------------------------------------------


def _solve_inner(tp, theta, tol=1e-8, opa=False):
    cfg = ts.SolverConfig(max_steps=400, tol=tol, memory=60,
                          opa_freq=(5 if opa else 0))
    return ts.lbfgs_solve(
        lambda z: tp.inner_grad(z, theta), torch.zeros(tp.dim), cfg,
        value_fn=lambda z: tp.inner_value(z, theta),
        dg_dtheta=((lambda z: tp.dg_dtheta(z, theta)) if opa else None))


def test_shine_hypergrad_matches_cg(problems):
    _, tp = problems
    theta = torch.tensor(0.05)
    res = _solve_inner(tp, theta)
    grads = {m: float(tb.hypergradient(tp, theta, res.z, res.memory,
                                       tb.HOAGConfig(mode=m))[0])
             for m in ("full_cg", "shine", "jfb")}
    g_true = grads["full_cg"]
    assert np.sign(grads["shine"]) == np.sign(g_true)
    rel_shine = abs(grads["shine"] - g_true) / (abs(g_true) + 1e-12)
    rel_jfb = abs(grads["jfb"] - g_true) / (abs(g_true) + 1e-12)
    assert rel_shine < 0.5
    assert rel_shine <= rel_jfb + 1e-6


def test_opa_improves_inversion_in_prescribed_direction(problems):
    _, tp = problems
    theta = torch.tensor(0.05)
    res0 = _solve_inner(tp, theta, tol=1e-4)
    res1 = _solve_inner(tp, theta, tol=1e-4, opa=True)
    v = tp.dg_dtheta(res1.z, theta)
    hess = torch.func.hessian(lambda z: tp.inner_value(z, theta))(res1.z)
    want = torch.linalg.solve(hess, v)

    def err(mem):
        got = ts.lbfgs_two_loop(mem, v, ts._lbfgs_gamma(mem))
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want))

    assert err(res1.memory) < err(res0.memory) + 0.05


@pytest.mark.parametrize("mode", MODES)
def test_hoag_all_modes_reduce_val_loss(problems, mode):
    _, tp = problems
    cfg = tb.HOAGConfig(mode=mode, outer_steps=6, outer_lr=0.5,
                        inner=ts.SolverConfig(max_steps=150, tol=1e-4,
                                              memory=30))
    hist = tb.run_hoag(tp, theta0=1.0, cfg=cfg)
    assert hist[-1].val_loss < hist[0].val_loss + 1e-6
    assert np.isfinite(hist[-1].test_loss)


def test_shine_uses_no_backward_hvps(problems):
    _, tp = problems
    inner = ts.SolverConfig(max_steps=100, tol=1e-4, memory=30)
    hist = tb.run_hoag(tp, 0.5, tb.HOAGConfig(mode="shine", outer_steps=2,
                                              inner=inner))
    assert all(r.backward_hvp_calls == 0 for r in hist)
    hist_cg = tb.run_hoag(tp, 0.5, tb.HOAGConfig(mode="full_cg",
                                                 outer_steps=2, inner=inner))
    assert any(r.backward_hvp_calls > 0 for r in hist_cg)


def test_nlls_problem_trains():
    p = tb.make_nlls_problem(n_train=300, n_val=100, n_test=100, dim=50,
                             device="cpu")
    cfg = tb.HOAGConfig(mode="shine", outer_steps=5, outer_lr=0.5,
                        inner=ts.SolverConfig(max_steps=150, tol=1e-5,
                                              memory=30))
    hist = tb.run_hoag(p, theta0=0.5, cfg=cfg)
    assert hist[-1].val_loss <= hist[0].val_loss + 1e-6


def test_hoag_modes_and_implicit_cfg_match_jax():
    for mode in MODES + ["shine_fallback", "jfb_refine"]:
        assert tb.resolve_hoag_mode(mode) == jb.resolve_hoag_mode(mode)
        got = dataclasses.asdict(tb.HOAGConfig(mode=mode).implicit_cfg())
        want = dataclasses.asdict(jb.HOAGConfig(mode=mode).implicit_cfg())
        assert got == want, mode
    with pytest.raises(ValueError, match="unknown HOAG mode"):
        tb.resolve_hoag_mode("bogus")


def test_run_hoag_records_spans_and_metrics(problems):
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    _, tp = problems
    reg = obs_metrics.default_registry()
    lbl = {"mode": "shine"}
    n0 = reg.counter("hoag_outer_total", lbl).value
    obs_tracing.clear()
    obs_tracing.set_enabled(True)
    try:
        hist = tb.run_hoag(tp, 0.05, tb.HOAGConfig(
            mode="shine", outer_steps=2,
            inner=ts.SolverConfig(max_steps=50, tol=3e-4, memory=10)))
        names = [e["name"] for e in obs_tracing.default_recorder().events()
                 if e["ph"] == "B"]
    finally:
        obs_tracing.set_enabled(False)
        obs_tracing.clear()
    for span in ("hoag_outer", "inner_solve", "hypergradient"):
        assert names.count(span) == 2, (span, names)
    assert reg.counter("hoag_outer_total", lbl).value == n0 + 2
    assert reg.gauge("hoag_val_loss", lbl).value == hist[-1].val_loss


# ---------------------------------------------------------------------------
# behavioural checks of tests/test_hypergrad.py, on the port, against the
# JAX package's dense-algebra hypergradient
# ---------------------------------------------------------------------------


B, D = 3, 16
_KEY = jax.random.PRNGKey(0)
_W0 = 0.4 * jax.random.normal(jax.random.fold_in(_KEY, 1), (D, D)) / np.sqrt(D)
_X = jax.random.normal(jax.random.fold_in(_KEY, 2), (B, D))
_TGT = jax.random.normal(jax.random.fold_in(_KEY, 3), (B, D))


def _fj(params, x, z):
    return jnp.tanh(z @ params.T + x)


def _ft(params, x, z):
    return torch.tanh(z @ params.T + x)


@pytest.fixture(scope="module")
def truth():
    """Theorem 1 with dense linear algebra, per sample (the reference's
    ``analytic_hypergrad``), with ``dL/dx`` too."""
    z = jnp.zeros((B, D))
    for _ in range(800):
        z = _fj(_W0, _X, z)
    w = 2.0 * (z - _TGT)
    g_w, g_x = jnp.zeros_like(_W0), []
    for i in range(B):
        jf = jax.jacrev(lambda zz: _fj(_W0, _X[i], zz))(z[i])
        u = jnp.linalg.solve((jnp.eye(D) - jf).T, w[i])
        _, vjp = jax.vjp(lambda p, xx: _fj(p, xx, z[i]), _W0, _X[i])
        gw, gx = vjp(u)
        g_w = g_w + gw
        g_x.append(gx)
    return np.asarray(g_w), np.stack([np.asarray(g) for g in g_x])


def _port_grads(mode, solver="broyden", **kw):
    cfg = DEQConfig(solver=solver, max_steps=80, tol=1e-10, memory=80,
                    backward=mode, backward_max_steps=80, backward_tol=1e-10,
                    **kw)
    W = _t(_W0).requires_grad_(True)
    x = _t(_X).requires_grad_(True)
    z, _ = deq_fixed_point(_ft, W, x, torch.zeros(B, D), cfg)
    ((z - _t(_TGT)) ** 2).sum().backward()
    return W.grad.numpy(), x.grad.numpy()


def _cos(a, b):
    return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                  + 1e-30))


def test_full_backward_matches_analytic(truth):
    g, gx = _port_grads("full")
    np.testing.assert_allclose(g, truth[0], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gx, truth[1], rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("mode,min_cos", [("shine", 0.95),
                                          ("shine_fallback", 0.95),
                                          ("jfb", 0.90)])
def test_approximate_modes_are_descent_aligned(truth, mode, min_cos):
    assert _cos(_port_grads(mode)[0], truth[0]) > min_cos, mode


def test_shine_beats_jfb_here(truth):
    assert _cos(_port_grads("shine")[0], truth[0]) >= \
        _cos(_port_grads("jfb")[0], truth[0])


@pytest.mark.parametrize("mode", ["shine_refine", "jfb_refine"])
def test_refine_recovers_exactness(truth, mode):
    g, _ = _port_grads(mode, refine_steps=60)
    np.testing.assert_allclose(g, truth[0], rtol=5e-3, atol=5e-4)


def test_refine_improves_with_budget(truth):
    errs = [np.linalg.norm(_port_grads("shine")[0] - truth[0])]
    for k in (3, 30):
        errs.append(np.linalg.norm(
            _port_grads("shine_refine", refine_steps=k)[0] - truth[0]))
    assert errs[2] < errs[0]
    assert errs[2] < errs[1] * 1.5


def test_adjoint_broyden_forward_with_shine(truth):
    g, _ = _port_grads("shine", solver="adjoint_broyden")
    assert _cos(g, truth[0]) > 0.9


def test_fallback_guard_fires_on_blown_up_inverse():
    bsz, d = 2, 4
    H = LowRank.identity(bsz, d, 2, dtype=torch.float32)
    a = torch.stack([torch.zeros(d), 100.0 * torch.ones(d)])
    H = H.append(a, torch.ones(bsz, d), torch.tensor([False, True]))
    w = torch.ones(bsz, d)
    u, bad = fallback_cotangent(H, w, ratio=1.3)
    assert bad.tolist() == [False, True]
    torch.testing.assert_close(u, w)


def test_legacy_backward_config_estimates_like_the_registry():
    H = LowRank.identity(B, D, 4, dtype=torch.float32)
    w = torch.randn(B, D, generator=torch.Generator().manual_seed(0))
    for mode in ("shine", "jfb"):
        adj = legacy_estimate(LegacyBackward(mode=mode), lambda u: 0.5 * u,
                              w, H)
        torch.testing.assert_close(adj.u, w, rtol=0, atol=0)


def test_deq_memory_is_o1():
    """The backward keeps (params, x, z*, the qN chain): no per-iteration
    stack of the 80-step forward, and a chain of ``memory`` slots."""
    cfg = DEQConfig(max_steps=80, tol=1e-8, memory=8, backward="shine")
    shapes = []
    W = _t(_W0).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        z, stats = deq_fixed_point(_ft, W, _t(_X), torch.zeros(B, D), cfg)
    assert stats.n_steps > 8
    assert all(s[:1] not in ((80,), (stats.n_steps,)) for s in shapes), shapes
    z.sum().backward()
    assert torch.isfinite(W.grad).all()


# ---------------------------------------------------------------------------
# chip_smoke.py's host-wait accounting of a HOAG run, against the reads the
# port makes on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full_cg", "shine", "jfb_refine"])
def test_chip_smoke_hoag_sync_count_is_the_reads(problems, mode):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    _, tp = problems
    hcfg = tb.HOAGConfig(mode=mode, outer_steps=3, outer_lr=20.0,
                         inner=ts.SolverConfig(max_steps=5, tol=1e-6,
                                               memory=10))
    ls = []
    with _Reads() as reads, chip_smoke._count_line_search(ls):
        hist = tb.run_hoag(tp, 0.05, hcfg)
    assert ls and any(r.inner_steps == 5 for r in hist)
    assert reads.n == chip_smoke.hoag_expected_syncs(hist, len(ls), hcfg)
    assert reads.n != chip_smoke.hoag_expected_syncs(hist, len(ls) + 1,
                                                     hcfg)
