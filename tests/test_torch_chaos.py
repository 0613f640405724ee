"""The port's chaos suite: every numerical-fault class of
``tests/test_chaos.py`` injected deterministically
(``repro_torch.runtime.faultinject``) and held against the JAX package's
outcome for the same plan, on the CPU.

Five fault classes:
  1. non-finite iterate  -- ``FaultPlan("nonfinite")`` inside each solver
  2. diverging solve     -- ``FaultPlan("diverge")``, a finite blow-up
  3. corrupted qN ring   -- ``corrupt_carry_ring`` on a warm ``SolveCarry``
  4. poisoned prefix     -- ``poison_prefix_entry`` (sync loop) and
                            ``poison_prefix_store_slot`` (async pipeline)
  5. SIGTERM preemption  -- ``python -m repro_torch.launch.train --device
                            cpu`` killed mid-loop

Checked against JAX: the statuses, the step count and the iteration at
which each status fires (the tapes' status rows, exactly); the iterates at
the ring's recorded tolerance (bf16 ring: rtol 2e-2; f32 work: rtol 1e-4);
the served tokens.  Checked on the port alone, as the reference checks
itself: co-batched healthy rows bit for bit against the unfaulted run, best
iterates finite, guard on with no fault bit for bit guard off (iterates,
residuals and gradients), the metrics names, and that an unarmed hook adds
no operation and no host read.
"""

import dataclasses
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import solvers as jsol
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx
from repro.runtime import faultinject as jfi
from repro.runtime.serving import Request as JRequest
from repro.runtime.serving import ServeLoop as JServeLoop
from repro_torch.configs.registry import smoke_config
from repro_torch.core import solvers as tsol
from repro_torch.core.solvers import (
    STATUS_CONVERGED,
    STATUS_DIVERGED,
    STATUS_NONFINITE,
    STATUS_STALLED,
    SolverConfig,
)
from repro_torch.implicit import (
    BackwardConfig,
    ForwardConfig,
    ImplicitConfig,
    implicit_fixed_point,
)
from repro_torch.models import lm as tlm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import faultinject
from repro_torch.runtime.faultinject import FaultPlan
from repro_torch.runtime.serving import Request, ServeLoop

D = 24
BSZ = 3
CFG = SolverConfig(max_steps=40, tol=1e-5, memory=40)
JCFG = jsol.SolverConfig(max_steps=40, tol=1e-5, memory=40)
TOL_BF16_RING = dict(rtol=2e-2, atol=1e-4)
TOL_F32 = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _linear(seed: int = 0):
    """Contractive batched root problem g(z) = A z - b, in numpy."""
    rng = np.random.default_rng(seed)
    A = (np.eye(D) + 0.1 * rng.normal(size=(D, D))).astype(np.float32)
    b = rng.normal(size=(BSZ, D)).astype(np.float32)
    return A, b


def _g_pair(seed: int = 0):
    A, b = _linear(seed)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.tensor(A), torch.tensor(b)
    return (lambda z: z @ Aj.T - bj), (lambda z: z @ At.T - bt)


def _f_pair(seed: int = 0):
    gj, gt = _g_pair(seed)
    return (lambda z: z - 0.5 * gj(z)), (lambda z: z - 0.5 * gt(z))


def _z0():
    return jnp.zeros((BSZ, D), jnp.float32), torch.zeros(BSZ, D)


def _jax_solve(solve, fn, cfg, plan=None, **kw):
    """The JAX solve jitted under ``plan`` (the hook is a trace-time gate:
    a new jit per plan)."""
    z0 = jnp.zeros((BSZ, D), jnp.float32)
    if plan is None:
        return jax.jit(lambda z: solve(fn, z, cfg, **kw))(z0)
    with jfi.inject(jfi.FaultPlan(**dataclasses.asdict(plan))):
        return jax.jit(lambda z: solve(fn, z, cfg, **kw))(z0)


def _port_solve(solve, fn, cfg, plan=None, **kw):
    z0 = torch.zeros(BSZ, D)
    if plan is None:
        return solve(fn, z0, cfg, **kw)
    with faultinject.inject(plan):
        return solve(fn, z0, cfg, **kw)


def _same_outcome(jres, tres, tol):
    """Statuses, step count and the iteration each status fires at (the
    tapes' status rows) exactly; the iterate at ``tol``."""
    np.testing.assert_array_equal(np.asarray(jres.status),
                                  tres.status.numpy())
    assert int(jres.n_steps) == tres.n_steps
    np.testing.assert_array_equal(np.asarray(jres.tape.status),
                                  tres.tape.status.numpy())
    np.testing.assert_allclose(tres.z.numpy(), np.asarray(jres.z), **tol)


def _counter(name, **labels):
    total = 0.0
    for m in obs_metrics.default_registry().snapshot()["metrics"]:
        if m["name"] == name and all(
                m.get("labels", {}).get(k) == v for k, v in labels.items()):
            total += m["value"]
    return total


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched inside the block; a host read is an
    ``aten._local_scalar_dense`` (``bool()``, ``int()``, ``float()``,
    ``.item()``)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))

    @property
    def reads(self) -> int:
        return self.ops.count("aten._local_scalar_dense.default")


# ---------------------------------------------------------------------------
# classes 1 and 2: in-solver iterate faults (non-finite / diverging)
# ---------------------------------------------------------------------------


def test_fault_plan_validates_kind_and_keeps_the_defaults():
    with pytest.raises(ValueError, match="kind must be one of"):
        FaultPlan("bogus")
    assert [(f.name, f.default) for f in dataclasses.fields(FaultPlan)] == \
        [(f.name, f.default) for f in dataclasses.fields(jfi.FaultPlan)]
    assert faultinject._KINDS == jfi._KINDS
    assert faultinject.current_plan() is None
    with faultinject.inject(FaultPlan("stall")) as plan:
        assert faultinject.current_plan() is plan
        assert tsol._FAULT_HOOK is faultinject._perturb
    assert faultinject.current_plan() is None and tsol._FAULT_HOOK is None


@pytest.mark.parametrize("kind,code", [("nonfinite", STATUS_NONFINITE),
                                       ("diverge", STATUS_DIVERGED)])
def test_transient_fault_recovers_with_sticky_status(kind, code):
    gj, gt = _g_pair()
    plan = FaultPlan(kind, sample=1, step=2, duration=1)
    ref = _port_solve(tsol.broyden_solve, gt, CFG)
    res = _port_solve(tsol.broyden_solve, gt, CFG, plan)
    jres = _jax_solve(jsol.broyden_solve, gj, JCFG, plan)
    _same_outcome(jres, res, TOL_BF16_RING)
    st = res.status.numpy()
    # the restart recovers the row to the root; the status stays sticky
    assert st[1] == code
    assert torch.isfinite(res.z).all()
    assert float(res.residual[1]) < 1e-3
    for i in (0, 2):
        assert st[i] == STATUS_CONVERGED
        torch.testing.assert_close(res.z[i], ref.z[i], rtol=0, atol=0)


@pytest.mark.parametrize("kind,code", [("nonfinite", STATUS_NONFINITE),
                                       ("diverge", STATUS_DIVERGED)])
def test_persistent_fault_freezes_with_finite_best_iterate(kind, code):
    gj, gt = _g_pair()
    plan = FaultPlan(kind, sample=0, step=2)
    res = _port_solve(tsol.broyden_solve, gt, CFG, plan)
    jres = _jax_solve(jsol.broyden_solve, gj, JCFG, plan)
    _same_outcome(jres, res, TOL_BF16_RING)
    st = res.status.numpy()
    assert st[0] == code
    assert torch.isfinite(res.z).all()
    assert st[1] == STATUS_CONVERGED and st[2] == STATUS_CONVERGED


@pytest.mark.parametrize("solver", ["fixed_point", "anderson"])
def test_fixed_point_and_anderson_detect_nonfinite(solver):
    fj, ft = _f_pair()
    cfg = SolverConfig(max_steps=60, tol=1e-6, memory=5)
    jcfg = jsol.SolverConfig(max_steps=60, tol=1e-6, memory=5)
    # jitted, the reference folds Anderson's ridge away (the recorded
    # difference of tests/test_torch_solver_family.py): ridge 0 matches it
    kw = {"ridge": 0.0} if solver == "anderson" else {}
    plan = FaultPlan("nonfinite", sample=2, step=3, duration=1)
    solve = getattr(tsol, f"{solver}_solve")
    ref = _port_solve(solve, ft, cfg, **kw)
    res = _port_solve(solve, ft, cfg, plan, **kw)
    jres = _jax_solve(getattr(jsol, f"{solver}_solve"), fj, jcfg, plan)
    if solver == "anderson":
        # the weights of a nearly collinear window move last-bit differences
        # to ~1e-2 of a residual (test_torch_solver_family.py): a healthy
        # row may stop one iteration apart; the faulted row's statuses,
        # iteration by iteration, and the exit statuses agree exactly
        np.testing.assert_array_equal(np.asarray(jres.status),
                                      res.status.numpy())
        n = min(int(jres.n_steps), res.n_steps)
        np.testing.assert_array_equal(np.asarray(jres.tape.status)[:n, 2],
                                      res.tape.status.numpy()[:n, 2])
    else:
        _same_outcome(jres, res, TOL_F32)
    assert res.status.numpy()[2] == STATUS_NONFINITE
    assert torch.isfinite(res.z).all()
    if solver == "fixed_point":
        # Picard rows are independent: the healthy rows move as if alone
        for i in (0, 1):
            torch.testing.assert_close(res.z[i], ref.z[i], rtol=0, atol=0)


def test_adjoint_broyden_detects_nonfinite():
    gj, gt = _g_pair()
    cfg = dataclasses.replace(CFG, qn_dtype="float32")
    jcfg = dataclasses.replace(JCFG, qn_dtype="float32")
    plan = FaultPlan("nonfinite", sample=1, step=2, duration=1)
    ref = _port_solve(tsol.adjoint_broyden_solve, gt, cfg)
    res = _port_solve(tsol.adjoint_broyden_solve, gt, cfg, plan)
    jres = _jax_solve(jsol.adjoint_broyden_solve, gj, jcfg, plan)
    _same_outcome(jres, res, TOL_F32)
    assert res.status.numpy()[1] == STATUS_NONFINITE
    assert torch.isfinite(res.z).all()
    for i in (0, 2):
        torch.testing.assert_close(res.z[i], ref.z[i], rtol=0, atol=0)


def test_stall_detection_opt_in():
    gj, gt = _g_pair()
    plan = FaultPlan("stall", sample=1, step=2)
    res = _port_solve(tsol.broyden_solve, gt,
                      dataclasses.replace(CFG, stall_tol=0.0,
                                          stall_patience=3), plan)
    jres = _jax_solve(jsol.broyden_solve, gj,
                      dataclasses.replace(JCFG, stall_tol=0.0,
                                          stall_patience=3), plan)
    _same_outcome(jres, res, TOL_BF16_RING)
    assert res.status.numpy()[1] == STATUS_STALLED
    assert torch.isfinite(res.z).all()


def test_unarmed_hook_adds_no_operation_and_no_read():
    """Nothing armed, armed with a plan that never fires inside the
    budget, and disarmed again: the same aten ops in the same order, the
    same host reads.  On the card an op is a launch and a read a wait."""
    _, gt = _g_pair()
    logs = []
    for plan in (None, FaultPlan("nonfinite", step=10 ** 6), None):
        with _OpLog() as log:
            _port_solve(tsol.broyden_solve, gt, CFG, plan)
        logs.append(log)
    assert logs[0].ops == logs[1].ops == logs[2].ops
    assert logs[0].reads == logs[1].reads > 0
    # firing adds the mask and the fill to the one iteration, no read
    with _OpLog() as fired:
        _port_solve(tsol.broyden_solve, gt, CFG,
                    FaultPlan("diverge", step=2, duration=1))
    assert len(fired.ops) > len(logs[0].ops)


def test_solver_faults_hit_metrics():
    rng = np.random.default_rng(3)
    W = torch.tensor(np.eye(D) + 0.1 * rng.normal(size=(D, D)),
                     dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(BSZ, D)), dtype=torch.float32)
    cfg = ImplicitConfig(forward=ForwardConfig(max_steps=30, tol=1e-6),
                         backward=BackwardConfig(estimator="shine"),
                         memory=30)

    def f(params, xx, z):
        return z - 0.5 * (z @ params.T - xx)

    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)
    before = _counter("solve_failures_total")
    try:
        with faultinject.inject(FaultPlan("nonfinite", sample=0, step=2)):
            z, _ = implicit_fixed_point(f, W, x, torch.zeros_like(x), cfg)
        assert after_labels_have_phase("forward")
    finally:
        obs_metrics.set_enabled(was)
    assert _counter("solve_failures_total") > before


def after_labels_have_phase(phase: str) -> bool:
    snap = obs_metrics.default_registry().snapshot()["metrics"]
    return any(m["name"] == "solve_failures_total"
               and m["labels"].get("phase") == phase
               and m["labels"].get("status") == "nonfinite" for m in snap)


# ---------------------------------------------------------------------------
# class 3: corrupted quasi-Newton ring
# ---------------------------------------------------------------------------


def _clone_carry(c):
    lr = dataclasses.replace(c.lowrank, u=c.lowrank.u.clone(),
                             v=c.lowrank.v.clone(),
                             count=c.lowrank.count.clone())
    return dataclasses.replace(c, z=c.z.clone(), lowrank=lr,
                               warm=c.warm.clone(), age=c.age.clone())


def test_corrupt_carry_ring_matches_jax_and_leaves_the_input():
    carry = tsol.init_solve_carry(BSZ, D, 4)
    carry.lowrank.u.normal_()
    jcarry = jsol.init_solve_carry(BSZ, D, 4)
    jcarry = dataclasses.replace(jcarry, lowrank=dataclasses.replace(
        jcarry.lowrank, u=jnp.asarray(carry.lowrank.u.float().numpy(),
                                      jcarry.lowrank.u.dtype)))
    before = carry.lowrank.u.clone()
    bad = faultinject.corrupt_carry_ring(carry, rows=[1])
    jbad = jfi.corrupt_carry_ring(jcarry, rows=[1])
    np.testing.assert_array_equal(bad.lowrank.u.float().numpy(),
                                  np.asarray(jbad.lowrank.u, np.float32))
    np.testing.assert_array_equal(bad.lowrank.count.numpy(),
                                  np.asarray(jbad.lowrank.count))
    np.testing.assert_array_equal(bad.warm.numpy(), np.asarray(jbad.warm))
    torch.testing.assert_close(carry.lowrank.u, before, rtol=0, atol=0)


def test_corrupted_carry_ring_detected_and_recovered():
    gj, gt = _g_pair()
    shift = np.random.default_rng(9).normal(size=(BSZ, D)) * 0.5
    sj, st_ = jnp.asarray(shift, jnp.float32), torch.tensor(
        shift, dtype=torch.float32)

    def g2j(z):
        return gj(z) - sj

    def g2t(z):
        return gt(z) - st_

    z0j, z0t = _z0()
    warm = tsol.broyden_solve(gt, z0t, CFG, carry=tsol.init_solve_carry(
        BSZ, D, CFG.memory)).carry
    jwarm = jax.jit(lambda z: jsol.broyden_solve(
        gj, z, JCFG, carry=jsol.init_solve_carry(BSZ, D, JCFG.memory)))(
        z0j).carry
    ref = tsol.broyden_solve(g2t, z0t, CFG, carry=_clone_carry(warm))
    assert ref.n_steps > 0
    bad = faultinject.corrupt_carry_ring(warm, rows=[1])
    res = tsol.broyden_solve(g2t, z0t, CFG, carry=bad)
    jres = jax.jit(lambda z, c: jsol.broyden_solve(g2j, z, JCFG, carry=c))(
        z0j, jfi.corrupt_carry_ring(jwarm, rows=[1]))
    _same_outcome(jres, res, TOL_BF16_RING)
    st = res.status.numpy()
    assert torch.isfinite(res.z).all()
    assert float(res.residual[1]) < 1e-3
    assert st[1] >= STATUS_DIVERGED
    for i in (0, 2):
        torch.testing.assert_close(res.z[i], ref.z[i], rtol=0, atol=0)
    # the carry handed back is clean: a follow-up solve stays healthy
    nxt = tsol.broyden_solve(g2t, z0t, CFG, carry=res.carry)
    assert torch.isfinite(nxt.z).all()
    assert float(nxt.residual.max()) < 1e-3


def test_poisoned_warm_iterate_contained_at_entry():
    gj, gt = _g_pair()
    z0j, z0t = _z0()
    warm = tsol.broyden_solve(gt, z0t, CFG, carry=tsol.init_solve_carry(
        BSZ, D, CFG.memory)).carry
    jwarm = jax.jit(lambda z: jsol.broyden_solve(
        gj, z, JCFG, carry=jsol.init_solve_carry(BSZ, D, JCFG.memory)))(
        z0j).carry
    z = warm.z.clone()
    z[1] = float("nan")
    res = tsol.broyden_solve(gt, z0t, CFG,
                             carry=dataclasses.replace(warm, z=z))
    jz = np.array(jwarm.z)
    jz[1] = np.nan
    jres = jax.jit(lambda z_, c: jsol.broyden_solve(gj, z_, JCFG, carry=c))(
        z0j, dataclasses.replace(jwarm, z=jnp.asarray(jz)))
    _same_outcome(jres, res, TOL_BF16_RING)
    assert res.status.numpy()[1] == STATUS_NONFINITE
    assert torch.isfinite(res.z).all()
    assert float(res.residual[1]) < 1e-3


# ---------------------------------------------------------------------------
# guard on / guard off bit identity on the healthy path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["broyden", "fixed_point", "anderson",
                                    "adjoint_broyden"])
def test_guard_bit_identical_without_faults(solver):
    _, gt = _g_pair()
    _, ft = _f_pair()
    fn = gt if solver in ("broyden", "adjoint_broyden") else ft
    solve = getattr(tsol, f"{solver}_solve")
    on = _port_solve(solve, fn, CFG)
    off = _port_solve(solve, fn, dataclasses.replace(CFG, guard=False))
    torch.testing.assert_close(on.z, off.z, rtol=0, atol=0)
    torch.testing.assert_close(on.residual, off.residual, rtol=0, atol=0)
    assert on.n_steps == off.n_steps


def test_guard_bit_identical_gradients():
    rng = np.random.default_rng(5)
    W0 = torch.tensor(np.eye(D) + 0.1 * rng.normal(size=(D, D)),
                      dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(BSZ, D)), dtype=torch.float32)

    def f(params, xx, z):
        return z - 0.5 * (z @ params.T - xx)

    grads = {}
    for guard in (True, False):
        cfg = ImplicitConfig(
            forward=ForwardConfig(max_steps=25, tol=1e-6, guard=guard),
            backward=BackwardConfig(estimator="shine"), memory=25)
        W = W0.clone().requires_grad_(True)
        z, _ = implicit_fixed_point(f, W, x, torch.zeros_like(x), cfg)
        (z * z).sum().backward()
        grads[guard] = W.grad
    torch.testing.assert_close(grads[True], grads[False], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# class 4: poisoned prefix cache (serving isolation)
# ---------------------------------------------------------------------------


def _small(cfg):
    return dataclasses.replace(
        cfg, num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=60, tol=1e-5, memory=16))


@pytest.fixture(scope="module")
def serve_setup():
    jcfg = _small(jax_smoke_config("minicpm-2b", deq=True))
    tcfg = _small(smoke_config("minicpm-2b", deq=True))
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params["deq_blocks"] = jax.tree_util.tree_map(
        lambda a: a * 0.3, params["deq_blocks"])
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, tlm.params_from_jax(np_params, device="cpu")


def _prompts_sync():
    rng = np.random.default_rng(7)
    base = rng.integers(2, 128, size=8).tolist()
    pA = base + rng.integers(2, 128, size=4).tolist()
    pB = rng.integers(2, 128, size=12).tolist()
    return pA, pB


def test_poisoned_prefix_entry_sync_retry_and_isolation(serve_setup):
    jcfg, tcfg, jparams, tparams = serve_setup
    pA, pB = _prompts_sync()
    kw = dict(slots=2, max_len=64, eos_id=-1, prefix_cache=True,
              prefix_cache_slots=16)

    def run(loop_cls, req_cls, params, cfg, poison, *extra):
        ref = loop_cls(params, cfg, *extra, **kw)
        rB0 = req_cls(uid=0, prompt=list(pB), max_new_tokens=4)
        ref.drain([rB0])
        loop = loop_cls(params, cfg, *extra, **kw)
        loop.drain([req_cls(uid=1, prompt=list(pA), max_new_tokens=2)])
        assert len(loop.prefix) > 0
        for key in list(loop.prefix._entries):
            poison(loop.prefix, key)
        rA = req_cls(uid=2, prompt=list(pA), max_new_tokens=4)
        rB = req_cls(uid=3, prompt=list(pB), max_new_tokens=4)
        loop.drain([rA, rB])
        return rA, rB, rB0

    jA, jB, _ = run(JServeLoop, JRequest, jparams, jcfg,
                    jfi.poison_prefix_entry, ShardCtx.for_mesh(None))
    f0 = _counter("serve_request_faults_total")
    e0 = _counter("prefix_cache_evictions_total", reason="poisoned")
    rA, rB, rB0 = run(ServeLoop, Request, tparams, tcfg,
                      faultinject.poison_prefix_entry)
    assert rA.done and rB.done
    assert rA.retried and rA.error is None and len(rA.out) == 4
    assert rB.out == rB0.out
    assert (rA.out, rB.out, rA.retried) == (jA.out, jB.out, jA.retried)
    assert _counter("serve_request_faults_total") - f0 >= 1
    assert _counter("prefix_cache_evictions_total",
                    reason="poisoned") - e0 >= 1


def test_poisoned_prefix_store_async_retry(serve_setup):
    jcfg, tcfg, jparams, tparams = serve_setup
    rng = np.random.default_rng(11)
    pA = (rng.integers(2, 128, size=8).tolist()
          + rng.integers(2, 128, size=4).tolist())
    kw = dict(slots=2, max_len=64, eos_id=-1, pipeline="async",
              prefix_cache=True, prefix_cache_slots=8)

    def run(loop_cls, req_cls, params, cfg, poison, *extra):
        loop = loop_cls(params, cfg, *extra, **kw)
        loop.drain([req_cls(uid=1, prompt=list(pA), max_new_tokens=2)])
        assert len(loop.prefix_store) > 0
        for slot in {e.slot for e in loop.prefix_store._entries.values()}:
            poison(loop.prefix_store, slot)
        rA = req_cls(uid=2, prompt=list(pA), max_new_tokens=4)
        loop.drain([rA])
        return rA, loop

    jA, _ = run(JServeLoop, JRequest, jparams, jcfg,
                jfi.poison_prefix_store_slot, ShardCtx.for_mesh(None))
    f0 = _counter("serve_request_faults_total")
    rA, loop = run(ServeLoop, Request, tparams, tcfg,
                   faultinject.poison_prefix_store_slot)
    assert rA.done and rA.retried and rA.epoch == 1
    assert rA.error is None and len(rA.out) == 4
    assert (rA.out, rA.epoch) == (jA.out, jA.epoch)
    assert loop.prefix_store.evictions_by_reason["poisoned"] >= 1
    assert _counter("serve_request_faults_total") - f0 >= 1


# ---------------------------------------------------------------------------
# class 5: SIGTERM preemption (subprocess, smoke size)
# ---------------------------------------------------------------------------


def test_sigterm_preemption_writes_final_checkpoint(tmp_path):
    ckdir = tmp_path / "ck"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--deq", "--steps", "500", "--batch", "2", "--seq", "16",
         "--checkpoint-dir", str(ckdir), "--checkpoint-every", "5"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.time() + 240
    started = False
    while time.time() < deadline:
        if any(p.startswith("step_") for p in
               (os.listdir(ckdir) if ckdir.exists() else [])):
            started = True
            break
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    if not started:
        proc.kill()
        out = proc.communicate()[0]
        pytest.fail(f"training never reached a checkpoint:\n{out[-2000:]}")
    proc.send_signal(signal.SIGTERM)
    out = proc.communicate(timeout=240)[0]
    assert proc.returncode == 0, f"non-zero exit after SIGTERM:\n{out[-2000:]}"
    assert "preempted at step" in out
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(ckdir)
                   if p.startswith("step_") and not p.endswith(".tmp"))
    assert steps, "no checkpoint written"
    m = re.search(r"preempted at step (\d+)", out)
    assert int(m.group(1)) == steps[-1]


def test_chip_smoke_row_check_sees_one_changed_bit():
    """``chip_smoke.check_rows_equal`` (the card's healthy-row check)
    passes on equal rows and fails on one last-bit change in a healthy
    row's iterate or logits; the faulted row is not looked at."""
    import types
    sys.path.insert(0, REPO)
    import chip_smoke
    z = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))
    logits = torch.randn(4, 3, 7, generator=torch.Generator().manual_seed(1))

    def run(zz, ll):
        return types.SimpleNamespace(z=zz), (ll,)

    want = run(z, logits)
    bad_row = z.clone()
    bad_row[1] = float("nan")
    chip_smoke.check_rows_equal("ok", run(bad_row, logits), want, [0, 2, 3])
    for which in ("z", "logits"):
        zz, ll = z.clone(), logits.clone()
        t = zz if which == "z" else ll
        t[2, 1, 3] = torch.nextafter(t[2, 1, 3], torch.tensor(float("inf")))
        with pytest.raises(AssertionError, match="healthy row 2"):
            chip_smoke.check_rows_equal("bad", run(zz, ll), want, [0, 2, 3])
