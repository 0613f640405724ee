"""The port's Broyden solver against the JAX package's.

Identical numpy problems go through ``repro.core.solvers.broyden_solve`` and
``repro_torch.core.solvers.broyden_solve``: a tiny tanh DEQ with f32 and bf16
quasi-Newton rings, cold and warm-started from a carry, with a freeze mask,
and through the fault guard's entry repair.  The bar is the same step count,
status codes and convergence flags, and the residual trace within rtol 1e-4.
(The LM's own fixed-point map is held the same way in
``test_torch_serving.py``, through prefill and decode.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as jsol
from repro_torch.core import solvers as tsol

B, D = 4, 16


def _problem(seed=0, rate=0.6):
    rng = np.random.default_rng(seed)
    w = (rate * rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, x


def _g_jax(w, x):
    wj, xj = jnp.asarray(w), jnp.asarray(x)
    return lambda z: z - jnp.tanh(z @ wj + xj)


def _g_torch(w, x):
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    return lambda z: z - torch.tanh(z @ wt + xt)


def _cfg(qn_dtype, **kw):
    base = dict(max_steps=30, tol=1e-5, memory=6, qn_dtype=qn_dtype)
    base.update(kw)
    return jsol.SolverConfig(**base), tsol.SolverConfig(**base)


def _assert_same(rt, rj, qn_dtype):
    assert int(rt.n_steps) == int(rj.n_steps)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    # f32 ring: rtol 1e-4, plus an atol at the f32 floor of a residual
    # z - f(z) of O(1) iterates (the last steps sit at ~1e-5).  bf16 ring:
    # an f32 difference in the last bit can flip one bf16 rounding of a
    # stored pair (2^-8 relative), which moves later residuals by ~1e-3
    # relative -- held at the bf16 tolerance of tests/test_kernels.py.
    tol = (dict(rtol=1e-4, atol=1e-6) if qn_dtype == "float32"
           else dict(rtol=2e-2, atol=1e-6))
    np.testing.assert_allclose(rt.trace.numpy(), np.asarray(rj.trace), **tol)
    np.testing.assert_allclose(rt.z.float().numpy(),
                               np.asarray(rj.z, np.float32),
                               rtol=1e-4, atol=1e-5)


def _torch_carry(jc):
    """The JAX carry's arrays, as a port carry (numpy round trip)."""
    lr = jc.lowrank
    u = np.array(lr.u.astype(jnp.float32))
    v = np.array(lr.v.astype(jnp.float32))
    dt = torch.bfloat16 if lr.u.dtype == jnp.bfloat16 else torch.float32
    return tsol.SolveCarry(
        z=torch.from_numpy(np.array(jc.z)),
        lowrank=tsol.LowRank(alpha=torch.tensor(float(lr.alpha)),
                             u=torch.from_numpy(u).to(dt),
                             v=torch.from_numpy(v).to(dt),
                             count=torch.from_numpy(np.array(lr.count))),
        warm=torch.from_numpy(np.array(jc.warm)),
        age=torch.from_numpy(np.array(jc.age)))


@pytest.mark.parametrize("qn_dtype", ["float32", "bfloat16"])
def test_broyden_cold_and_carried_match_jax(qn_dtype):
    w, x = _problem(0)
    jcfg, tcfg = _cfg(qn_dtype)
    z0 = np.zeros((B, D), np.float32)
    jc = jsol.init_solve_carry(B, D, jcfg.memory, qn_dtype=qn_dtype)
    tc = tsol.init_solve_carry(B, D, tcfg.memory, qn_dtype=qn_dtype)
    rj = jsol.broyden_solve(_g_jax(w, x), jnp.asarray(z0), jcfg, carry=jc)
    rt = tsol.broyden_solve(_g_torch(w, x), torch.from_numpy(z0), tcfg,
                            carry=tc)
    _assert_same(rt, rj, qn_dtype)
    assert int(rj.n_steps) > 3
    # second solve on a nearby problem, warm-started from the JAX carry
    x2 = x + np.float32(0.05)
    rj2 = jsol.broyden_solve(_g_jax(w, x2), jnp.asarray(z0), jcfg,
                             carry=rj.carry)
    rt2 = tsol.broyden_solve(_g_torch(w, x2), torch.from_numpy(z0), tcfg,
                             carry=_torch_carry(rj.carry))
    _assert_same(rt2, rj2, qn_dtype)
    assert int(rj2.n_steps) < int(rj.n_steps)
    np.testing.assert_array_equal(rt2.carry.age.numpy(),
                                  np.asarray(rj2.carry.age))
    np.testing.assert_array_equal(rt2.carry.lowrank.count.numpy(),
                                  np.asarray(rj2.carry.lowrank.count))


@pytest.mark.parametrize("qn_dtype", ["float32", "bfloat16"])
def test_broyden_freeze_mask_matches_jax(qn_dtype):
    w, x = _problem(1)
    jcfg, tcfg = _cfg(qn_dtype, memory=4)  # wraps the ring
    z0 = np.zeros((B, D), np.float32)
    frz = np.array([False, True, False, True])
    rj = jsol.broyden_solve(_g_jax(w, x), jnp.asarray(z0), jcfg,
                            freeze_mask=jnp.asarray(frz))
    rt = tsol.broyden_solve(_g_torch(w, x), torch.from_numpy(z0), tcfg,
                            freeze_mask=torch.from_numpy(frz))
    _assert_same(rt, rj, qn_dtype)
    # frozen rows never move and never record
    np.testing.assert_array_equal(rt.z[1].numpy(), z0[1])
    assert np.isinf(rt.trace[:, 1].numpy()).all()
    np.testing.assert_array_equal(rt.tape.qn_count.numpy(),
                                  np.asarray(rj.tape.qn_count))


def test_guard_entry_repairs_nan_carry_like_jax():
    w, x = _problem(2)
    jcfg, tcfg = _cfg("bfloat16")
    z0 = np.zeros((B, D), np.float32)
    jc = jsol.init_solve_carry(B, D, jcfg.memory)
    warm = jsol.broyden_solve(_g_jax(w, x), jnp.asarray(z0), jcfg,
                              carry=jc).carry
    zbad = np.array(warm.z)
    zbad[1, 3] = np.nan
    bad = dataclasses.replace(warm, z=jnp.asarray(zbad))
    rj = jsol.broyden_solve(_g_jax(w, x), jnp.asarray(z0), jcfg, carry=bad)
    rt = tsol.broyden_solve(_g_torch(w, x), torch.from_numpy(z0), tcfg,
                            carry=_torch_carry(bad))
    assert int(rt.status[1]) == tsol.STATUS_NONFINITE
    _assert_same(rt, rj, "bfloat16")
    np.testing.assert_array_equal(rt.aux["restarts"].numpy(),
                                  np.asarray(rj.aux["restarts"]))
    assert np.isfinite(rt.z.numpy()).all()


@pytest.mark.parametrize("qn_dtype", ["float32", "bfloat16"])
def test_lowrank_products_and_dense_match_jax(qn_dtype):
    from repro.core.lowrank import LowRank as JLowRank
    rng = np.random.default_rng(4)
    m = 5
    u = rng.standard_normal((m, B, D)).astype(np.float32)
    v = rng.standard_normal((m, B, D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    count = np.array([m + 2, 2, 0, m], np.int32)  # wrapped, ragged, empty
    jdt = jnp.bfloat16 if qn_dtype == "bfloat16" else jnp.float32
    tdt = tsol.torch_dtype(qn_dtype)
    jl = JLowRank(alpha=jnp.float32(0.8), u=jnp.asarray(u).astype(jdt),
                  v=jnp.asarray(v).astype(jdt), count=jnp.asarray(count))
    tl = tsol.LowRank(alpha=torch.tensor(0.8),
                      u=torch.from_numpy(u).to(tdt),
                      v=torch.from_numpy(v).to(tdt),
                      count=torch.from_numpy(count))
    tx = torch.from_numpy(x)
    for got, want in ((tl.matvec(tx), jl.matvec(jnp.asarray(x))),
                      (tl.rmatvec(tx), jl.rmatvec(jnp.asarray(x))),
                      (tl.dense(), jl.dense())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-3)
    # H^T x through the dense matrix agrees with rmatvec
    np.testing.assert_allclose(
        torch.einsum("bij,bi->bj", tl.dense(), tx).numpy(),
        tl.rmatvec(tx).numpy(), rtol=1e-4, atol=1e-3)
