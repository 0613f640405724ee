"""Bi-level / hyperparameter optimisation with SHINE (paper §3.1, Eq. 2).

The port of ``repro/core/bilevel.py``.  HOAG-style outer loop (Pedregosa
2016): at outer step k the inner problem ``z*(theta) = argmin_z
r_theta(z)`` is solved inexactly with L-BFGS to a decreasing tolerance,
then the hypergradient

    dL/dtheta = - (dg/dtheta)^T q,     q = (Hess_z r_theta(z*))^{-1} dL/dz*

is estimated by one of:

  * full_cg      -- CG on Hessian-vector products (the HOAG baseline),
  * shine        -- ``q = H_lbfgs dL/dz`` by the two-loop recursion: the
                    inverse estimate is shared from the forward pass,
  * shine_opa    -- shine, with OPA's extra secant pairs in the
                    ``dg/dtheta`` direction during the forward L-BFGS
                    (Thm 3),
  * jfb          -- ``q = dL/dz`` (Jacobian-free),
  * shine_refine -- CG warm-started at the shine estimate.

Hyperparameters are optimised in log space.  Derivatives of the inner
objective come from ``torch.func`` (``grad``, ``jacfwd``, ``jvp``,
``vjp``).  The JAX package's loop jits one solver per tolerance level; the
port runs eagerly and caches nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import func as tfunc

from repro_torch.core.solvers import (
    LBFGSMemory,
    SolverConfig,
    empty_lbfgs_memory,
    lbfgs_solve,
)
from repro_torch.device import resolve_device
from repro_torch.implicit import ESTIMATORS, estimate_hypergrad_cotangent
from repro_torch.implicit.config import BackwardConfig, ImplicitConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing

Tensor = torch.Tensor

# HOAG mode -> (registered estimator, use OPA extra secant pairs in the
# forward L-BFGS).  Any other registered estimator name is a mode too
# (without OPA).
_HOAG_MODES: dict[str, tuple[str, bool]] = {
    "full_cg": ("full", False),
    "shine": ("shine", False),
    "shine_opa": ("shine", True),
    "jfb": ("jfb", False),
    "shine_refine": ("shine_refine", False),
}


def resolve_hoag_mode(mode: str) -> tuple[str, bool]:
    """Map a HOAG mode string to ``(estimator name, use_opa)``."""
    if mode in _HOAG_MODES:
        return _HOAG_MODES[mode]
    if mode in ESTIMATORS:
        return (mode, False)
    raise ValueError(
        f"unknown HOAG mode {mode!r}; modes: {', '.join(sorted(_HOAG_MODES))}"
        f"; registered estimators: {', '.join(ESTIMATORS.names())}"
    )


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    """Inner objective ``r(z, theta)``; outer losses are functions of ``z``
    only.  ``device`` is where ``z`` lives (the tensors the closures
    hold)."""

    inner_value: Callable[[Tensor, Tensor], Tensor]
    outer_loss: Callable[[Tensor], Tensor]
    test_loss: Callable[[Tensor], Tensor]
    dim: int
    device: torch.device = torch.device("cpu")

    def inner_grad(self, z: Tensor, theta: Tensor) -> Tensor:
        return tfunc.grad(self.inner_value, argnums=0)(z, theta)

    def dg_dtheta(self, z: Tensor, theta: Tensor) -> Tensor:
        """``(D,)`` partial of the inner gradient in a scalar theta."""
        return tfunc.jacfwd(lambda t: self.inner_grad(z, t))(theta).reshape(-1)

    def hvp(self, z: Tensor, theta: Tensor, v: Tensor) -> Tensor:
        return tfunc.jvp(lambda zz: self.inner_grad(zz, theta), (z,), (v,))[1]


@dataclasses.dataclass(frozen=True)
class HOAGConfig:
    mode: str = "shine"            # full_cg | shine | shine_opa | jfb | shine_refine
    outer_steps: int = 30
    outer_lr: float = 1.0
    inner: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(max_steps=200, tol=1e-6, memory=30)
    )
    tol_decrease: float = 0.78     # paper App. C: 0.78 accelerated, 0.99 HOAG
    cg_steps: int = 100
    cg_tol: float = 1e-8
    refine_steps: int = 5
    # warm-start the inner solve's secant memory (the inverse estimate the
    # hypergradient shares) from the previous outer iterate, on top of the
    # z warm start HOAG always does
    warm_start: bool = True

    def implicit_cfg(self) -> ImplicitConfig:
        """The backward sub-config this mode implies: the paper's bi-level
        modes use the L-BFGS estimate as it is (``fallback_ratio=inf``); a
        pass-through estimator name keeps the standard guard ratio."""
        estimator, _ = resolve_hoag_mode(self.mode)
        ratio = float("inf") if self.mode in _HOAG_MODES \
            else BackwardConfig().fallback_ratio
        return ImplicitConfig(
            backward=BackwardConfig(
                estimator=estimator, max_steps=self.cg_steps,
                refine_steps=self.refine_steps, tol=self.cg_tol,
                fallback_ratio=ratio,
            ),
            memory=self.inner.memory,
        )


class OuterRecord(NamedTuple):
    step: int
    wall_time: float
    theta: float
    val_loss: float
    test_loss: float
    inner_steps: int
    backward_hvp_calls: int


def hypergradient(problem: BilevelProblem, theta: Tensor, z_star: Tensor,
                  mem: LBFGSMemory, cfg: HOAGConfig) -> tuple[Tensor, int]:
    """Returns ``(dL/dtheta estimate, HVP calls of the backward)``."""
    w = tfunc.grad(problem.outer_loss)(z_star)
    adj = estimate_hypergrad_cotangent(
        cfg.implicit_cfg(), lambda v: problem.hvp(z_star, theta, v), w, mem)
    # dL/dtheta = - q^T dg/dtheta (VJP of the inner gradient in theta)
    _, vjp = tfunc.vjp(lambda t: problem.inner_grad(z_star, t), theta)
    (gt,) = vjp(adj.u)
    return -gt, adj.n_steps


def run_hoag(problem: BilevelProblem, theta0: float, cfg: HOAGConfig, *,
             seed: int = 0, verbose: bool = False) -> list[OuterRecord]:
    """Outer gradient descent on log-theta with warm-started inner solves:
    the previous inner solution seeds the next solve and, with
    ``cfg.warm_start``, the previous secant memory seeds its curvature
    model.  Host reads per outer step: the inner solve's and CG's stop
    tests and the record's three scalars (theta, validation and test
    loss); nothing else waits for the card."""
    dev = problem.device
    # a fill on the device, not a copy from the host (which waits)
    log_theta = torch.full((), float(np.log(theta0)), dtype=torch.float32,
                           device=dev)
    z = torch.zeros((problem.dim,), dtype=torch.float32, device=dev)
    cold_mem = mem = empty_lbfgs_memory(cfg.inner.memory, problem.dim, dev)
    history: list[OuterRecord] = []
    t0 = time.perf_counter()
    tol = cfg.inner.tol
    lr = cfg.outer_lr
    _, use_opa = resolve_hoag_mode(cfg.mode)
    reg = obs_metrics.default_registry()

    for k in range(cfg.outer_steps):
        with obs_tracing.span("hoag_outer", step=k, mode=cfg.mode):
            theta = torch.exp(log_theta)
            icfg = dataclasses.replace(cfg.inner, tol=float(tol),
                                       opa_freq=(5 if use_opa else 0))
            with obs_tracing.span("inner_solve", step=k, tol=float(tol)):
                res = lbfgs_solve(
                    lambda zz: problem.inner_grad(zz, theta), z, icfg,
                    value_fn=lambda zz: problem.inner_value(zz, theta),
                    dg_dtheta=((lambda zz: problem.dg_dtheta(zz, theta))
                               if use_opa else None),
                    mem0=mem if cfg.warm_start else cold_mem)
                z = res.z
            mem = res.memory
            with obs_tracing.span("hypergradient", step=k):
                hg, hvp_calls = hypergradient(problem, theta, z, mem, cfg)
            # chain rule through theta = exp(log_theta)
            g_log = hg * theta
            log_theta = log_theta - lr * torch.clamp(g_log, -5.0, 5.0)
            tol = max(tol * cfg.tol_decrease, 1e-12)

        lbl = {"mode": cfg.mode}
        reg.counter("hoag_outer_total", lbl).inc()
        reg.counter("hoag_inner_iters_total", lbl).inc(int(res.n_steps))
        reg.counter("hoag_hvp_calls_total", lbl).inc(int(hvp_calls))
        rec = OuterRecord(
            step=k,
            wall_time=time.perf_counter() - t0,
            theta=float(theta),
            val_loss=float(problem.outer_loss(z)),
            test_loss=float(problem.test_loss(z)),
            inner_steps=int(res.n_steps),
            backward_hvp_calls=int(hvp_calls),
        )
        reg.gauge("hoag_val_loss", lbl).set(rec.val_loss)
        reg.gauge("hoag_theta", lbl).set(rec.theta)
        history.append(rec)
        if verbose:
            print(
                f"[{cfg.mode}] k={k:3d} t={rec.wall_time:7.2f}s "
                f"theta={rec.theta:.3e} val={rec.val_loss:.4f} "
                f"test={rec.test_loss:.4f} inner={rec.inner_steps} "
                f"hvp={rec.backward_hvp_calls}")
    return history


# ---------------------------------------------------------------------------
# Synthetic problems shaped like the paper's; the numpy draws are the JAX
# package's, so one seed gives one dataset in both
# ---------------------------------------------------------------------------


def _split(X: np.ndarray, y: np.ndarray, n_train: int, n_val: int, dev):
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    a, b = n_train, n_train + n_val
    return (X[:a], y[:a]), (X[a:b], y[a:b]), (X[b:], y[b:])


def make_logreg_problem(n_train: int = 2000, n_val: int = 500,
                        n_test: int = 500, dim: int = 800,
                        density: float = 0.05, seed: int = 0,
                        device: str | torch.device | None = None
                        ) -> BilevelProblem:
    """l2-regularised logistic regression (Eq. 2), a sparse-like design
    held dense; on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_train + n_val + n_test
    X = rng.normal(size=(n, dim)) * (rng.random((n, dim)) < density)
    w_true = rng.normal(size=(dim,)) * (rng.random(dim) < 0.2)
    logits = X @ w_true + 0.5 * rng.normal(size=n)
    y = np.sign(logits)
    (Xtr, ytr), (Xv, yv), (Xte, yte) = _split(X, y, n_train, n_val, dev)

    def log_loss(z, Xs, ys):
        # softplus as jax.nn.softplus computes it: logaddexp(x, 0)
        margins = ys * (Xs @ z)
        return torch.logaddexp(-margins, torch.zeros_like(margins)).mean()

    def inner_value(z, theta):
        return log_loss(z, Xtr, ytr) + 0.5 * theta * torch.dot(z, z)

    return BilevelProblem(
        inner_value=inner_value,
        outer_loss=lambda z: log_loss(z, Xv, yv),
        test_loss=lambda z: log_loss(z, Xte, yte),
        dim=dim, device=dev,
    )


def make_nlls_problem(n_train: int = 1000, n_val: int = 300,
                      n_test: int = 300, dim: int = 400, seed: int = 0,
                      device: str | torch.device | None = None
                      ) -> BilevelProblem:
    """Regularised nonlinear least squares (paper E.2): nonconvex inner."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_train + n_val + n_test
    X = rng.normal(size=(n, dim)) / np.sqrt(dim)
    w_true = rng.normal(size=(dim,))
    y = 1.0 / (1.0 + np.exp(-(X @ w_true))) + 0.05 * rng.normal(size=n)
    (Xtr, ytr), (Xv, yv), (Xte, yte) = _split(X, y, n_train, n_val, dev)

    def nlls(z, Xs, ys):
        return 0.5 * ((ys - torch.sigmoid(Xs @ z)) ** 2).mean()

    def inner_value(z, theta):
        return nlls(z, Xtr, ytr) + 0.5 * theta * torch.dot(z, z)

    return BilevelProblem(
        inner_value=inner_value,
        outer_loss=lambda z: nlls(z, Xv, yv),
        test_loss=lambda z: nlls(z, Xte, yte),
        dim=dim, device=dev,
    )
