"""Quickstart: the SHINE idea in 60 lines, on the PyTorch port.

The port's counterpart of ``examples/quickstart.py``: a tiny implicit
(fixed-point) layer z* = tanh(W z* + U x + b), trained with three backward
modes -- full iterative inversion (original DEQ), SHINE (the paper: share
the forward solver's quasi-Newton inverse estimate), and Jacobian-Free --
printing each mode's loss curve and its time for the steps.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default device is the CUDA card).
"""

import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.implicit import (
    BackwardConfig,
    ForwardConfig,
    ImplicitConfig,
    implicit_fixed_point,
)

B, D_IN, D = 32, 8, 64
MODES = (("full", "original (iterative inversion)"),
         ("shine", "SHINE (shared inverse estimate)"),
         ("jfb", "Jacobian-Free"))


def f(params, x, z):
    return torch.tanh(z @ params["w"].T + x @ params["u"].T + params["b"])


def make_problem(device, seed: int = 0):
    """``(params, x, y)``: a contractive layer, its inputs and a regression
    target, drawn from ``seed`` on ``device``."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    params = {"w": 0.3 * normal(D, D) / D ** 0.5,
              "u": normal(D, D_IN) / D_IN ** 0.5,
              "b": torch.zeros(D)}
    x, y = normal(B, D_IN), normal(B, D)
    to = lambda t: t.to(device)  # noqa: E731
    return {k: to(v) for k, v in params.items()}, to(x), to(y)


def implicit_config(mode: str) -> ImplicitConfig:
    return ImplicitConfig(
        forward=ForwardConfig(solver="broyden", max_steps=30, tol=1e-6),
        backward=BackwardConfig(estimator=mode, max_steps=30),
        memory=30)


def train(params, x, y, mode: str, steps: int = 200,
          log_every: int = 50) -> tuple[list[float], float]:
    """``steps`` SGD steps (lr 0.05) on the mean squared error of the fixed
    point through the ``mode`` backward, from a copy of ``params``.
    Returns the loss after the steps ``0, log_every, ...`` and after the
    last, and the seconds the steps took."""
    cfg = implicit_config(mode)
    z0 = torch.zeros(x.shape[0], params["w"].shape[0], dtype=x.dtype,
                     device=x.device)

    def loss_fn(p):
        z, _ = implicit_fixed_point(f, p, x, z0, cfg)
        return torch.mean((z - y) ** 2)

    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        grads = torch.autograd.grad(loss_fn(p), list(p.values()))
        with torch.no_grad():
            p = {k: (v - 0.05 * g).requires_grad_(True)
                 for (k, v), g in zip(p.items(), grads)}
        if step % log_every == 0 or step == steps - 1:
            with torch.no_grad():
                losses.append(float(loss_fn(p)))
    return losses, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    params, x, y = make_problem(resolve_device(args.device))
    for mode, label in MODES:
        losses, dt = train(params, x, y, mode)
        print(f"{label:38s} losses={['%.4f' % v for v in losses]} "
              f"({dt:.2f}s for 200 steps)")


if __name__ == "__main__":
    main()
