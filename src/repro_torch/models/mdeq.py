"""Multiscale DEQ (Bai et al. 2020): the paper's CIFAR model (§3.2).

The port of ``repro/models/mdeq.py``.  A two-scale residual conv trunk is
solved to a fixed point; the state ``(z1, z2)`` goes to
``implicit_fixed_point`` as a tuple, which packs it into one flat ``(B,
D)`` solver state (``implicit/pytree.py``), so the forward Broyden solve
runs the ``broyden_step`` and ``qn_apply_multi`` kernels on it.  Head:
per-scale group norm, pooling and a linear layer.

Layout: activations and the fixed-point state are NHWC, as in the JAX
package, so the packed state equals JAX's element for element and the
Broyden iterates and rings compare directly.  Convolutions see the same
tensors as NCHW views (channels-last strides) and take OIHW weights (the
port's conv layout; :func:`params_from_jax` converts JAX's HWIO).
Convolutions and group norm are ``F.conv2d`` / ``F.group_norm``: the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.mdeq_cifar import MDEQConfig
from repro_torch.core.deq import DEQConfig, as_implicit_config
from repro_torch.device import resolve_device
from repro_torch.implicit import ImplicitConfig, ImplicitStats, implicit_fixed_point

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """One parameter tensor: its shape, its init and, for ``fan_in``, the
    fan-in its truncated-normal scale divides by (the JAX package's:
    every axis but the output one)."""

    shape: tuple[int, ...]
    init: str = "fan_in"  # fan_in | zeros | ones
    fan_in: int = 1


def _conv_decl(cin: int, cout: int, k: int = 3) -> ParamDecl:
    return ParamDecl((cout, cin, k, k), fan_in=k * k * cin)


def _gn_decl(c: int) -> dict:
    return {"scale": ParamDecl((c,), "ones"),
            "bias": ParamDecl((c,), "zeros")}


def mdeq_decl(cfg: MDEQConfig) -> dict:
    c1, c2 = cfg.channels
    return {
        "stem": _conv_decl(3, c1),
        "inj2": _conv_decl(c1, c2),          # strided injection to scale 2
        "blocks": {
            "s1": {"conv1": _conv_decl(c1, c1), "gn1": _gn_decl(c1),
                   "conv2": _conv_decl(c1, c1), "gn2": _gn_decl(c1)},
            "s2": {"conv1": _conv_decl(c2, c2), "gn1": _gn_decl(c2),
                   "conv2": _conv_decl(c2, c2), "gn2": _gn_decl(c2)},
            "down": _conv_decl(c1, c2),      # scale 1 -> scale 2 (stride 2)
            "up": _conv_decl(c2, c1, k=1),   # scale 2 -> scale 1 (resize)
            "fuse_gn1": _gn_decl(c1),
            "fuse_gn2": _gn_decl(c2),
        },
        "head": {
            "gn1": _gn_decl(c1), "gn2": _gn_decl(c2),
            "w": ParamDecl((c1 + c2, cfg.num_classes), fan_in=c1 + c2),
            "b": ParamDecl((cfg.num_classes,), "zeros"),
        },
    }


def _init_leaf(d: ParamDecl, gen: torch.Generator, device) -> Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    if d.init == "fan_in":
        # standard normal truncated to [-2, 2], scaled by 1/sqrt(fan_in)
        std = 1.0 / math.sqrt(d.fan_in)
        out = torch.empty(d.shape, device=device)
        return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=gen)
    raise ValueError(f"unknown init {d.init!r}")


def init_mdeq(cfg: MDEQConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes (conv weights in
    the port's OIHW layout) and distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device.  The
    numbers differ from JAX's for the same seed; :func:`params_from_jax`
    carries JAX's over."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(decl):
        return {k: (build(v) if isinstance(v, dict) else
                    _init_leaf(v, gen, dev)) for k, v in decl.items()}

    return build(mdeq_decl(cfg))


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's MDEQ parameters (any tree of arrays numpy can
    read) as the port's: f32 tensors on ``device``, conv weights moved from
    HWIO to OIHW."""
    dev = resolve_device(device)

    def conv(v):
        a = np.asarray(v, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.tensor(np.ascontiguousarray(a)).to(dev)

    return {k: (params_from_jax(v, dev) if isinstance(v, dict) else conv(v))
            for k, v in tree.items()}


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME": ``ceil(n / stride)`` outputs, the extra pad row (if
    the total is odd) at the end."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """NHWC ``x`` by an OIHW ``w``, "SAME" padding -> NHWC."""
    k = w.shape[-1]
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1], k, stride),
                          _same_pads(x.shape[2], k, stride))
    xc = _nchw(x)
    if (ht, wl) == (hb, wr):
        return _nhwc(F.conv2d(xc, w, stride=stride, padding=(ht, wl)))
    return _nhwc(F.conv2d(F.pad(xc, (wl, wr, ht, hb)), w, stride=stride))


def _gn(p: dict, x: Tensor, groups: int) -> Tensor:
    """Group norm of NHWC ``x`` over ``g`` groups of contiguous channels,
    ``g`` the largest divisor of ``c`` not above ``groups``; f32 inside,
    eps 1e-5."""
    c = x.shape[-1]
    g = min(groups, c)
    while c % g:
        g -= 1
    y = F.group_norm(_nchw(x).float(), g, p["scale"].float(),
                     p["bias"].float(), 1e-5)
    return _nhwc(y).to(x.dtype)


def _upsample(x: Tensor, size: tuple[int, int]) -> Tensor:
    """``jax.image.resize(..., "nearest")`` of NHWC ``x`` to ``size``: at
    factor 2 output ``i`` takes input ``i // 2``, as ``F.interpolate``'s
    "nearest" does."""
    return _nhwc(F.interpolate(_nchw(x), size=size, mode="nearest"))


def _res_block(p: dict, z: Tensor, inj: Tensor, groups: int) -> Tensor:
    h = _conv(z, p["conv1"]) + inj
    h = F.relu(_gn(p["gn1"], h, groups))
    h = _conv(h, p["conv2"])
    return F.relu(_gn(p["gn2"], h + z, groups))


def mdeq_f(params: dict, x_feats: tuple[Tensor, Tensor],
           z: tuple[Tensor, Tensor], cfg: MDEQConfig) -> tuple[Tensor, Tensor]:
    """One application of the multiscale transformation ``f_theta``."""
    bp = params["blocks"]
    x1, x2 = x_feats
    z1, z2 = z
    u1 = _res_block(bp["s1"], z1, x1, cfg.groups)
    u2 = _res_block(bp["s2"], z2, x2, cfg.groups)
    # cross-scale fusion
    down = _conv(u1, bp["down"], stride=2)
    up = _upsample(_conv(u2, bp["up"]), (u1.shape[1], u1.shape[2]))
    z1n = F.relu(_gn(bp["fuse_gn1"], u1 + up, cfg.groups))
    z2n = F.relu(_gn(bp["fuse_gn2"], u2 + down, cfg.groups))
    return z1n, z2n


def implicit_config(cfg: MDEQConfig,
                    deq_cfg: DEQConfig | ImplicitConfig | None = None
                    ) -> ImplicitConfig:
    """The solver/estimator config of an MDEQ forward/backward."""
    if deq_cfg is None:
        return ImplicitConfig.from_strings(
            solver=cfg.solver, max_steps=cfg.max_steps, tol=cfg.tol,
            memory=cfg.memory, backward=cfg.backward,
            refine_steps=cfg.refine_steps,
            backward_max_steps=cfg.backward_max_steps,
        )
    return as_implicit_config(deq_cfg)


def mdeq_forward(params: dict, images: Tensor, cfg: MDEQConfig,
                 deq_cfg: DEQConfig | ImplicitConfig | None = None
                 ) -> tuple[Tensor, ImplicitStats]:
    """``images (B, H, W, 3)`` -> ``(logits, solver stats)``."""
    icfg = implicit_config(cfg, deq_cfg)
    b = images.shape[0]
    c1, c2 = cfg.channels
    x1 = F.relu(_conv(images, params["stem"]))
    x2 = F.relu(_conv(x1, params["inj2"], stride=2))
    half = cfg.image_size // 2
    z0 = (torch.zeros((b, cfg.image_size, cfg.image_size, c1),
                      dtype=x1.dtype, device=x1.device),
          torch.zeros((b, half, half, c2), dtype=x1.dtype, device=x1.device))

    def f(p, xf, z):
        return mdeq_f(p, xf, z, cfg)

    (z1, z2), stats = implicit_fixed_point(f, params, (x1, x2), z0, icfg)

    h = params["head"]
    f1 = F.relu(_gn(h["gn1"], z1, cfg.groups)).mean(dim=(1, 2))
    f2 = F.relu(_gn(h["gn2"], z2, cfg.groups)).mean(dim=(1, 2))
    logits = torch.cat([f1, f2], dim=-1) @ h["w"] + h["b"]
    return logits, stats


def mdeq_loss(params: dict, batch: dict, cfg: MDEQConfig,
              deq_cfg: DEQConfig | ImplicitConfig | None = None):
    logits, stats = mdeq_forward(params, batch["images"], cfg, deq_cfg)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, {"loss": nll, "acc": acc,
                 "deq_residual": stats.residual.mean(),
                 "deq_steps": stats.n_steps}


def synthetic_cifar(n: int, cfg: MDEQConfig, seed: int = 0, device=None):
    """Deterministic CIFAR-shaped dataset with learnable class structure:
    the JAX package's numpy draws, so one seed gives one dataset in both.
    Returns ``(images (n, H, W, 3) f32, labels (n,) int64)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(cfg.num_classes, cfg.image_size,
                              cfg.image_size, 3))
    labels = rng.integers(0, cfg.num_classes, n)
    images = 0.6 * protos[labels] + 0.8 * rng.normal(
        size=(n, cfg.image_size, cfg.image_size, 3))
    return (torch.as_tensor(images, dtype=torch.float32).to(dev),
            torch.as_tensor(labels, dtype=torch.int64).to(dev))
