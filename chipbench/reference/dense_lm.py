"""The plain reference of the dense LM cells: MiniCPM-2B as a 40-layer
stack and as a SHINE DEQ of weight-tied blocks, trained with AdamW.

Plain PyTorch in float32 with TF32 off.  It imports nothing of the program
under test and nothing of JAX: what it knows of the model comes from the
configuration file (widths, the DEQ's settings) and the parameter tree the
benchmark drew from the seed (``chipbench/weights.py`` and
``chipbench/layouts/dense_lm.py``), which both sides
receive as the same tensors.

The model (MiniCPM-2B's llama-like block without its muP scalings, as the
configuration file lists under ``reduced``):

    x = E[tokens];  block(h) = h' + SwiGLU(rms(h')),  h' = h + Attn(rms(h))
    stack:  z = block_L(... block_1(x));   DEQ:  z* = x + (B(z*) - z*),
    B = block_nb o ... o block_1 (weight-tied, solved by Broyden);
    logits = rms(z) E^T over the padded vocabulary;
    loss = mean NLL + z_loss * mean(logsumexp^2).

The DEQ's solve is Broyden's good method on ``g(z) = z - f(z)`` from
``z0`` (the injection, or the previous step's fixed point as the trainer's
``deq_carry="state"`` warm start gives it), with a ring of ``memory``
rank-one pairs, per-row stop tests ``||g|| < tol * max(||z||, 1)`` and the
best iterate returned.  Held against a run, it takes that run's count of
iterations for each step and runs them all: SHINE's gradient is built
from the solve's rank-one updates, so two solves that stop after
different counts give different gradients, and a bfloat16 solve stops
later than a float32 one at the same ``tol``.  The backward is ``shine_fallback``: ``u = H^T w``
with the solve's inverse estimate, JFB (``u = w``) on rows where
``||H^T w|| > ratio * ||w||``, then ``u^T df/dtheta``.  Every vector and
the ring are float32; the parameters are stored as the configuration
states them (bfloat16: each update is rounded to it, as the stored
parameters of the program are).

``quant="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 with one scale per tensor (what an fp8 GEMM with
per-tensor scaling computes), the step below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from chipbench import tree

FP8_MAX = 448.0


def set_plain_precision() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (amax to
    the format's largest value), back in float32; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    s = amax / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Ref:
    """The reference model of one configuration (``cfg``: the
    configuration file's dict) at float32, or its fp8 control."""

    def __init__(self, cfg: dict, quant: str | None = None):
        self.cfg = cfg
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        if quant not in (None, "fp8"):
            raise ValueError(f"quant={quant!r}")
        self.q = _fp8 if quant == "fp8" else (lambda t: t)

    # -- layers ------------------------------------------------------------

    def mm(self, a, w):
        return self.q(a) @ self.q(w)

    def rms(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * w

    def rope(self, x, pos):
        hd = x.shape[-1]
        freqs = 1.0 / (self.theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos[:, None].float() * freqs                  # (S, hd/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p, x):
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device)
        q = self.rope(self.mm(x, p["wq"]).view(b, s, self.h, self.hd), pos)
        k = self.rope(self.mm(x, p["wk"]).view(b, s, self.kv, self.hd), pos)
        v = self.mm(x, p["wv"]).view(b, s, self.kv, self.hd)
        if self.kv != self.h:
            k = k.repeat_interleave(self.h // self.kv, dim=2)
            v = v.repeat_interleave(self.h // self.kv, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, hd)
        scores = self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(self.hd)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        out = (self.q(probs) @ self.q(v)).transpose(1, 2).reshape(b, s, -1)
        return self.mm(out, p["wo"])

    def block(self, p, x):
        x = x + self.attention(p["attn"], self.rms(x, p["ln1"]["scale"]))
        h = self.rms(x, p["ln2"]["scale"])
        m = p["mlp"]
        return x + self.mm(F.silu(self.mm(h, m["wi_g"])) * self.mm(h, m["wi_u"]),
                           m["wo"])

    def head_loss(self, params, z, targets, z_loss):
        z = self.rms(z, params["final_norm"]["scale"])
        logits = self.mm(z, params["embed"]["embedding"].t())
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return (lse - gold).mean() + z_loss * (lse ** 2).mean()

    # -- the explicit stack --------------------------------------------------

    def stack_loss(self, params, batch, z_loss):
        x = params["embed"]["embedding"][batch["tokens"].long()]
        g = params["group0"]
        for j in range(g["ln1"]["scale"].shape[0]):
            layer = tree.layer(g, j)
            x = torch.utils.checkpoint.checkpoint(self.block, layer, x,
                                                  use_reentrant=False)
        return self.head_loss(params, x, batch["targets"], z_loss)

    # -- the DEQ -------------------------------------------------------------

    def f(self, blocks, x, z):
        h = z
        for j in range(blocks["ln1"]["scale"].shape[0]):
            h = self.block(tree.layer(blocks, j), h)
        return x + (h - z)

    def deq_loss_grads(self, params, batch, z_loss, z_start=None,
                       steps=None):
        """The DEQ step's loss and ``shine_fallback`` gradients.  Returns
        ``(loss, grads, z_star, n_iters)``.  ``steps``: run exactly that
        many solve iterations (no stop test) instead of the
        configuration's ``max_steps`` and ``tol``."""
        deq = self.cfg["deq"]
        n_max, tol = ((deq["max_steps"], deq["tol"]) if steps is None
                      else (steps, 0.0))
        emb = params["embed"]["embedding"]
        blocks = params["deq_blocks"]
        with torch.no_grad():
            x = emb[batch["tokens"].long()]
            z0 = x if z_start is None else z_start
            z_star, H, n = broyden(lambda z: z - self.f(blocks, x, z), z0,
                                   n_max, tol, deq["memory"])
        zs = z_star.detach().requires_grad_(True)
        head = {"embed": params["embed"], "final_norm": params["final_norm"]}
        leaves = tree.leaves(head)
        for t in leaves:
            t.requires_grad_(True)
        loss = self.head_loss(head, zs, batch["targets"], z_loss)
        w, *g_head = torch.autograd.grad(loss, [zs] + leaves)
        with torch.no_grad():
            u = H.rmatvec(w)
            bad = _bnorm(u) > deq["fallback_ratio"] * _bnorm(w)
            u = torch.where(bad[:, None, None], w, u)
        b_leaves = tree.leaves(blocks)
        for t in b_leaves:
            t.requires_grad_(True)
        xg = emb[batch["tokens"].long()]
        y = self.f(blocks, xg, zs)
        g_blocks = torch.autograd.grad(y, b_leaves + [emb], u)
        for t in leaves + b_leaves:
            t.requires_grad_(False)
        grads = tree.rebuild(head, list(g_head))
        grads["embed"]["embedding"] = grads["embed"]["embedding"] + g_blocks[-1]
        grads["deq_blocks"] = tree.rebuild(blocks, list(g_blocks[:-1]))
        return loss.detach(), grads, z_star, n


# ---------------------------------------------------------------------------
# Broyden's good method with a ring of rank-one pairs, in float32
# ---------------------------------------------------------------------------


def _bdot(a, b):
    return (a * b).reshape(a.shape[0], -1).sum(-1)


def _bnorm(a):
    return torch.sqrt(_bdot(a, a).clamp(min=0.0))


def _ex(v, ref):
    return v.reshape(v.shape + (1,) * (ref.ndim - 1))


class Ring:
    """``H = I + sum_i u_i v_i^T`` over each row's live slots."""

    def __init__(self, m, z):
        self.m = m
        self.u = torch.zeros((m,) + z.shape, device=z.device)
        self.v = torch.zeros_like(self.u)
        self.count = torch.zeros(z.shape[0], dtype=torch.long,
                                 device=z.device)

    def _live(self):
        idx = torch.arange(self.m, device=self.u.device)[:, None]
        return (idx < self.count.clamp(max=self.m)[None]).float()  # (m, B)

    def matvec(self, x):
        c = (self.v * x[None]).reshape(self.m, x.shape[0], -1).sum(-1)
        c = c * self._live()
        return x + (self.u * c.reshape(c.shape + (1,) * (x.ndim - 1))).sum(0)

    def rmatvec(self, x):
        c = (self.u * x[None]).reshape(self.m, x.shape[0], -1).sum(-1)
        c = c * self._live()
        return x + (self.v * c.reshape(c.shape + (1,) * (x.ndim - 1))).sum(0)

    def append(self, a, b, upd):
        slot = self.count % self.m
        rows = torch.arange(a.shape[0], device=a.device)
        keep_u, keep_v = self.u[slot, rows], self.v[slot, rows]
        self.u[slot, rows] = torch.where(_ex(upd, a), a, keep_u)
        self.v[slot, rows] = torch.where(_ex(upd, b), b, keep_v)
        self.count = self.count + upd.long()


def broyden(g, z0, max_steps: int, tol: float, memory: int,
            eps: float = 1e-8):
    """Solve ``g(z) = 0`` row by row; returns ``(best z, H, iterations)``."""
    z = z0.float()
    H = Ring(memory, z)
    gz = g(z)
    res = _bnorm(gz)
    thresh = tol * _bnorm(z).clamp(min=1.0)
    conv = res < thresh
    best_z, best_res = z, res
    k = 0
    while k < max_steps and not bool(conv.all()):
        active = ~conv
        p = -H.matvec(gz)
        z_new = torch.where(_ex(active, z), z + p, z)
        g_new = torch.where(_ex(active, z), g(z_new), gz)
        s, y = z_new - z, g_new - gz
        hy = H.matvec(y)
        b = H.rmatvec(s)
        den = _bdot(b, y)
        upd = active & (den.abs() > eps)
        den = torch.where(den.abs() > eps, den, torch.ones_like(den))
        H.append((s - hy) / _ex(den, s), b, upd)
        res = _bnorm(g_new)
        better = res < best_res
        best_z = torch.where(_ex(better, z), z_new, best_z)
        best_res = torch.minimum(res, best_res)
        conv = conv | (res < thresh)
        z, gz = z_new, g_new
        k += 1
    return best_z, H, k


# ---------------------------------------------------------------------------
# AdamW as the configuration's trainer runs it
# ---------------------------------------------------------------------------


def train_follow(ref: Ref, params: dict, batches: list, train: dict,
                 initial_leaf, store_dtype=torch.bfloat16,
                 first_grad=None, follow=None) -> dict:
    """AdamW steps over ``batches`` from ``params`` (float32 copies of the
    drawn weights, updated in place), as the configuration's trainer runs
    them: the clipped gradient, bias-corrected moments, decoupled decay of
    every leaf of two or more dims, the warmup's learning rate, and the
    stored parameters rounded to ``store_dtype``.  Returns per-step losses
    (and solve iterations), the first step's clipped gradient norm of every
    leaf, and every leaf's change after the last step, against
    ``initial_leaf(name)`` (the drawn leaf, made again).  ``first_grad``
    (optional) is called with the leaves' names and the first step's
    clipped gradient, leaf for leaf, before the update.  ``follow``
    (optional): each step's count of solve iterations for the DEQ, the
    other side's, run without a stop test."""
    set_plain_precision()
    names = tree.leaf_names(params)
    p = tree.leaves(params)
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    b1, b2, eps = 0.9, 0.95, 1e-8
    out = {"loss": [], "iters": [], "gnorm": []}
    z_carry = None
    for step, batch in enumerate(batches):
        if "deq_blocks" in params:
            loss, grads, z_carry, n = ref.deq_loss_grads(
                params, batch, train["z_loss"], z_carry,
                None if follow is None else int(round(follow[step])))
            out["iters"].append(n)
            g = tree.leaves(grads)
            del grads
        else:
            for t in p:
                t.requires_grad_(True)
            loss = ref.stack_loss(params, batch, train["z_loss"])
            g = list(torch.autograd.grad(loss, p))
            for t in p:
                t.requires_grad_(False)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((t * t).sum() for t in g))
            out["gnorm"].append(float(gnorm))
            scale = torch.clamp(train["clip_norm"] / gnorm.clamp(min=1e-12),
                                max=1.0)
            for t in g:
                t.mul_(scale)
            if step == 0:
                out["grad_norms"] = dict(zip(names, [
                    float(torch.linalg.vector_norm(t)) for t in g]))
                if first_grad is not None:
                    first_grad(names, g)
            lr = train["lr"] * min((step + 1) / max(train["warmup_steps"], 1),
                                   1.0)
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for i, (pt, gt) in enumerate(zip(p, g)):
                m[i].mul_(b1).add_((1 - b1) * gt)
                v[i].mul_(b2).add_((1 - b2) * gt * gt)
                delta = (m[i] / c1) / (torch.sqrt(v[i] / c2) + eps)
                if pt.ndim >= 2:
                    delta = delta + train["weight_decay"] * pt
                pt.copy_((pt - lr * delta).to(store_dtype).float())
            del g
    del m, v
    with torch.no_grad():
        out["change_norms"] = {
            n: float(torch.linalg.vector_norm(t - initial_leaf(n).float()))
            for n, t in zip(names, p)}
    return out

