"""Chunked attention in plain PyTorch, with a tiled flash backward.

The port of ``repro/kernels/flash_xla.py`` (``flash_attention_xla``): the
attention path whose working set is one ``(block_q, block_kv)`` tile of
scores, never the whole ``S x T`` matrix.  The dense plain version
(``ref.attention_ref``) and the backward of the kernel wrapper
(``ops._Attention``, a dense recompute like the reference's VJP)
materialise ``S x T`` f32 scores per head; this path holds a tile:

  * forward: for each query tile, an online softmax over the key tiles
    (running max ``m``, denominator ``l`` and f32 accumulator), tiles
    wholly above the causal diagonal skipped; saves ``out`` and the
    log-sum-exp of the scaled scores;
  * backward: the flash backward, tile by tile: ``p`` recomputed from the
    saved log-sum-exp, ``D = rowsum(dout * out)``, one f32 ``dq``
    accumulator per query tile and f32 ``dk``/``dv`` over the keys.

GQA stays grouped: queries are viewed as ``(B, S, KV, G, hd)`` and
contracted group by group, K/V are never repeated.  Precision follows the
reference: operands in their own dtype (cast to f32 here, which is exact
for bf16 products), f32 accumulation, the probabilities rounded to the
value dtype before the ``p @ v`` product and ``ds`` to the query dtype
before the ``dq``/``dk`` products.  Keys are zero-padded to whole key tiles
and masked, so a row with no visible key averages the padded key axis as
the reference's does.

``unroll`` selects the shape of the reference's HLO (a Python loop of
tiles against a ``lax.scan``); in eager PyTorch every tile is a loop step
either way, so it is accepted and changes nothing.  Causal tiles above the
diagonal are skipped in both modes (the reference's scan computes and
masks them, which adds ``exp(-1e30 - m) = 0`` to every visible row).

This is no kernel of the TPU package (it reaches no ``pl.pallas_call``):
plain PyTorch is its port, on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def _causal_skip(i: int, j: int, block_q: int, block_kv: int,
                 q_offset: int) -> bool:
    """True when tile ``(i, j)`` lies wholly above the causal diagonal."""
    return j * block_kv > i * block_q + block_q - 1 + q_offset


def _tile_mask(qpos, kpos, causal: bool, kv_length, t_valid: int):
    """``(B or 1, 1, 1, bq, bkv)`` validity of one tile's scores; ``qpos``
    carries the ``q_offset``."""
    m = (kpos[None, :] < t_valid).expand(qpos.shape[0], -1)
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    m = m[None, None, None]
    if kv_length is not None:
        m = m & (kpos[None, None, None, None, :]
                 < kv_length.reshape(-1, 1, 1, 1, 1))
    return m


def _tiles(n: int, block: int):
    return [(i, i * block, min(n, (i + 1) * block))
            for i in range(-(-n // block))]


def _scores(qi, kb, mask, scale):
    """Scaled, masked f32 scores ``(B, KV, G, bq, bkv)`` of one tile."""
    sc = torch.einsum("bqkgd,btkd->bkgqt", qi.float(), kb.float()) * scale
    return torch.where(mask, sc, torch.full_like(sc, _NEG_INF))


def _flash_fwd(q, k, v, kv_length, causal, q_offset, scale, bq, bkv, t):
    """``k``/``v`` padded to whole key tiles; ``t`` the real key count."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    out = torch.empty((b, kvh, g, s, hd), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((b, kvh, g, s), dtype=torch.float32, device=q.device)
    for i, q0, q1 in _tiles(s, bq):
        qi = qg[:, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device) + q_offset
        m = torch.full((b, kvh, g, q1 - q0), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, q1 - q0, hd), dtype=torch.float32,
                          device=q.device)
        for j, k0, k1 in _tiles(k.shape[1], bkv):
            if causal and _causal_skip(i, j, bq, bkv, q_offset):
                continue
            kpos = torch.arange(k0, k1, device=q.device)
            sc = _scores(qi, k[:, k0:k1], _tile_mask(
                qpos, kpos, causal, kv_length, t), scale)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
                v[:, k0:k1].float())
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp(l, min=1e-30)[..., None]
        lse[:, :, :, q0:q1] = m + torch.log(torch.clamp(l, min=1e-30))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, kv_length, dout, causal, q_offset, scale,
               bq, bkv, t):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    dog = dout.reshape(b, s, kvh, g, hd)
    # D_i = rowsum(dout * out): (B, S, KV, G), f32
    delta = (dog.float() * out.reshape(b, s, kvh, g, hd).float()).sum(-1)
    dq = torch.zeros((b, s, kvh, g, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i, q0, q1 in _tiles(s, bq):
        qi, doi = qg[:, q0:q1], dog[:, q0:q1]
        di = delta[:, q0:q1].permute(0, 2, 3, 1)          # (B, KV, G, bq)
        lsei = lse[:, :, :, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device) + q_offset
        dq_i = torch.zeros((b, q1 - q0, kvh, g, hd), dtype=torch.float32,
                           device=q.device)
        for j, k0, k1 in _tiles(k.shape[1], bkv):
            if causal and _causal_skip(i, j, bq, bkv, q_offset):
                continue
            kb, vb = k[:, k0:k1], v[:, k0:k1]
            kpos = torch.arange(k0, k1, device=q.device)
            sc = _scores(qi, kb, _tile_mask(qpos, kpos, causal, kv_length,
                                            t), scale)
            p = torch.exp(sc - lsei[..., None])
            dv[:, k0:k1] += torch.einsum("bkgqt,bqkgd->btkd",
                                         p.to(vb.dtype).float(), doi.float())
            dp = torch.einsum("bqkgd,btkd->bkgqt", doi.float(), vb.float())
            ds = (p * (dp - di[..., None])).to(q.dtype).float()
            dq_i += torch.einsum("bkgqt,btkd->bqkgd", ds, kb.float()) * scale
            dk[:, k0:k1] += torch.einsum("bkgqt,bqkgd->btkd", ds,
                                         qi.float()) * scale
        dq[:, q0:q1] = dq_i
    return dq.reshape(b, s, h, hd).to(q.dtype), dk, dv


class _Flash(torch.autograd.Function):
    """Forward ``_flash_fwd``, backward ``_flash_bwd`` from the saved
    ``out`` and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, kv_length, causal, q_offset, scale, bq, bkv):
        t = k.shape[1]
        pad = -(-t // bkv) * bkv - t
        kp = F.pad(k, (0, 0, 0, 0, 0, pad)) if pad else k
        vp = F.pad(v, (0, 0, 0, 0, 0, pad)) if pad else v
        out, lse = _flash_fwd(q, kp, vp, kv_length, causal, q_offset, scale,
                              bq, bkv, t)
        ctx.save_for_backward(q, kp, vp, out, lse, kv_length)
        ctx.args = (causal, q_offset, scale, bq, bkv, t)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kp, vp, out, lse, kv_length = ctx.saved_tensors
        causal, q_offset, scale, bq, bkv, t = ctx.args
        dq, dk, dv = _flash_bwd(q, kp, vp, out, lse, kv_length, dout,
                                causal, q_offset, scale, bq, bkv, t)
        return (dq, dk[:, :t].to(kp.dtype), dv[:, :t].to(vp.dtype), None,
                None, None, None, None, None)


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_length: torch.Tensor | None = None,
                        q_offset: int = 0, scale: float | None = None,
                        block_q: int = 512, block_kv: int = 1024,
                        unroll: bool = False) -> torch.Tensor:
    """Tiled online-softmax attention ``(B, S, H, hd) x (B, T, KV, hd) ->
    (B, S, H, hd)`` with a tiled flash backward.  ``q_offset`` places
    ``q[:, 0]`` on the key axis for the causal mask; ``kv_length (B,)``
    masks keys past each row's length; ``unroll`` is accepted for the
    reference's signature and changes nothing (module docstring)."""
    del unroll
    b, s, h, hd = q.shape
    scale = (hd ** -0.5) if scale is None else float(scale)
    block_q = min(block_q, max(s, 1))
    block_kv = min(block_kv, max(k.shape[1], 1))
    if kv_length is not None:
        kv_length = torch.as_tensor(kv_length, device=q.device).reshape(b)
    return _Flash.apply(q, k, v, kv_length, causal, int(q_offset), scale,
                        block_q, block_kv)
