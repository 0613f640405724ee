"""Wrappers of the Hopper attention kernels (``csrc/flash_attention.cu``).

``flash_attention`` replaces ``flash_attention_pallas`` and
``decode_attention`` replaces ``decode_attention_pallas``
(``repro/kernels/flash_attention.py``).  In bf16, prefill is the
tensor-core kernel and decode a split-K pair of launches (a split launch
over ``ceil(T / DECODE_CHUNK)`` key chunks that writes f32 partials into a
scratch allocated here, then a combine launch); the op is counted once.
Float32 takes the FMA kernel, decode one query row per block.  Each wrapper
checks device, dtype, shape, contiguity and (bf16) 16-byte alignment,
allocates the output (and the scratch), launches on the current stream,
raises on a launch error and bumps its own launch count.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, launches

HEAD_DIMS = (16, 64, 80, 96, 128, 192)  # instantiated in csrc/flash_attention.cu
DECODE_CHUNK = 128    # keys per split CTA: kDecodeChunk in the source
_DTYPES = (torch.float32, torch.bfloat16)


def _launch(q, k, v, kv_length, *, causal: bool, scale,
            decode: int) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention kernel takes CUDA tensors")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd or t < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or kvh < 1 or h % kvh:
        raise ValueError(f"head_dim {hd} / heads {h}/{kvh} not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("bf16 q/k/v must be 16-byte aligned (16-byte copies)")
    lens = None
    if kv_length is not None:
        lens = torch.as_tensor(kv_length, dtype=torch.int32,
                               device=q.device).contiguous()
        if tuple(lens.shape) != (b,):
            raise ValueError(f"kv_length must be ({b},)")
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    partial = None
    if decode == 2 and not bf16:
        raise ValueError("decode partials take bfloat16 q/k/v")
    if decode and bf16:
        n_chunks = -(-t // DECODE_CHUNK)
        partial = torch.empty((b, h, n_chunks, hd + 2), dtype=torch.float32,
                              device=q.device)
    err = build.library("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), b, s, t, h, kvh, hd,
        scale, int(causal), int(decode), int(bf16), DECODE_CHUNK,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    return partial if decode == 2 else out


def flash_attention(q, k, v, kv_length=None, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q ``(B, S, H, hd)``, k/v ``(B, T, KV, hd)`` -> ``(B, S, H, hd)``;
    under ``causal`` query row s sees keys 0..s (the rows aligned to the
    first key, as the plain version at ``q_offset=0``).  Causal with more
    keys than queries raises: the JAX package's Pallas kernel aligns such
    queries to the last keys, its plain version to the first, and no
    ported path reaches the case."""
    if causal and k.shape[1] > q.shape[1]:
        raise ValueError(f"causal attention with T={k.shape[1]} > "
                         f"S={q.shape[1]}: the kernel aligns query row 0 to "
                         f"key 0 (the plain version at q_offset=0), the "
                         f"reference's Pallas kernel to key T - S")
    out = _launch(q, k, v, kv_length, causal=causal, scale=scale,
                  decode=0)
    launches.bump("flash_attention")
    return out


def decode_attention(q, k, v, kv_length, *,
                     scale: float | None = None) -> torch.Tensor:
    """One new token per row: q ``(B, H, hd)`` over the cache k/v
    ``(B, T, KV, hd)`` with ``kv_length`` valid entries.  In bf16 two
    launches (split, combine), counted once."""
    out = _launch(q[:, None], k, v, kv_length, causal=False, scale=scale,
                  decode=1)
    launches.bump("decode_attention")
    return out[:, 0]


def decode_partials(q, k, v, kv_length, *,
                    scale: float | None = None) -> torch.Tensor:
    """The split launch alone (bf16): ``(B, H, ceil(T / DECODE_CHUNK), hd +
    2)`` f32 partials ``(m, l, acc)`` of q ``(B, H, hd)`` over this rank's
    slice of a cache; ``kv_length`` 0 leaves every chunk of a row empty
    (``l = 0``).  Counted as one ``decode_attention``."""
    part = _launch(q[:, None], k, v, kv_length, causal=False, scale=scale,
                   decode=2)
    launches.bump("decode_attention")
    return part


def decode_combine(partials: torch.Tensor, dtype) -> torch.Tensor:
    """The combine launch alone: ``(B, H, n, hd + 2)`` f32 partials (from
    any number of slices) -> ``(B, H, hd)`` bf16."""
    if dtype != torch.bfloat16 or partials.dtype != torch.float32:
        raise ValueError("the decode combine writes bfloat16 from f32 "
                         "partials")
    if not (partials.is_cuda and partials.is_contiguous()):
        raise ValueError("decode partials must be contiguous CUDA tensors")
    b, h, n, ps = partials.shape
    out = torch.empty((b, h, ps - 2), dtype=dtype, device=partials.device)
    err = build.library("flash_attention").decode_combine_launch(
        partials.data_ptr(), out.data_ptr(), b, h, n, ps - 2,
        torch.cuda.current_stream(partials.device).cuda_stream)
    build.check(err, "flash_attention")
    return out
