"""Wrappers of the Hopper attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` replaces ``flash_attention_pallas`` and
``decode_attention`` replaces ``decode_attention_pallas``
(``repro/kernels/flash_attention.py``): as there, decode is the same kernel
launched one query row per block.  Each wrapper checks device, dtype, shape
and contiguity, allocates the output, launches on the current stream,
raises on a launch error and bumps its own launch count.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, launches

HEAD_DIMS = (16, 64)  # instantiated in csrc/flash_attention.cu
_DTYPES = (torch.float32, torch.bfloat16)


def _launch(q, k, v, kv_length, *, causal: bool, scale,
            decode: bool) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention kernel takes CUDA tensors")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or kvh < 1 or h % kvh:
        raise ValueError(f"head_dim {hd} / heads {h}/{kvh} not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    lens = None
    if kv_length is not None:
        lens = torch.as_tensor(kv_length, dtype=torch.int32,
                               device=q.device).contiguous()
        if tuple(lens.shape) != (b,):
            raise ValueError(f"kv_length must be ({b},)")
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    err = build.library("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(), b, s, t, h,
        kvh, hd, scale, int(causal), int(decode),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    return out


def flash_attention(q, k, v, kv_length=None, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q ``(B, S, H, hd)``, k/v ``(B, T, KV, hd)`` -> ``(B, S, H, hd)``;
    under ``causal`` query row s sees keys 0..s."""
    out = _launch(q, k, v, kv_length, causal=causal, scale=scale,
                  decode=False)
    launches.bump("flash_attention")
    return out


def decode_attention(q, k, v, kv_length, *,
                     scale: float | None = None) -> torch.Tensor:
    """One new token per row: q ``(B, H, hd)`` over the cache k/v
    ``(B, T, KV, hd)`` with ``kv_length`` valid entries."""
    out = _launch(q[:, None], k, v, kv_length, causal=False, scale=scale,
                  decode=True)
    launches.bump("decode_attention")
    return out[:, 0]
