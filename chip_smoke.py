"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # needs one CUDA card

Phases, one line (or a few) each:
  1. environment: torch/CUDA versions, the card's name and power limit
     (``nvidia-smi``), and the build of every kernel from the checkout's
     sources (one ``nvcc`` per CUDA source, started together, while Triton
     compiles the rmsnorm kernel);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it (qN ring m=8, B=4, D=S*2304 for
     S in {1, 256}, bf16; attention B=4, S=256, 36 heads x 64, plus a GQA
     and a ragged case; decode over a 1024-token cache with mixed lengths;
     rmsnorm 1024 x 2304): max error against the stated tolerance and the
     kernel, plain and library times (CUDA events);
  3. an end-to-end check at a small size: the smoke config in f32 served on
     the card (kernels) and on the CPU (plain versions) must emit the same
     tokens with matching logits;
  4. serving at the full width of MiniCPM-2B (DEQ, random weights with the
     weight-tied blocks scaled by 0.3): 8 requests, 4 slots, prompts of 128
     and 256 tokens, 16 new tokens each, a 1024-token cache -- through
     ``ServeLoop``, with the kernel launch counts reset just before and
     read just after; every kernel of the path must have launched;
  5. a profiled window at full width (torch.profiler: device busy time,
     idle share, top kernels) for one prefill tick and one decode tick;
  6. a ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line.  It imports nothing of JAX; it needs the repository's ``src/`` beside
it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import build, launches, ref  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels import qn_apply as cuda_qn  # noqa: E402
from repro_torch.kernels import rmsnorm as triton_rms  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.serving import Request, ServeLoop, serve_summary  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# kernel -> (route, source, TPU kernel it replaces)
KERNELS = {
    "broyden_step": ("cuda", "src/repro_torch/csrc/qn_apply.cu",
                     "src/repro/kernels/qn_apply.py:481"),
    "qn_apply_multi": ("cuda", "src/repro_torch/csrc/qn_apply.cu",
                       "src/repro/kernels/qn_apply.py:244"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:95"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:160"),
    "rmsnorm": ("triton", "src/repro_torch/csrc/rmsnorm_triton.py",
                "src/repro/kernels/rmsnorm.py:26"),
}

# tolerances, applied elementwise as |got - want| <= atol + rtol * |want|:
# f32 outputs accumulate in another order than the plain version (the qN
# outputs, sums of ~1e6 products that may cancel, take an atol scaled to
# each row's largest entry: row_tol); bf16
# outputs may differ by a bf16 rounding (2^-8 relative) of the output, and
# prefill attention also by the plain version's bf16 rounding of the
# probabilities (up to ~1.6e-2 at outputs near 0, over values up to ~4).
# Decode outputs are averages over >= 129 keys (|out| <= ~0.5), so decode
# takes a small atol: one key let in past kv_length moves them by ~1e-1,
# which phase 2 checks that the tolerance sees.
TOL_F32 = dict(rtol=1e-3, atol=1e-3)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
TOL_DECODE = dict(rtol=2e-2, atol=5e-3)


def say(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the summed self time of every kernel ``fn``
    launches, from torch.profiler, over ``iters`` calls (excludes the
    wrapper's host work, which CUDA-event timing of back-to-back calls
    includes when the host is slower than the kernel)."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / 1e3 / iters


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def excess(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """Largest ``|got - want| - (atol + rtol * |want|)``: > 0 is a miss."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - (tol["atol"] + tol["rtol"] * w.abs())
            ).max().item()


def row_tol(want: torch.Tensor, rtol: float, rel_atol: float) -> dict:
    """``rtol`` plus an atol of ``rel_atol`` times each row's largest
    entry: a sum of many products carries a rounding error in proportion
    to its terms, which a cancelling entry does not show."""
    return dict(rtol=rtol,
                atol=rel_atol * want.float().abs().amax(-1, keepdim=True))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                tol: dict) -> float:
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs().max().item()
    if excess(g, w, tol) > 0:
        atol = float(torch.as_tensor(tol["atol"]).max())
        raise AssertionError(f"{name}: max |err| {err:.3e} exceeds "
                             f"rtol {tol['rtol']}, atol (max) {atol:.3e}")
    return err


def check_broyden_step(name: str, got, want, u, v, slot, active,
                       eps: float) -> float:
    """Hold ``broyden_step``'s outputs against the plain version's.  The
    evicted rows and every ring row the step does not write are copies, so
    they must be equal bit for bit; each written slot row holds at the
    bf16 tolerance with atol scaled to its own largest entry; ``hg_new``
    and ``b`` at rtol 1e-3 with atol 1e-4 of each row's largest entry, and
    ``den`` at the f32 tolerance.  ``u``/``v`` are the ring before the
    step."""
    new_u, new_v, hg, b, den, ev_u, ev_v = got
    w_u, w_v, w_hg, w_b, w_den, w_evu, w_evv = want
    rows = torch.arange(u.shape[1], device=u.device)
    for nm, g_ev, w_ev, ring in (("ev_u", ev_u, w_evu, u),
                                 ("ev_v", ev_v, w_evv, v)):
        old = ring[slot.long(), rows]
        if not (torch.equal(g_ev, w_ev) and torch.equal(g_ev, old)):
            raise AssertionError(f"{name}.{nm}: not the old slot rows")
    hot = torch.zeros(u.shape[:2], dtype=torch.bool, device=u.device)
    hot[slot.long(), rows] = active & (w_den.abs() > eps)
    if not hot.any():
        raise AssertionError(f"{name}: the inputs write no ring row")
    err = 0.0
    for nm, g_r, w_r, ring in (("new_u", new_u, w_u, u),
                               ("new_v", new_v, w_v, v)):
        if not (torch.equal(g_r[~hot], ring[~hot])
                and torch.equal(w_r[~hot], ring[~hot])):
            raise AssertionError(f"{name}.{nm}: a row the step does not "
                                 "write changed")
        w_hot = w_r[hot]
        err = max(err, check_close(f"{name}.{nm}[slot]", g_r[hot], w_hot,
                                   row_tol(w_hot, 2e-2, 2e-3)))
    for nm, g_o, w_o in (("hg_new", hg, w_hg), ("b", b, w_b)):
        err = max(err, check_close(f"{name}.{nm}", g_o, w_o,
                                   row_tol(w_o, 1e-3, 1e-4)))
    err = max(err, check_close(f"{name}.den", den, w_den, TOL_F32))
    return err


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------


def phase_env() -> dict:
    smi = nvidia_smi_line()
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(build.build_all)
        # Triton compiles the rmsnorm kernel meanwhile (first launch)
        x = torch.randn(8, 2304, device="cuda", dtype=torch.bfloat16)
        triton_rms.rmsnorm(x, torch.ones(2304, device="cuda",
                                         dtype=torch.bfloat16))
        torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        report = nvcc.result()
    for name in build.SOURCES:
        build.library(name)
    secs = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln][:6] for n, r in report.items()}
    say("build", seconds=round(secs, 2), triton_seconds=round(t_triton, 2),
        nvcc={n: r["seconds"] for n, r in report.items()}, ptxas=regs)
    return {"nvidia_smi": smi, "build_seconds": secs}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at the path's shapes
# ---------------------------------------------------------------------------


def _ring(m, bsz, dim, gen):
    """A bf16 ring with O(0.3) entries (as tests/test_torch_cuda.py draws
    it): the low-rank term then dominates ``H x`` and the written rows, so
    a wrong coefficient, slot or row falls far outside the tolerance."""
    dev = "cuda"
    u = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)
         ).to(torch.bfloat16)
    v = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)
         ).to(torch.bfloat16)
    count = torch.tensor([m + 3, 3, 5, 0][:bsz], dtype=torch.int32,
                         device=dev)
    mask = (torch.arange(m, device=dev)[:, None]
            < torch.clamp(count, max=m)[None, :]).float()
    return u, v, count, mask


def kernel_qn(seq: int, gen) -> dict:
    m, bsz, d = 8, 4, 2304
    dim = seq * d
    u, v, count, mask = _ring(m, bsz, dim, gen)
    g = torch.randn(bsz, dim, device="cuda", generator=gen)
    s = 0.1 * torch.randn(bsz, dim, device="cuda", generator=gen)
    hg = torch.randn(bsz, dim, device="cuda", generator=gen)
    alpha = torch.tensor(1.0, device="cuda")
    slot = (count % m).int()
    active = torch.tensor([True, True, False, True], device="cuda")
    eps = 1e-8
    want = ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot, active,
                                eps)
    got = cuda_qn.broyden_step(u.clone(), v.clone(), g, s, hg, alpha, mask,
                               slot, active, eps)
    err_b = check_broyden_step(f"broyden_step[S={seq}]", got, want, u, v,
                               slot, active, eps)
    uu, vv = u.clone(), v.clone()
    ms_b = time_ms(lambda: cuda_qn.broyden_step(uu, vv, g, s, hg, alpha,
                                                mask, slot, active, eps))
    dev_b = device_ms(lambda: cuda_qn.broyden_step(uu, vv, g, s, hg, alpha,
                                                   mask, slot, active, eps))
    plain_b = time_ms(lambda: ref.broyden_step_ref(u, v, g, s, hg, alpha,
                                                   mask, slot, active, eps))
    ring = 2 * m * bsz * dim * 2
    n_upd = int((active & (want[4].abs() > eps)).sum())  # slot rows written
    nbytes = (ring + 3 * bsz * dim * 4 + 2 * bsz * dim * 4
              + 2 * bsz * dim * 2 + n_upd * 2 * dim * 2)
    b_ms, b_by = bound(nbytes, 8 * m * bsz * dim, "f32")
    say("kernel", name="broyden_step", shape=f"m={m} B={bsz} D={seq}x{d}",
        max_abs_err=err_b, tol={"ring": "evicted and unwritten rows equal;"
                                " slot rows rtol 2e-2, atol 2e-3 x row max",
                                "hg_new, b": "rtol 1e-3, atol 1e-4 x row max",
                                "den": TOL_F32}, ms=ms_b,
        device_ms=dev_b, plain_ms=plain_b, bound_ms=b_ms, bound_by=b_by)

    xs = g[None]
    want_q = ref.qn_apply_multi_ref(u, v, xs, alpha, mask, (False,))
    got_q = cuda_qn.qn_apply_multi(u, v, xs, alpha, mask, (False,))
    err_q = check_close(f"qn_apply_multi[S={seq}]", got_q, want_q,
                        row_tol(want_q, 1e-3, 1e-4))
    want_q2 = ref.qn_apply_multi_ref(u, v, torch.stack([g, s]), alpha, mask,
                                     (False, True))
    got_q2 = cuda_qn.qn_apply_multi(u, v, torch.stack([g, s]), alpha, mask,
                                    (False, True))
    err_q = max(err_q, check_close(f"qn_apply_multi[S={seq},K=2]", got_q2,
                                   want_q2, row_tol(want_q2, 1e-3, 1e-4)))
    ms_q = time_ms(lambda: cuda_qn.qn_apply_multi(u, v, xs, alpha, mask,
                                                  (False,)))
    dev_q = device_ms(lambda: cuda_qn.qn_apply_multi(u, v, xs, alpha, mask,
                                                     (False,)))
    plain_q = time_ms(lambda: ref.qn_apply_multi_ref(u, v, xs, alpha, mask,
                                                     (False,)))
    q_ms, q_by = bound(ring + 2 * bsz * dim * 4, 4 * m * bsz * dim, "f32")
    say("kernel", name="qn_apply_multi", shape=f"m={m} B={bsz} K=1 "
        f"D={seq}x{d}", max_abs_err=err_q,
        tol="rtol 1e-3, atol 1e-4 x row max", ms=ms_q,
        device_ms=dev_q, plain_ms=plain_q, bound_ms=q_ms, bound_by=q_by)
    return {
        "broyden_step": dict(max_abs_err=err_b, ms=ms_b, device_ms=dev_b,
                             plain_ms=plain_b,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             shape=f"m={m} B={bsz} D={seq}x{d}"),
        "qn_apply_multi": dict(max_abs_err=err_q, ms=ms_q, device_ms=dev_q,
                               plain_ms=plain_q,
                               bound_ms=q_ms, bound_by=q_by, library_ms=None,
                               shape=f"m={m} B={bsz} K=1 D={seq}x{d}"),
    }


def _sdpa(q, k, v, *, causal, mask=None):
    gqa = q.shape[2] != k.shape[2]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal, enable_gqa=gqa).transpose(1, 2)


def kernel_attention(gen) -> dict:
    out = {}
    cases = [("main", 4, 256, 36, 36), ("gqa", 4, 256, 36, 12),
             ("ragged", 3, 197, 36, 36)]
    for tag, bsz, seq, h, kvh in cases:
        hd = 64
        q = torch.randn(bsz, seq, h, hd, device="cuda", generator=gen
                        ).to(torch.bfloat16)
        k = torch.randn(bsz, seq, kvh, hd, device="cuda", generator=gen
                        ).to(torch.bfloat16)
        v = torch.randn(bsz, seq, kvh, hd, device="cuda", generator=gen
                        ).to(torch.bfloat16)
        want = ref.attention_ref(q, k, v, causal=True)
        got = cuda_fa.flash_attention(q, k, v, causal=True)
        err = check_close(f"flash_attention[{tag}]", got, want, TOL_BF16)
        ms = time_ms(lambda: cuda_fa.flash_attention(q, k, v, causal=True))
        dev = device_ms(lambda: cuda_fa.flash_attention(q, k, v,
                                                        causal=True))
        plain = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
        lib = time_ms(lambda: _sdpa(q, k, v, causal=True))
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        flops = 4 * bsz * h * hd * seq * (seq + 1) / 2
        b_ms, b_by = bound(nbytes, flops, "bf16")
        shape = f"B={bsz} S=T={seq} H={h} KV={kvh} hd={hd} causal"
        say("kernel", name="flash_attention", case=tag, shape=shape,
            max_abs_err=err, tol=TOL_BF16, ms=ms, device_ms=dev,
            plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        if tag == "main":
            out["flash_attention"] = dict(
                max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain,
                library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, shape=shape)
        else:
            out["flash_attention"]["max_abs_err"] = max(
                out["flash_attention"]["max_abs_err"], err)

    bsz, h, hd, t = 4, 36, 64, 1024
    lens = torch.tensor([129, 257, 200, 1024], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(bsz, h, hd, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    k = torch.randn(bsz, t, h, hd, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    v = torch.randn(bsz, t, h, hd, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    want = ref.decode_attention_ref(q, k, v, lens)
    got = cuda_fa.decode_attention(q, k, v, lens)
    err = check_close("decode_attention", got, want, TOL_DECODE)
    off_by_one = {}  # the tolerance must see kv_length off by one
    for shift in (1, -1):
        off = ref.decode_attention_ref(q, k, v,
                                       torch.clamp(lens + shift, max=t))
        off_by_one[f"{shift:+d}"] = excess(off, want, TOL_DECODE)
        if off_by_one[f"{shift:+d}"] <= 0:
            raise AssertionError(f"decode_attention: kv_length {shift:+d} "
                                 f"passes {TOL_DECODE}")
    ms = time_ms(lambda: cuda_fa.decode_attention(q, k, v, lens))
    dev = device_ms(lambda: cuda_fa.decode_attention(q, k, v, lens))
    plain = time_ms(lambda: ref.decode_attention_ref(q, k, v, lens))
    amask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]
             )[:, None, None, :]
    lib = time_ms(lambda: _sdpa(q[:, None], k, v, causal=False, mask=amask))
    live = int(lens.sum())
    nbytes = 2 * q.numel() * 2 + 2 * live * h * hd * 2 + bsz * 4
    b_ms, b_by = bound(nbytes, 4 * h * hd * live, "bf16")
    shape = f"B={bsz} H=KV={h} hd={hd} T={t} kv_length={lens.tolist()}"
    say("kernel", name="decode_attention", shape=shape, max_abs_err=err,
        tol=TOL_DECODE, kv_length_off_by_one_excess=off_by_one, ms=ms,
        device_ms=dev, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
        bound_by=b_by)
    out["decode_attention"] = dict(max_abs_err=err, ms=ms, device_ms=dev,
                                   plain_ms=plain,
                                   library_ms=lib, bound_ms=b_ms,
                                   bound_by=b_by, shape=shape)
    return out


def kernel_rmsnorm(gen) -> dict:
    rows, d, eps = 1024, 2304, 1e-5
    x = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
         ).to(torch.bfloat16)
    want = ref.rmsnorm_ref(x, w, eps)
    got = triton_rms.rmsnorm(x, w, eps)
    err = check_close("rmsnorm", got, want, TOL_BF16)
    ms = time_ms(lambda: triton_rms.rmsnorm(x, w, eps))
    dev = device_ms(lambda: triton_rms.rmsnorm(x, w, eps))
    plain = time_ms(lambda: ref.rmsnorm_ref(x, w, eps))
    lib = time_ms(lambda: F.rms_norm(x, (d,), w, eps))
    b_ms, b_by = bound(2 * rows * d * 2 + d * 2, 4 * rows * d, "f32")
    shape = f"rows={rows} D={d} bf16"
    say("kernel", name="rmsnorm", shape=shape, max_abs_err=err,
        tol=TOL_BF16, ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
        bound_ms=b_ms, bound_by=b_by)
    return {"rmsnorm": dict(max_abs_err=err, ms=ms, device_ms=dev,
                            plain_ms=plain,
                            library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                            shape=shape)}


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    decode_qn = kernel_qn(1, gen)   # decode-shaped ring, checked and timed
    res.update(kernel_qn(256, gen))  # prefill-shaped ring: the reported row
    for name, row in decode_qn.items():
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       row["max_abs_err"])
        res[name]["decode_ms"] = row["ms"]
        res[name]["decode_device_ms"] = row["device_ms"]
    res.update(kernel_attention(gen))
    res.update(kernel_rmsnorm(gen))
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# phase 3: end-to-end check at a small size (card vs CPU)
# ---------------------------------------------------------------------------


def _scaled_blocks(params: dict, scale: float) -> dict:
    """Scale the weight-tied blocks (a random init is not contractive at
    scale 1; the JAX package's tests use 0.3)."""
    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else v * scale
                for k, v in p.items()}
    out = dict(params)
    out["deq_blocks"] = walk(params["deq_blocks"])
    return out


def phase_parity() -> None:
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=30, tol=1e-4, memory=16,
                                qn_dtype="float32"))
    cpu_params = _scaled_blocks(lm.init_params(cfg, seed=1, device="cpu"),
                                0.3)
    def to_dev(p):
        return {k: to_dev(v) if isinstance(v, dict) else v.to("cuda")
                for k, v in p.items()}

    gpu_params = to_dev(cpu_params)
    rng = np.random.default_rng(0)
    lens = [5, 9, 5, 12, 9, 5]
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist() for n in lens]
    outs = {}
    for name, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        loop = ServeLoop(params, cfg, slots=2, max_len=32, record=True)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        loop.drain(reqs)
        outs[name] = (reqs, loop)
    (rg, lg), (rc, lc) = outs["cuda"], outs["cpu"]
    toks_g = [r.out for r in rg]
    toks_c = [r.out for r in rc]
    if toks_g != toks_c:
        raise AssertionError(f"card and CPU tokens differ: {toks_g} vs "
                             f"{toks_c}")
    err = max(float(np.abs(a - b).max())
              for uid in lc.recorded_logits
              for a, b in zip(lg.recorded_logits[uid],
                              lc.recorded_logits[uid]))
    scale = max(float(np.abs(b).max()) for v in lc.recorded_logits.values()
                for b in v)
    if err > 1e-3 * max(scale, 1.0):
        raise AssertionError(f"card vs CPU logits differ by {err:.3e} "
                             f"(scale {scale:.3e})")
    say("parity", config="minicpm-2b smoke f32 (d=64, 2 blocks x0.3)",
        requests=len(prompts), tokens_identical=True, max_abs_logit_err=err,
        logit_scale=scale, steps_card=[s["steps"] for s in lg.solve_log],
        steps_cpu=[s["steps"] for s in lc.solve_log])


# ---------------------------------------------------------------------------
# phase 4: serve at the full width of MiniCPM-2B
# ---------------------------------------------------------------------------


def phase_serve(smi: str) -> tuple[dict, dict, object]:
    cfg = get_config("minicpm-2b", deq=True)
    t0 = time.perf_counter()
    params = _scaled_blocks(lm.init_params(cfg, seed=0, device="cuda"), 0.3)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    plens = [128, 256] * 4
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in plens]
    loop = ServeLoop(params, cfg, slots=4, max_len=1024, record=False)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    loop.drain(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches.counts()
    summ = serve_summary(loop, reqs, secs)
    for r in reqs:
        full = len(r.out) == r.max_new_tokens or (
            r.out and r.out[-1] == loop.eos)
        if not full or r.error is not None:
            raise AssertionError(f"request {r.uid}: {len(r.out)} tokens, "
                                 f"error {r.error}")
    say("serve", config="minicpm-2b DEQ (d=2304, 36x64 heads, ff=5760, "
        "vocab 122753, 4 blocks x0.3, bf16, ring bf16 m=8)",
        init_seconds=round(t_init, 2),
        tokens_per_request=[len(r.out) for r in reqs],
        prompt_lens=plens, card=smi, **summ,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    steps = [(s["phase"], s["steps"]) for s in loop.solve_log]
    statuses = sorted({c for s in loop.solve_log for c in s["status"]})
    say("serve_solves", n_solves=len(steps),
        prefill_steps=[s for p, s in steps if p == "prefill"],
        decode_steps=[s for p, s in steps if p == "decode"],
        statuses_seen=statuses)
    say("serve_launches", **counts)
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    return counts, params, cfg


def _profile_window(fn) -> dict:
    """Run ``fn`` under torch.profiler: wall time, device busy time (sum of
    kernel self time on the one stream), idle share and the top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                             e.count) for e in top]}


def phase_profile(params, cfg, smi: str) -> None:
    """A traced window at full width, apart from the measured drain: the
    first tick admits 4 prompts of 256 tokens (one batched prefill) and
    decodes once; the second tick only decodes."""
    rng = np.random.default_rng(1)
    loop = ServeLoop(params, cfg, slots=4, max_len=1024)
    for i in range(4):
        loop.submit(Request(uid=100 + i, max_new_tokens=8,
                            prompt=rng.integers(2, cfg.vocab_size,
                                                size=256).tolist()))
    for tag in ("prefill_tick", "decode_tick"):
        prof = _profile_window(loop.step)
        say("profile", window=tag, card=smi,
            solves=[(s["phase"], s["steps"]) for s in loop.solve_log], **prof)
        loop.solve_log.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = phase_env()
    res = phase_kernels()
    phase_parity()
    counts, params, cfg = phase_serve(env["nvidia_smi"])
    phase_profile(params, cfg, env["nvidia_smi"])
    rows = []
    for name, (route, source, replaces) in KERNELS.items():
        r = res[name]
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "device_ms": r["device_ms"], "shape": r["shape"],
                     **{k: r[k] for k in ("decode_ms", "decode_device_ms")
                        if k in r}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
