"""``chip_smoke.py``'s kernel checks, on the CPU.

The chip smoke run holds ``broyden_step``'s seven outputs and
``lowrank_append``'s four against the plain version: the evicted rows and
every unwritten ring row bit for bit, each written slot row at the bf16
tolerance.  It holds the SHINE backward's ``qn_apply_multi`` with
``(True,)`` at the row tolerance, and the gradients of the attention and
rmsnorm autograd wrappers against plain autograd.  Here the plain version
stands in for the kernel: it must pass, and each wrong answer a kernel
could give must fail.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

EPS = 1e-8


def _case():
    gen = torch.Generator().manual_seed(0)
    m, bsz, dim = 8, 4, 1030
    u = (0.3 * torch.randn(m, bsz, dim, generator=gen)).bfloat16()
    v = (0.3 * torch.randn(m, bsz, dim, generator=gen)).bfloat16()
    count = torch.tensor([m + 3, 3, 5, 0], dtype=torch.int32)
    mask = (torch.arange(m)[:, None]
            < torch.clamp(count, max=m)[None, :]).float()
    g = torch.randn(bsz, dim, generator=gen)
    s = 0.1 * torch.randn(bsz, dim, generator=gen)
    hg = torch.randn(bsz, dim, generator=gen)
    slot = (count % m).int()
    active = torch.tensor([True, True, False, True])
    args = (g, s, hg, torch.tensor(1.0), mask, slot, active, EPS)
    want = ref.broyden_step_ref(u, v, *args)
    got = ref.broyden_step_ref(u.clone(), v.clone(), *args)
    return u, v, slot, active, got, want


def _wrong_slot(u, slot, want, active):
    out = u.clone()
    for b in range(u.shape[1]):
        if active[b] and want[4][b].abs() > EPS:
            out[(slot[b] + 1) % u.shape[0], b] = want[0][slot[b], b]
    return out


def _scaled_slot_row(t, slot):
    t = t.clone()
    t[slot[0], 0] = (t[slot[0], 0].float() * 1.03).bfloat16()
    return t


def _moved_entry(t, slot):
    t = t.clone()
    t[(slot[1] + 2) % t.shape[0], 1, 5] += 0.05
    return t


MUTANTS = {
    "ev_u_zero": (5, lambda t, u, v, s, w, a: torch.zeros_like(t)),
    "ev_v_wrong_slot": (6, lambda t, u, v, s, w, a: v[(s.long() + 1) % 8,
                                                      torch.arange(4)]),
    "row_in_wrong_slot": (0, lambda t, u, v, s, w, a: _wrong_slot(u, s, w,
                                                                  a)),
    "slot_row_off_3pct": (0, lambda t, u, v, s, w, a: _scaled_slot_row(t, s)),
    "unwritten_entry_moved": (1, lambda t, u, v, s, w, a: _moved_entry(t, s)),
    "hg_new_off_1pct": (2, lambda t, u, v, s, w, a: t * 1.01),
    "den_off_1pct": (4, lambda t, u, v, s, w, a: t * 1.01),
}


def test_broyden_step_check_passes_the_plain_version():
    u, v, slot, active, got, want = _case()
    err = chip_smoke.check_broyden_step("broyden_step", got, want, u, v,
                                        slot, active, EPS)
    assert err == 0.0


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_broyden_step_check_rejects_a_wrong_kernel(mutant):
    u, v, slot, active, got, want = _case()
    idx, fn = MUTANTS[mutant]
    bad = list(got)
    bad[idx] = fn(bad[idx], u, v, slot, want, active)
    with pytest.raises(AssertionError):
        chip_smoke.check_broyden_step("broyden_step", bad, want, u, v, slot,
                                      active, EPS)


def _append_case():
    gen = torch.Generator().manual_seed(1)
    m, bsz, dim = 8, 4, 1030
    u = (0.3 * torch.randn(m, bsz, dim, generator=gen)).bfloat16()
    v = (0.3 * torch.randn(m, bsz, dim, generator=gen)).bfloat16()
    s, hy, b = (torch.randn(bsz, dim, generator=gen) for _ in range(3))
    inv_den = torch.randn(bsz, generator=gen)
    slot = torch.tensor([3, 0, 5, 7], dtype=torch.int32)
    upd = torch.tensor([1.0, 1.0, 0.0, 1.0])
    args = (s, hy, b, inv_den, slot, upd)
    want = ref.lowrank_append_ref(u, v, *args)
    got = ref.lowrank_append_ref(u.clone(), v.clone(), *args)
    return u, v, slot, upd, got, want


APPEND_MUTANTS = {
    "ev_u_zero": (2, lambda t, u, s: torch.zeros_like(t)),
    "ev_v_wrong_slot": (3, lambda t, u, s: t.roll(1, dims=0)),
    "slot_row_off_3pct": (0, lambda t, u, s: _scaled_slot_row(t, s)),
    "unwritten_entry_moved": (1, lambda t, u, s: _moved_entry(t, s)),
    "refused_row_written": (0, lambda t, u, s: _write_refused(t, s)),
}


def _write_refused(t, slot):
    t = t.clone()
    t[slot[2], 2] = t[slot[0], 0]  # row 2's append is refused (upd = 0)
    return t


def test_lowrank_append_check_passes_the_plain_version():
    u, v, slot, upd, got, want = _append_case()
    assert chip_smoke.check_lowrank_append("lowrank_append", got, want, u,
                                           v, slot, upd) == 0.0


@pytest.mark.parametrize("mutant", sorted(APPEND_MUTANTS))
def test_lowrank_append_check_rejects_a_wrong_kernel(mutant):
    u, v, slot, upd, got, want = _append_case()
    idx, fn = APPEND_MUTANTS[mutant]
    bad = list(got)
    bad[idx] = fn(bad[idx], u, slot)
    with pytest.raises(AssertionError):
        chip_smoke.check_lowrank_append("lowrank_append", bad, want, u, v,
                                        slot, upd)


def test_transposed_apply_check_rejects_h_for_h_transpose():
    u, v, slot, active, _, _ = _case()
    mask = torch.ones(u.shape[:2])
    x = torch.randn((1,) + u.shape[1:], generator=torch.Generator()
                    .manual_seed(2))
    want = ref.qn_apply_multi_ref(u, v, x, torch.tensor(1.0), mask, (True,))
    got = ref.qn_apply_multi_ref(u, v, x, torch.tensor(1.0), mask, (False,))
    chip_smoke.check_close("H^T x", want, want,
                           chip_smoke.row_tol(want, 1e-3, 1e-4))
    with pytest.raises(AssertionError):
        chip_smoke.check_close("H^T x", got, want,
                               chip_smoke.row_tol(want, 1e-3, 1e-4))


@pytest.mark.parametrize("wrong", ["zero", "swapped", "scaled_5pct"])
def test_gradient_check_rejects_a_wrong_backward(wrong):
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn(2, 9, 2, 16, generator=gen).bfloat16()
                  for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*leaves, causal=True),
                               leaves, g)
    assert chip_smoke.check_grads("attention", want, want) == 0.0
    bad = {"zero": [torch.zeros_like(want[0]), want[1], want[2]],
           "swapped": [want[0], want[2], want[1]],
           "scaled_5pct": [want[0], want[1], (want[2].float() * 1.05)
                           .bfloat16()]}[wrong]
    with pytest.raises(AssertionError):
        chip_smoke.check_grads("attention", bad, want)


# ---------------------------------------------------------------------------
# the attention check: each wrong answer an attention kernel could give
# ---------------------------------------------------------------------------

CHUNK = 16  # keys per split chunk of the plain split-K decode below


def _attention_case():
    gen = torch.Generator().manual_seed(4)
    b, s, h, kv, hd = 3, 24, 4, 2, 16
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).bfloat16()
               for n in (h, kv, kv))
    lens = torch.tensor([24, 5, 0], dtype=torch.int32)  # 0: all masked
    return q, k, v, lens


def _decode_case():
    gen = torch.Generator().manual_seed(5)
    b, h, kv, hd, t = 3, 4, 2, 16, 40
    q = torch.randn(b, h, hd, generator=gen).bfloat16()
    k, v = (torch.randn(b, t, kv, hd, generator=gen).bfloat16()
            for _ in range(2))
    lens = torch.tensor([40, 23, 0], dtype=torch.int32)
    return q, k, v, lens


def _split_decode(q, k, v, lens, *, drop_last_live=False, rescale=True):
    """Split-K decode in plain PyTorch, as the two decode launches do it:
    f32 partials ``(m, l, acc)`` over CHUNK-key chunks of each row's live
    keys (all T keys for kv_length 0, every score then NEG_INF), merged with
    the ``e^(m_c - m*)`` rescale."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    kk, vv = (x.float().repeat_interleave(h // kv, dim=2) for x in (k, v))
    scores = torch.einsum("bhd,bthd->bht", q.float(), kk) * hd ** -0.5
    out = torch.empty(b, h, hd)
    for i in range(b):
        n = int(lens[i])
        limit = min(n, t) if n >= 1 else t
        sc = scores[i] if n >= 1 else torch.full_like(scores[i], ref.NEG_INF)
        parts = []
        for c0 in range(0, limit, CHUNK):
            x = sc[:, c0:min(c0 + CHUNK, limit)]
            m = x.max(-1, keepdim=True).values
            p = torch.exp(x - m)
            parts.append((m, p.sum(-1, keepdim=True), torch.einsum(
                "hl,lhd->hd", p, vv[i, c0:c0 + x.shape[1]])))
        if drop_last_live:
            parts = parts[:-1]
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - mm) if rescale else torch.ones_like(m)
             for m, _, _ in parts]
        out[i] = (sum(wc * acc for wc, (_, _, acc) in zip(w, parts))
                  / sum(wc * lc for wc, (_, lc, _) in zip(w, parts)))
    return out.to(q.dtype)


def _zero_row(out, lens):
    out = out.clone()
    out[lens == 0] = 0
    return out


def _prefill(wrong):
    q, k, v, lens = _attention_case()
    kl = {"causal_dropped": lens,
          "prefill_kv_length_plus_one": torch.clamp(lens + (lens > 0).int(),
                                                    max=k.shape[1])}[wrong]
    got = ref.attention_ref(q, k, v, causal=wrong != "causal_dropped",
                            kv_length=kl)
    want = ref.attention_ref(q, k, v, causal=True, kv_length=lens)
    return got, want, (q, k, v, lens), chip_smoke.TOL_BF16


def _decode(wrong):
    q, k, v, lens = _decode_case()
    want = ref.decode_attention_ref(q, k, v, lens)
    got = {"decode_drops_last_live_chunk": lambda: _split_decode(
               q, k, v, lens, drop_last_live=True),
           "merge_without_rescale": lambda: _split_decode(
               q, k, v, lens, rescale=False),
           "kv_length_0_row_zeros": lambda: _zero_row(want, lens)}[wrong]()
    return got, want, (q, k, v, lens), chip_smoke.TOL_DECODE


ATTENTION_MUTANTS = {
    "causal_dropped": _prefill,
    "prefill_kv_length_plus_one": _prefill,
    "decode_drops_last_live_chunk": _decode,
    "merge_without_rescale": _decode,
    "kv_length_0_row_zeros": _decode,
}


@pytest.mark.parametrize("path", ["prefill", "decode"])
def test_attention_check_passes_the_plain_versions(path):
    if path == "prefill":
        q, k, v, lens = _attention_case()
        want = ref.attention_ref(q, k, v, causal=True, kv_length=lens)
        got, tol = want.clone(), chip_smoke.TOL_BF16
    else:  # the split-K merge, done right, against the one-pass plain version
        q, k, v, lens = _decode_case()
        want = ref.decode_attention_ref(q, k, v, lens)
        got, tol = _split_decode(q, k, v, lens), chip_smoke.TOL_DECODE
    chip_smoke.check_attention(path, got, want, q, k, v, lens, tol)


@pytest.mark.parametrize("wrong", sorted(ATTENTION_MUTANTS))
def test_attention_check_rejects_a_wrong_kernel(wrong):
    got, want, (q, k, v, lens), tol = ATTENTION_MUTANTS[wrong](wrong)
    with pytest.raises(AssertionError):
        chip_smoke.check_attention(wrong, got, want, q, k, v, lens, tol)
