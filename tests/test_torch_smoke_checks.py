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
