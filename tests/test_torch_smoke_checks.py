"""``chip_smoke.py``'s kernel checks, on the CPU.

The chip smoke run holds ``broyden_step``'s seven outputs and
``lowrank_append``'s four against the plain version: the evicted rows and
every unwritten ring row bit for bit, each written slot row at the bf16
tolerance.  It holds the SHINE backward's ``qn_apply_multi`` with
``(True,)`` at the row tolerance, and the gradients of the attention and
rmsnorm autograd wrappers against plain autograd.  Here the plain version
stands in for the kernel: it must pass, and each wrong answer a kernel
could give must fail.  The same holds for the qN library's SASS check
(canned listings) and the training-trajectory check (canned steps, and
the recording and replay of forward solves it rests on, at smoke size),
and the check of a traced train step's phases (canned traces, and two
traced smoke steps on the CPU), the host-wait counter (an implicit read
reported as the sync debug mode reports it, and canned arms with a read
too many or too few) and the spill check (canned ptxas reports).  The
layer-stack train phases' launch counts (``_forward_launches``) are held
against a smoke train step's kernel-op calls, the xLSTM cell check's
output-scaled tolerance directly, and the per-layer cache-leaf check on
the xLSTM smoke model's caches (a prefill then a decode step against a
prefill over one more token; swapped or stale layers must fail).  The
layout phase's checks (``phase_layout``) fail on canned wrong answers: a
parameter tree with one leaf's bytes off the dry-run's count, an achieved
share of 1.2 (or 0) of the card's peak, a peak off the prediction by more
than its tolerance, and a matrix with a failed or a missing cell.
"""

import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.data.pipeline import make_lm_batch_iterator  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import tracing as obs_tracing  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402

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


# ---------------------------------------------------------------------------
# the qN SASS check: 16-byte loads, no local memory, no spills
# ---------------------------------------------------------------------------

_NS, _ARGS = "_ZN12_GLOBAL__N_1", "EvNS_10StreamArgsE"  # mangled symbols
_SYMS = {"qn_kernel<1,8,1,1>": _NS + "9qn_kernelILi1ELi8ELi1ELi1EE" + _ARGS,
         "qn_kernel<1,8,4,1>": _NS + "9qn_kernelILi1ELi8ELi4ELi1EE" + _ARGS,
         "broyden_kernel<1,8,1>": _NS + "14broyden_kernelILi1ELi8ELi1EE"
         + _ARGS}
_BODY = [
    "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
    "        /*0010*/              @!P0 LDGSTS.E.BYPASS.128 [R33], desc[UR10][R22.64] ;",
    "        /*0020*/                   LDGDEPBAR ;",
    "        /*0030*/                   FFMA R4, R5, R6, R4 ;",
    "        /*0040*/                   EXIT ;",
]
_NO_SPILL = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def _sass(body=None, skip=()):
    lines = ["        code for sm_90a"]
    for name, sym in _SYMS.items():
        if name in skip:
            continue
        lines.append(f"                Function : {sym}")
        lines.extend(body if body is not None else _BODY)
    return "\n".join(lines)


def _ptxas(spill=_NO_SPILL):
    return {name: {"spill": spill, "used": "Used 96 registers"}
            for name in _SYMS}


SASS_MUTANTS = {
    "no_16_byte_load": (lambda: _sass([ln.replace(".128", ".64")
                                       for ln in _BODY]), _ptxas),
    "local_memory": (lambda: _sass(_BODY[:3] + [
        "        /*0038*/                   STL [R1], R4 ;"] + _BODY[3:]),
        _ptxas),
    "spills": (_sass, lambda: _ptxas(
        "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads")),
    "kernel_missing": (lambda: _sass(skip=("broyden_kernel<1,8,1>",)),
                       _ptxas),
}


def test_qn_sass_check_passes_wide_loads_without_spills():
    ops = chip_smoke.sass_ops(_sass())
    assert set(ops) == set(_SYMS)  # the symbols parse to the short names
    out = chip_smoke.check_qn_sass(ops, _ptxas())
    assert out["qn_kernel<1,8,1,1>"]["first"].startswith(
        "LDGSTS.E.BYPASS.128")


@pytest.mark.parametrize("wrong", sorted(SASS_MUTANTS))
def test_qn_sass_check_rejects(wrong):
    text, ptxas = SASS_MUTANTS[wrong]
    with pytest.raises(AssertionError):
        chip_smoke.check_qn_sass(chip_smoke.sass_ops(text()), ptxas())


# ---------------------------------------------------------------------------
# the training trajectory check: kernel arm against the plain-attention arm,
# free and with the kernel arm's forward solves replayed
# ---------------------------------------------------------------------------

# (forward steps, loss, grad norm, fallback rows) of four train steps, as an
# H100 run of chip_smoke.py read them: the kernel arm, the plain-attention
# arm (step 2's forward solve does not settle and the two arms pick a
# different best iterate for one row, so its grad norm is 8% apart), and
# the plain-attention arm at the kernel arm's iterates
_KERN = [(12.0, 45.369, 5.8328, 0.0), (12.0, 42.320, 46.521, 3.0),
         (12.0, 17.889, 56.291, 0.0), (12.0, 12.237, 2.7999, 0.0)]
_PLAIN = [(12.0, 45.369, 5.8353, 0.0), (12.0, 42.479, 43.088, 3.0),
          (12.0, 17.940, 56.342, 0.0), (12.0, 12.238, 2.8037, 0.0)]
_REPLAY = [(12.0, 45.369, 5.8327, 0.0), (12.0, 42.320, 46.521, 3.0),
           (12.0, 17.889, 56.288, 0.0), (12.0, 12.237, 2.7996, 0.0)]


def _with(rows, step, idx, value):
    rows = [list(r) for r in rows]
    rows[step][idx] = value
    return [tuple(r) for r in rows]


def test_trajectory_check_holds_settled_steps_and_reports_a_flipped_pick():
    rel = chip_smoke.hold_trajectory(_KERN, _PLAIN, _REPLAY)
    assert rel["plain"][1][1] > 5e-2  # step 2, free arms: reported
    assert all(dg < 5e-2 for _, dg in rel["replay"])  # held at every step


TRAJECTORY_MUTANTS = {
    "grad_norm_off_at_a_settled_step": (_with(_KERN, 2, 2, 56.291 * 1.06),
                                        _PLAIN, _REPLAY),
    "grad_norm_off_with_the_same_picks": (_KERN, _PLAIN,
                                          _with(_REPLAY, 1, 2, 43.088)),
    "loss_off_2pct": (_with(_KERN, 3, 1, 12.237 * 1.02), _PLAIN, _REPLAY),
    "plain_loss_off_2pct": (_KERN, _with(_PLAIN, 1, 1, 42.320 * 1.02),
                            _REPLAY),
    "forward_steps_differ": (_with(_KERN, 0, 0, 11.0), _PLAIN, _REPLAY),
    "fallback_rows_differ": (_with(_KERN, 1, 3, 2.0), _PLAIN, _REPLAY),
    "replay_fallback_rows_differ": (_KERN, _PLAIN,
                                    _with(_REPLAY, 1, 3, 2.0)),
    "a_step_missing": (_KERN[:3], _PLAIN, _REPLAY),
    "a_replayed_step_missing": (_KERN, _PLAIN, _REPLAY[:3]),
}


@pytest.mark.parametrize("wrong", sorted(TRAJECTORY_MUTANTS))
def test_trajectory_check_rejects(wrong):
    kern, plain, replay = TRAJECTORY_MUTANTS[wrong]
    with pytest.raises(AssertionError):
        chip_smoke.hold_trajectory(kern, plain, replay)


def _smoke_train(rows, steps=2):
    cfg = smoke_config("minicpm-2b", deq=True)
    tcfg = TrainConfig(steps=steps, global_batch=2, seq_len=16,
                       schedule=cfg.schedule)
    params = chip_smoke._scaled_blocks(
        lm.init_params(cfg, seed=1, device="cpu"), 0.3)
    Trainer(cfg, tcfg, params=params).run(
        make_lm_batch_iterator(cfg, 2, 16, seed=0, device="cpu"),
        steps=steps, log_every=1, on_metrics=lambda i, m: rows.append(
            (m["deq_steps"], m["loss"], m["grad_norm"])))


def test_replayed_solves_give_the_recorded_steps():
    """The replay arm's plumbing: recorded forward solves answered back give
    the recorded steps bit for bit; a moved iterate moves the gradient; a
    missing or unused recording raises."""
    want, got, moved, rec = [], [], [], []
    with chip_smoke._record_solves(rec):
        _smoke_train(want)
    assert len(rec) == 2
    with chip_smoke._replay_solves(rec):
        _smoke_train(got)
    assert got == want
    shifted = [r._replace(z=r.z * 1.01) for r in rec]
    with chip_smoke._replay_solves(shifted):
        _smoke_train(moved)
    assert [r[2] for r in moved] != [r[2] for r in want]
    with pytest.raises(AssertionError), chip_smoke._replay_solves(rec[:1]):
        _smoke_train([])
    with pytest.raises(AssertionError), chip_smoke._replay_solves(rec):
        _smoke_train([], steps=1)


def _traced_smoke_steps(solver):
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           solver=solver))
    tcfg = TrainConfig(steps=2, global_batch=2, seq_len=16,
                       schedule=cfg.schedule)
    trainer = Trainer(cfg, tcfg, params=lm.init_params(cfg, seed=1,
                                                       device="cpu"))
    return chip_smoke.traced_train_steps(
        trainer, make_lm_batch_iterator(cfg, 2, 16, seed=0, device="cpu"), 2)


@pytest.mark.parametrize("solver", ["broyden", "adjoint_broyden"])
def test_trace_check_passes_traced_train_steps(solver):
    """Two traced ``Trainer`` steps, as the chip smoke run takes them at
    full width: the phases tile each step, no host wait is counted, and
    tracing is off again afterwards."""
    trace, syncs = _traced_smoke_steps(solver)
    steps = chip_smoke.check_trace_phases(trace)
    assert len(steps) == 2 and syncs == []
    for st in steps:
        assert set(st) == {"train_step", *chip_smoke.TRAIN_PHASES}
        assert sum(st[p] for p in chip_smoke.TRAIN_PHASES) \
            <= st["train_step"] + 1e-6
    assert not obs_tracing.enabled()
    assert obs_tracing.default_recorder().events() == []


def test_sync_counter_counts_host_waits():
    """Each of the three waits is noted before it runs (here, without a
    card, each then fails), and the originals are back afterwards."""
    seen = []
    with chip_smoke.count_syncs(seen):
        for call in (torch.cuda.synchronize,
                     lambda: torch.cuda.Event.synchronize(None),
                     lambda: torch.cuda.Stream.synchronize(None)):
            with pytest.raises((AssertionError, AttributeError,
                                RuntimeError)):
                call()
    assert seen == ["torch.cuda.synchronize", "Event.synchronize",
                    "Stream.synchronize"]
    for owner in (torch.cuda, torch.cuda.Event, torch.cuda.Stream):
        assert owner.synchronize.__name__ == "synchronize"


def _read_the_card():
    """What ``torch.cuda.set_sync_debug_mode("warn")`` does at a read of a
    card tensor, done by hand (this machine has no card)."""
    warnings.warn(chip_smoke.SYNC_WARNING, UserWarning)


def test_sync_counter_counts_an_implicit_read(monkeypatch):
    """A read the sync debug mode reports is noted with its file and line;
    an explicit wait is noted once even when it also warns; any other
    warning passes through, uncounted."""
    def fake_synchronize(*a, **k):
        _read_the_card()

    monkeypatch.setattr(torch.cuda, "synchronize", fake_synchronize)
    seen = []
    with pytest.warns(DeprecationWarning, match="unrelated"):
        with chip_smoke.count_syncs(seen):
            _read_the_card()
            _read_the_card()
            torch.cuda.synchronize()
            warnings.warn("unrelated", DeprecationWarning)
    line = _read_the_card.__code__.co_firstlineno + 3
    site = f"implicit at tests/test_torch_smoke_checks.py:{line}"
    assert sorted(seen) == sorted([site, site, "torch.cuda.synchronize"])


# a Broyden train arm at full width: two steps, each forward solve at its
# 12-step budget, one metrics read per step
_ARM_STEPS, _ARM_MAX = [12.0, 12.0], 12
_ARM = (["implicit at src/repro_torch/core/solvers.py:406"] * 24
        + ["implicit at src/repro_torch/core/solvers.py:442"] * 24
        + ["implicit at src/repro_torch/obs/metrics.py:214"] * 2)


def test_expected_syncs_counts_the_solver_and_the_interval_reads():
    assert chip_smoke.expected_syncs(_ARM_STEPS, _ARM_MAX, 2) == len(_ARM)
    # a solve that stops early makes one more check: 2 x 5 + 1
    assert chip_smoke.expected_syncs([5], 12, 1) == 12
    assert chip_smoke.expected_syncs([0], 12, 0) == 1


@pytest.mark.parametrize("arm", ["exact", "extra_read", "lost_read"])
def test_sync_check_rejects_a_kernel_arm_with_an_extra_read(arm):
    """The check holds an arm to the count exactly: one read more (a
    telemetry ``int()`` of a card tensor, say) or one fewer fails it."""
    want = chip_smoke.expected_syncs(_ARM_STEPS, _ARM_MAX, 2)
    syncs = {"exact": _ARM,
             "extra_read": _ARM + [
                 "implicit at src/repro_torch/implicit/fixed_point.py:167"],
             "lost_read": _ARM[1:]}[arm]
    if arm == "exact":
        assert sum(chip_smoke.check_syncs(arm, syncs, want).values()) == 50
    else:
        with pytest.raises(AssertionError, match="host waits"):
            chip_smoke.check_syncs(arm, syncs, want)


def _attn_ptxas(spill_mma: int = 0, spill_f32: int = 0) -> dict:
    line = "{} bytes stack frame, {} bytes spill stores, {} bytes spill loads"
    return {
        "flash_attention": {
            "flash_fwd_mma_kernel<128>": {"spill": line.format(0, spill_mma,
                                                               spill_mma)},
            "flash_fwd_f32_kernel<128,64,2>": {
                "spill": line.format(464, spill_f32, spill_f32)},
            "decode_split_kernel<128>": {"spill": line.format(0, 0, 0)}},
        "rmsnorm": {"rmsnorm_vec_kernel<9>": {"spill": line.format(0, 0, 0)}},
    }


def test_spill_check_passes_the_f32_body_and_rejects_a_bf16_spill():
    got = chip_smoke.check_spills(_attn_ptxas(spill_f32=892))
    assert got["flash_attention:flash_fwd_f32_kernel<128,64,2>"] == 1784
    assert got["flash_attention:flash_fwd_mma_kernel<128>"] == 0
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_spills(_attn_ptxas(spill_mma=4))


def _phase(name, ts, dur):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1,
            "tid": 1}


def _step_events(b, ends, e, names=chip_smoke.TRAIN_PHASES):
    """A ``train_step`` span from ``b`` to ``e`` with phases ending at
    ``ends``, each starting where the previous one ended."""
    xs, at = [], b
    for name, end in zip(names, ends):
        xs.append(_phase(name, at, end - at))
        at = end
    return ([{"name": "train_step", "ph": "B", "ts": b, "pid": 1, "tid": 1}]
            + xs
            + [{"name": "train_step", "ph": "E", "ts": e, "pid": 1,
                "tid": 1}])


# two steps; the second span opens before the first one's device end
_GOOD = (_step_events(0.0, (40.0, 70.0, 80.0), 80.0)
         + [{"name": "data", "ph": "B", "ts": 60.0, "pid": 1, "tid": 1},
            {"name": "data", "ph": "E", "ts": 61.0, "pid": 1, "tid": 1}]
         + _step_events(62.0, (120.0, 150.0, 151.0), 152.0))


def _mutate(i, **kw):
    ev = [dict(e) for e in _GOOD]
    ev[i].update(kw)
    return ev


TRACE_MUTANTS = {
    "phase_missing": [e for e in _GOOD if not (
        e["name"] == "optimizer" and e["ts"] == 70.0)],
    "phases_swapped": _mutate(1, name="implicit_backward")[:2]
    + [dict(_GOOD[2], name="forward_solve")] + _GOOD[3:],
    "negative_duration": _mutate(2, dur=-5.0),
    "gap_between_phases": _mutate(2, ts=41.0, dur=29.0),
    "first_phase_late": _mutate(1, ts=1.0, dur=39.0),
    "phase_past_span_end": _mutate(4, ts=75.0),
    "span_left_open": _GOOD[:-1],
    "no_span": [e for e in _GOOD if e["name"] != "train_step"],
}


def test_trace_check_passes_overlapping_steps():
    assert len(chip_smoke.check_trace_phases({"traceEvents": _GOOD})) == 2


@pytest.mark.parametrize("wrong", sorted(TRACE_MUTANTS))
def test_trace_check_rejects(wrong):
    with pytest.raises(AssertionError):
        chip_smoke.check_trace_phases({"traceEvents": TRACE_MUTANTS[wrong]})


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-v2-lite-16b",
                                  "deepseek-moe-16b", "xlstm-1.3b"])
@pytest.mark.parametrize("remat", ["full", "none"])
def test_forward_launches_count_a_train_step(monkeypatch, arch, remat):
    """``chip_smoke._forward_launches``, the launch counts the layer-stack
    train phases hold each step to, against the calls of the kernel ops a
    smoke train step makes on the CPU (on the card each call is one
    launch): one forward's, and one recompute of every unit under
    ``remat="full"``; the autograd wrappers' backwards call no kernel."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for op, key in (("rmsnorm", "rmsnorm"), ("attention", "flash_attention")):
        orig = getattr(ops, op)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(ops, op, counted)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              remat=remat)
    tcfg = TrainConfig(steps=1, global_batch=2, seq_len=16)
    state = steps.init_train_state(cfg, tcfg, device="cpu")
    batch = next(make_lm_batch_iterator(cfg, 2, 16, seed=0, device="cpu"))
    steps.build_train_step(cfg, tcfg)(state, batch)
    fwd = chip_smoke._forward_launches(cfg)
    assert calls == {k: fwd[k] + (fwd["inside"][k] if remat == "full"
                                  else 0) for k in calls}


def test_scaled_tolerance_follows_the_output():
    want = torch.tensor([1e-7, -3e-7])
    tol = chip_smoke._scaled_tol(want)
    assert tol["rtol"] == chip_smoke.SCAN_TOL["rtol"]
    assert tol["atol"] == pytest.approx(chip_smoke.SCAN_TOL["atol"] * 3e-7)
    # an error of 1e-3 of the output's scale is caught, 1e-5 is not
    assert chip_smoke.excess(want + 3e-10, want, tol) > 0
    assert chip_smoke.excess(want + 3e-12, want, tol) <= 0


@pytest.fixture(scope="module")
def xlstm_caches():
    """The xLSTM smoke model (f32, B=2) after a prefill over 20 tokens and
    one decode step, the same after the prefill alone, and a prefill over
    all 21 tokens."""
    cfg = dataclasses.replace(smoke_config("xlstm-1.3b"), dtype="float32")
    params = lm.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(2, 21)))
    with torch.no_grad():
        _, caches, lens = lm.prefill(params, {"tokens": toks[:, :20]}, cfg,
                                     32)
        stale = _clone_tree(caches)
        lm.decode_step(params, caches, toks[:, 20], lens, cfg)
        _, want, _ = lm.prefill(params, {"tokens": toks}, cfg, 32)
    return cfg, caches, stale, want


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_clone_tree(v) for v in tree))
    return tree.clone()


def test_cache_leaf_check_passes_prefill_then_decode(xlstm_caches):
    cfg, got, _, want = xlstm_caches
    rows = chip_smoke.check_cache_leaves(got, want, cfg, "xlstm smoke")
    n_units = cfg.num_layers // cfg.xlstm.slstm_every
    n_m = cfg.xlstm.slstm_every - 1
    assert {k: r["layers"] for k, r in rows.items()} == {
        **{f"group0.mlstm.{f}": n_units * n_m for f in ("C", "n", "m")},
        **{f"group0.slstm.{f}": n_units for f in ("c", "n", "h", "m")}}
    assert all(r["limit_share"] <= 1 for r in rows.values())


@pytest.mark.parametrize("wrong", ["swapped_mlstm_layers", "stale_mlstm_C",
                                   "stale_slstm_h", "stale_mlstm_m"])
def test_cache_leaf_check_rejects(xlstm_caches, wrong):
    """A wrong layer index or a layer whose state the decode step did not
    advance fails, however little that layer adds to the logits."""
    cfg, got, stale, want = xlstm_caches
    bad = _clone_tree(got)
    m_bad, s_bad = bad["group0"]["mlstm"], bad["group0"]["slstm"]
    m_old, s_old = stale["group0"]["mlstm"], stale["group0"]["slstm"]
    if wrong == "swapped_mlstm_layers":
        m_bad.C[0, [0, 1]] = m_bad.C[0, [1, 0]].clone()
    elif wrong == "stale_mlstm_C":
        m_bad.C[1, 2] = m_old.C[1, 2]
    elif wrong == "stale_mlstm_m":
        m_bad.m[0, 1] = m_old.m[0, 1]
    else:
        s_bad.h[1] = s_old.h[1]
    with pytest.raises(AssertionError):
        chip_smoke.check_cache_leaves(bad, want, cfg, "xlstm smoke")


# ---------------------------------------------------------------------------
# phase_layout's checks
# ---------------------------------------------------------------------------


def _allocator(tree, tails=0) -> dict:
    """What the caching allocator would report for a tree: the bytes
    requested, and each leaf at its 512-byte block plus ``tails`` bytes."""
    leaves = chip_smoke._leaves(tree)
    return {"requested": sum(t.numel() * t.element_size() for t in leaves),
            "allocated": tails + sum(-(-t.numel() * t.element_size() // 512)
                                     * 512 for t in leaves)}


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b"])
def test_layout_bytes_check_passes_real_params_and_rejects_one_leaf_off(
        arch):
    from repro_torch.launch.mesh import ONE_CARD
    from repro_torch.launch import steps
    from repro_torch.parallel.sharding import ShardCtx
    cfg = smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    want = chip_smoke.want_bytes(
        steps.param_structs(cfg, ShardCtx.for_mesh(ONE_CARD))[0])
    got = chip_smoke.check_bytes(arch, _allocator(params), want)
    assert got["tail"] == 0 and got["blocks"] == want["blocks"]
    # a leaf over 1 MiB may take its segment's rest (at most 1 MiB)
    big = dict(params, extra=torch.ones(1 << 19))
    want_big = dict(want, exact=want["exact"] + (2 << 20),
                    blocks=want["blocks"] + (2 << 20),
                    large=want["large"] + 1)
    chip_smoke.check_bytes(arch, _allocator(big, 1 << 20), want_big)
    with pytest.raises(AssertionError, match="memory_allocated"):
        chip_smoke.check_bytes(arch, _allocator(big, (1 << 20) + 512),
                               want_big)
    # one leaf 2 bytes longer than declared: the requested bytes differ
    params["final_norm"]["scale"] = torch.ones(cfg.d_model + 1,
                                               dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match="requested"):
        chip_smoke.check_bytes(arch, _allocator(params), want)


def test_layout_share_and_peak_checks_reject_canned_answers():
    assert chip_smoke.check_share("step", 0.05) == 0.05
    for bad in (1.2, 0.0, -0.1):
        with pytest.raises(AssertionError, match="share"):
            chip_smoke.check_share("step", bad)
    tol = chip_smoke.LAYOUT_PEAK_TOL
    assert chip_smoke.check_peak("step", 100, 100) == 0.0
    chip_smoke.check_peak("step", int(1000 * (1 + tol * 0.9)), 1000)
    with pytest.raises(AssertionError, match="peak"):
        chip_smoke.check_peak("step", int(1000 * (1 + tol * 1.1)), 1000)
    with pytest.raises(AssertionError, match="peak"):
        chip_smoke.check_peak("step", int(1000 * (1 - tol * 1.1)), 1000)


def test_layout_matrix_check_rejects_a_failed_or_missing_cell():
    ok = {"cells": 3, "ran": 3, "failures": [], "skipped": {"a": "why"},
          "excluded": [], "seconds": 1.0, "slowest": []}
    chip_smoke.check_matrix(ok, 0)
    with pytest.raises(AssertionError, match="failed cells"):
        chip_smoke.check_matrix(dict(ok, failures=["x/y/one/memory/False"]),
                                1)
    with pytest.raises(AssertionError, match="rc 1"):
        chip_smoke.check_matrix(ok, 1)
    with pytest.raises(AssertionError, match="ran 2 of 3"):
        chip_smoke.check_matrix(dict(ok, ran=2), 0)
