"""The Hopper kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (``sm_90a``) and ``nvcc``; they skip
elsewhere.  The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs with

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Shapes are small but ragged (D not a multiple of 4, S not a multiple of the
query tile, GQA, an empty ring row, a refused append) so each kernel's edge
handling is exercised, and the qN kernels run every case of
``chip_smoke.QN_CASES`` (both schedules), the attention kernels every
registered head dim (16, 64, 80, 96, 128, 192) and rmsnorm every width of
``chip_smoke.RMS_SHAPES``; ``chip_smoke.py`` checks the serving and training
paths' shapes.  Besides the kernels: the autograd wrappers' gradients, a
refine backward that must leave a carried ring as the forward left it, the
span tracer's device phases on two traced train steps, and the host waits
of train steps (``chip_smoke.count_syncs``): the solver's two reads per
iteration and the one metrics read per interval, nothing more, with
metrics off and on, traced and untraced; and the async serving pipeline
with the prefix store on the card: the sync loop's tokens, logits and step
sequences, and no host read of its own (landings read host buffers only).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only "
                    "on the card")
    launches.reset()
    return torch.device("cuda")


def _tree(fn, p):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qn_kernels_match_plain_versions(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    m, bsz, dim = 8, 5, 1030
    u = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    v = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    g = torch.randn(bsz, dim, device=dev, generator=gen)
    s = 0.1 * torch.randn(bsz, dim, device=dev, generator=gen)
    s[3] = 0.0  # den = 0: the append is refused
    hg = torch.randn(bsz, dim, device=dev, generator=gen)
    count = torch.tensor([m + 2, 2, m, 0, 5], device=dev, dtype=torch.int32)
    mask = (torch.arange(m, device=dev)[:, None]
            < torch.clamp(count, max=m)[None]).float()
    slot = (count % m).int()
    active = torch.tensor([True, True, False, True, True], device=dev)
    alpha = torch.tensor(1.0, device=dev)
    want = ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot, active,
                                1e-8)
    got = ops.broyden_step(u.clone(), v.clone(), g, s, hg, alpha, mask,
                           slot, active, 1e-8)
    for gt, wt in zip(got, want):
        _close(gt, wt, gt.dtype)
    xs = torch.stack([g, s, hg])
    flags = (False, True, False)
    _close(ops.qn_apply_multi(u, v, xs, alpha, mask, flags),
           ref.qn_apply_multi_ref(u, v, xs, alpha, mask, flags),
           torch.float32)
    c = launches.counts()
    assert c["broyden_step"] == 1 and c["qn_apply_multi"] == 1
    # both schedules: m in {1, 8, 30}, ragged D, slices straddling samples,
    # slots at rows 0 and m-1, a refused and an inactive row, K = 1, 2
    # mixed and 4, two calls bit for bit (chip_smoke.QN_CASES)
    for tag, m, bsz, dim, schedule in chip_smoke.QN_CASES:
        chip_smoke.qn_case(tag, m, bsz, dim, dtype, schedule, gen)
    c = launches.counts()
    n = len(chip_smoke.QN_CASES)
    assert c["broyden_step"] == 1 + 2 * n
    assert c["qn_apply_multi"] == 1 + 2 * len(chip_smoke.QN_FLAGS) * n


# prefill (B, S, T, H, KV, kv_length, causal): GQA groups 1, 3 and 4,
# ragged S and T (T != S too), a kv_length 0 row and lengths inside a tile
PREFILL = [(2, 70, 70, 4, 2, [70, 33], True),
           (3, 197, 197, 12, 12, [197, 0, 37], True),
           (2, 197, 150, 12, 4, None, True),
           (2, 64, 130, 12, 3, [129, 0], False)]
# decode (B, H, KV, T, kv_length): the split chunk's edges (127, 128, 129,
# T) and 0, a cache shorter than one chunk, GQA H=36 over KV=12
DECODE = [(2, 4, 2, 70, [1, 0]),
          (4, 4, 4, 300, [127, 128, 129, 300]),
          (3, 4, 2, 100, [100, 0, 37]),
          (3, 36, 12, 300, [257, 0, 300])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 80, 96, 128, 192])
def test_attention_kernels_match_plain_versions(dev, dtype, hd):
    gen = torch.Generator(device=dev).manual_seed(1)

    def draw(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def lengths(vals):
        return None if vals is None else torch.tensor(vals, device=dev,
                                                      dtype=torch.int32)

    for b, s, t, h, kv, lens, causal in PREFILL:
        q, k, v = draw(b, s, h, hd), draw(b, t, kv, hd), draw(b, t, kv, hd)
        lens = lengths(lens)
        chip_smoke.check_attention(
            f"attention{(b, s, t, h, kv)}",
            ops.attention(q, k, v, causal=causal, kv_length=lens),
            ref.attention_ref(q, k, v, causal=causal, kv_length=lens),
            q, k, v, lens, TOL[dtype])
    for b, h, kv, t, lens in DECODE:
        q, k, v = draw(b, h, hd), draw(b, t, kv, hd), draw(b, t, kv, hd)
        lens = lengths(lens)  # 0: every key masked, the uniform average
        chip_smoke.check_attention(
            f"decode_attention{(b, h, kv, t)}",
            ops.decode_attention(q, k, v, lens),
            ref.decode_attention_ref(q, k, v, lens), q, k, v, lens,
            TOL[dtype])
    c = launches.counts()
    assert c["flash_attention"] == len(PREFILL)
    assert c["decode_attention"] == len(DECODE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_version(dev, dtype):
    """Every width and row count ``chip_smoke.py`` checks (the registry's
    widths at 1024 rows, the decode shape, a ragged row count, D = 64;
    DeepSeek's 2048 and MLA's kv_norm 512, at 1024 rows and at decode's
    4), a ragged row count of a width with no vector instance, and a row
    that is not 16-byte aligned (the generic kernel)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = chip_smoke.RMS_SHAPES + [(33, 2304), (5, 100)]
    for rows, d in shapes:
        x = torch.randn(rows, d, device=dev, generator=gen).to(dtype)
        w = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(dtype)
        _close(ops.rmsnorm(x, w, 1e-5), ref.rmsnorm_ref(x, w, 1e-5), dtype)
    flat = torch.randn(1 + 3 * 2304, device=dev, generator=gen).to(dtype)
    x = flat[1:].view(3, 2304)  # contiguous, one element off 16 bytes
    _close(ops.rmsnorm(x, w[:1].expand(2304).contiguous(), 1e-5),
           ref.rmsnorm_ref(x, w[:1].expand(2304), 1e-5), dtype)
    assert launches.counts()["rmsnorm"] == len(shapes) + 1


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(dev):
    from repro_torch.kernels import flash_attention, qn_apply
    u = torch.zeros(40, 2, 8, device=dev)
    with pytest.raises(ValueError):  # ring memory past the kernel's bound
        qn_apply.qn_apply_multi(u, u, torch.zeros(1, 2, 8, device=dev), 1.0,
                                torch.zeros(40, 2, device=dev), (False,))
    q = torch.zeros(1, 4, 2, 48, device=dev)
    with pytest.raises(ValueError):  # head dim not instantiated
        flash_attention.flash_attention(q, q, q)
    x = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the weight must have x's dtype
        ops.rmsnorm(x, torch.ones(64, device=dev))
    flat = torch.zeros(1 + 4 * 2 * 64, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(1, 4, 2, 64)  # contiguous, 2 bytes off 16
    with pytest.raises(ValueError):  # the 16-byte copies need alignment
        flash_attention.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lowrank_append_and_qn_apply_match_plain_versions(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    m, bsz, dim = 6, 5, 1030
    u = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    v = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    s, hy, b = (torch.randn(bsz, dim, device=dev, generator=gen)
                for _ in range(3))
    inv_den = torch.randn(bsz, device=dev, generator=gen)
    slot = torch.tensor([0, 5, 2, 2, 1], device=dev, dtype=torch.int32)
    upd = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], device=dev)
    want = ref.lowrank_append_ref(u, v, s, hy, b, inv_den, slot, upd)
    uu, vv = u.clone(), v.clone()
    got = ops.lowrank_append(uu, vv, s, hy, b, inv_den, slot, upd)
    assert got[0].data_ptr() == uu.data_ptr()  # the ring, updated in place
    for gt, wt in zip(got, want):  # copies and one rounding: bit for bit
        assert torch.equal(gt, wt)
    count = torch.tensor([m + 2, 2, m, 0, 5], device=dev, dtype=torch.int32)
    mask = (torch.arange(m, device=dev)[:, None]
            < torch.clamp(count, max=m)[None]).float()
    alpha = torch.tensor(0.7, device=dev)
    for x in (s, s.to(dtype)):
        _close(ops.qn_apply(u, v, x, alpha, mask),
               ref.qn_apply_ref(u, v, x, alpha, mask), x.dtype)
    _close(ops.qn_apply_multi(u, v, s[None], alpha, mask, (True,)),
           ref.qn_apply_multi_ref(u, v, s[None], alpha, mask, (True,)),
           torch.float32)
    c = launches.counts()
    assert (c["lowrank_append"], c["qn_apply"], c["qn_apply_multi"]) \
        == (1, 2, 1)


@pytest.mark.cuda
def test_autograd_wrappers_give_plain_gradients(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, g = (torch.randn(2, 70, 4, 16, device=dev, generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    x = torch.randn(33, 2304, device=dev, generator=gen).to(torch.bfloat16)
    w = torch.ones(2304, device=dev, dtype=torch.bfloat16)
    gx = torch.randn(33, 2304, device=dev, generator=gen).to(torch.bfloat16)
    for op, plain, ins, cot in (
            (lambda *a: ops.attention(*a, causal=True),
             lambda *a: ref.attention_ref(*a, causal=True), (q, k, v), g),
            (lambda *a: ops.rmsnorm(*a, 1e-5),
             lambda *a: ref.rmsnorm_ref(*a, 1e-5), (x, w), gx)):
        grads = []
        for fn in (op, plain):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, cot))
        for a, b in zip(*grads):
            _close(a, b, torch.bfloat16)
    c = launches.counts()
    assert c["flash_attention"] == 1 and c["rmsnorm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1000, 16, 16, 80, False),
                                   (2, 1152, 32, 8, 128, True)])
def test_audio_and_vlm_attention_shapes(dev, shape):
    """The prefill kernel at HuBERT-XLarge's non-causal encoder shape and
    at Pixtral-12B's image prompt (1024 image + 128 text tokens, 32/8
    heads), bf16, against the plain version."""
    b, s, h, kv, hd, causal = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(b, s, h, hd, device=dev, generator=gen).bfloat16()
    k, v = (torch.randn(b, s, kv, hd, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    chip_smoke.check_attention(
        f"attention{shape}", ops.attention(q, k, v, causal=causal),
        ref.attention_ref(q, k, v, causal=causal), q, k, v, None,
        TOL[torch.bfloat16])
    assert launches.counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_xla_on_the_card(dev, dtype):
    """``impl="flash_xla"`` runs the chunked torch path on CUDA tensors
    (no kernel launch): its forward and gradients against plain autograd
    through the plain version, GQA, ragged tiles, causal and not."""
    gen = torch.Generator(device=dev).manual_seed(6)
    q, g = (torch.randn(2, 150, 8, 64, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(2, 150, 2, 64, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    for causal in (True, False):
        res = []
        for fn in (lambda *a: ops.attention(*a, causal=causal,
                                            impl="flash_xla", block_q=64,
                                            block_kv=32),
                   lambda *a: ref.attention_ref(*a, causal=causal)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            res.append((out.detach(),)
                       + torch.autograd.grad(out, leaves, g))
        for a, b in zip(*res):
            _close(a, b, dtype)
    assert not any(launches.counts().values())


@pytest.mark.cuda
def test_refine_backward_leaves_the_carried_ring_alone(dev):
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(
        cfg.deq, backward="shine_refine"))
    params = lm.init_params(cfg, seed=0, device=dev)
    params["deq_blocks"] = _tree(lambda t: t * 0.3, params["deq_blocks"])
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    carry = lm.deq_solve_carry(cfg, 2, 16, dev)
    with torch.no_grad():
        carry = lm.loss_fn(params, batch, cfg, carry=carry)[1]["solve_carry"]
    leaves = _tree(lambda t: t.detach().requires_grad_(True), params)
    loss, m = lm.loss_fn(leaves, batch, cfg, carry=carry)
    ring = m["solve_carry"].lowrank
    snap = (ring.u.clone(), ring.v.clone())
    launches.reset()
    loss.backward()
    assert launches.counts()["broyden_step"] > 0  # the adjoint solve ran
    assert torch.equal(ring.u, snap[0]) and torch.equal(ring.v, snap[1])


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [False, True])
def test_rejected_step_gives_back_the_full_carry(dev, guard):
    """``deq_carry="full"`` hands the step's solve the carried ring.  A
    step that ``skip_nonfinite`` rejects must give back the pre-step carry
    bit for bit.  Without the guard the solve extends that ring in place on
    the card, so only the step's copy keeps it; with the guard the solve's
    entry repair already selects it into new buffers."""
    import dataclasses

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           guard=guard))
    tcfg = TrainConfig(steps=2, global_batch=2, seq_len=16, deq_carry="full",
                       skip_nonfinite=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    params["deq_blocks"] = _tree(lambda t: t * 0.3, params["deq_blocks"])
    state = steps.init_train_state(cfg, tcfg, params=params)
    step = steps.build_train_step(cfg, tcfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    state, m = step(state, batch)  # fills the carried ring
    assert float(m["update_skipped"]) == 0.0
    before = state.carry.lowrank.clone()
    z = state.carry.z.clone()
    nan_norm = {k: torch.full_like(t, float("nan"))
                for k, t in state.params["final_norm"].items()}
    state = state._replace(params=dict(state.params, final_norm=nan_norm))
    launches.reset()
    state, m = step(state, batch)  # the solve runs; the loss is NaN
    assert launches.counts()["broyden_step"] > 0
    assert float(m["update_skipped"]) == 1.0
    after = state.carry.lowrank
    assert int(before.count.min()) > 0
    for a, b in ((after.u, before.u), (after.v, before.v),
                 (after.count, before.count), (state.carry.z, z)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["fixed_point", "anderson"])
def test_placeholder_inverse_is_the_identity_on_the_card(dev, solver):
    """Picard and Anderson hand the backward an empty ring of the state's
    shape: on the card ``H^T w`` goes through the ``qn_apply_multi``
    kernel (one launch) and gives ``w`` bit for bit."""
    from repro_torch.core import solvers
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 5, 64, device=dev, generator=g)
    res = getattr(solvers, f"{solver}_solve")(
        lambda z: 0.5 * torch.tanh(z) + x, torch.zeros_like(x),
        solvers.SolverConfig(max_steps=30, tol=1e-5, memory=4))
    w = torch.randn(2, 5, 64, device=dev, generator=g)
    launches.reset()
    assert torch.equal(res.lowrank.rmatvec(w), w)
    assert launches.counts()["qn_apply_multi"] == 1


def _smoke_trainer(dev, solver):
    import dataclasses

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import Trainer
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(cfg, deq=dataclasses.replace(cfg.deq,
                                                           solver=solver))
    tcfg = TrainConfig(steps=2, global_batch=2, seq_len=16,
                       schedule=cfg.schedule)
    params = lm.init_params(cfg, seed=1, device=dev)
    params["deq_blocks"] = _tree(lambda t: t * 0.3, params["deq_blocks"])
    return cfg, Trainer(cfg, tcfg, params=params)


@pytest.mark.cuda
@pytest.mark.parametrize("metrics", [False, True])
def test_train_step_reads_the_card_only_in_the_solver_and_interval(
        dev, metrics):
    """Two smoke ``Trainer`` steps (Broyden) under the sync debug mode, with
    one metrics read per step: no host wait besides the solver's two reads
    per iteration and the read per interval (``chip_smoke.expected_syncs``),
    with metrics off and on alike (the bridge lands at that read)."""
    from repro_torch.data.pipeline import make_lm_batch_iterator
    from repro_torch.obs import metrics as obs_metrics
    cfg, trainer = _smoke_trainer(dev, "broyden")
    syncs, fwd = [], []
    obs_metrics.set_enabled(metrics)
    try:
        with chip_smoke.count_syncs(syncs), chip_smoke._record_forward(fwd):
            trainer.run(make_lm_batch_iterator(cfg, 2, 16, seed=0,
                                               device=dev),
                        steps=2, log_every=1, on_metrics=lambda i, m: None)
    finally:
        obs_metrics.set_enabled(False)
    chip_smoke.check_syncs(
        f"metrics {'on' if metrics else 'off'}", syncs,
        chip_smoke.expected_syncs([n for n, _ in fwd], cfg.deq.max_steps, 2))
    if metrics:
        reg = obs_metrics.default_registry()
        assert not reg._pending
        assert reg.counter("backward_estimates_total",
                           {"estimator": cfg.deq.backward}).value >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["broyden", "adjoint_broyden"])
def test_traced_train_steps_tile_on_the_card(dev, solver):
    """Span tracing of two ``Trainer`` steps on the card: each phase ends at
    a CUDA event resolved when the trace is written, the phases tile each
    ``train_step`` span (``chip_smoke.check_trace_phases``) and the traced
    steps make as many host waits on the card as the same steps untraced
    (``chip_smoke.count_syncs``): the solver's and the interval reads."""
    from unittest import mock

    from repro_torch.data.pipeline import make_lm_batch_iterator
    from repro_torch.obs import tracing
    cfg, trainer = _smoke_trainer(dev, solver)
    marks = []
    real = tracing._DeviceMark

    def mark(device):
        marks.append(device)
        return real(device)

    untraced, fwd0 = [], []
    with chip_smoke.count_syncs(untraced), chip_smoke._record_forward(fwd0):
        trainer.run(make_lm_batch_iterator(cfg, 2, 16, seed=0, device=dev),
                    steps=2, log_every=2, on_metrics=lambda i, m: None)
    fwd = []
    with mock.patch.object(tracing, "_DeviceMark", mark):
        trace, syncs = chip_smoke.traced_train_steps(
            trainer, make_lm_batch_iterator(cfg, 2, 16, seed=0, device=dev),
            2, forward=fwd)
    assert [n for n, _ in fwd] == [n for n, _ in fwd0]
    assert len(syncs) == len(untraced) == chip_smoke.expected_syncs(
        [n for n, _ in fwd], cfg.deq.max_steps, 1)
    assert len(marks) == 2 * len(chip_smoke.TRAIN_PHASES)
    assert all(d.type == "cuda" for d in marks)
    steps = chip_smoke.check_trace_phases(trace)
    assert len(steps) == 2
    for st in steps:
        assert all(st[p] > 0 for p in chip_smoke.TRAIN_PHASES)


def _smoke_serve(dev, **kw):
    """A smoke-size DEQ ServeLoop on the card (blocks x0.3, f32, ring of
    16, tol 1e-5) over an overlapping-prefix stream of 6 requests, 3 new
    tokens each; returns the loop and the requests after the drain, and
    the host waits it made (``chip_smoke.count_syncs``)."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime.serving import Request, ServeLoop
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(
        cfg, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=100, tol=1e-5, memory=16))
    params = lm.init_params(cfg, seed=0, device=dev)
    params["deq_blocks"] = _tree(lambda t: t * 0.3, params["deq_blocks"])
    rng = np.random.default_rng(7)
    base = rng.integers(2, 128, size=8).tolist()
    prompts = [base + rng.integers(2, 128, size=4).tolist()
               for _ in range(6)]
    loop = ServeLoop(params, cfg, slots=3, max_len=64, eos_id=-1,
                     prefix_cache=True, prefix_cache_slots=16, record=True,
                     **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(prompts)]
    syncs = []
    with chip_smoke.count_syncs(syncs):
        loop.drain(reqs)
    return cfg, loop, reqs, syncs


@pytest.mark.cuda
def test_async_drain_with_the_device_store_equals_the_sync_drain(dev):
    """The async pipeline with the prefix store on the card gives the sync
    loop's tokens, recorded logits bit for bit and step sequences, counts
    no blocking read, and waits on the card only for the solver's own
    reads and the one clock wait (``chip_smoke.async_expected_syncs``)."""
    from repro_torch.obs import metrics as obs_metrics
    _, loop_s, reqs_s, _ = _smoke_serve(dev, pipeline="sync")
    reg = obs_metrics.default_registry()
    reg.reset()
    cfg, loop_a, reqs_a, syncs = _smoke_serve(dev, pipeline="async",
                                              async_depth=2)
    assert not [m for m in reg.snapshot()["metrics"]
                if m["name"] == "host_syncs_total"]
    assert [r.out for r in reqs_a] == [r.out for r in reqs_s]
    assert loop_a.recorded_steps == loop_s.recorded_steps
    for uid, want in loop_s.recorded_logits.items():
        for a, b in zip(loop_a.recorded_logits[uid], want):
            np.testing.assert_array_equal(a, b)
    assert loop_a.prefix_store.z.is_cuda
    assert loop_a.prefix_store.stats()["hits"] >= 1
    assert loop_a.saved_iters > 0
    chip_smoke.check_syncs("async drain", syncs,
                           chip_smoke.async_expected_syncs(
                               loop_a.solve_log, cfg.deq.max_steps))


@pytest.mark.cuda
@pytest.mark.parametrize("metrics", [False, True])
def test_async_landing_reads_no_card_tensor(dev, metrics):
    """Every landing of an async drain on the card reads host buffers only:
    no host wait on the card inside ``ServeLoop._land``, with the metrics
    bridge off and on (on, its values ride each entry to the host); the
    drain's waits are the solver's and the clock's."""
    from unittest import mock

    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.runtime.serving import ServeLoop
    inside = []
    orig = ServeLoop._land

    def land(self, e):
        with chip_smoke.count_syncs(inside):
            return orig(self, e)

    obs_metrics.set_enabled(metrics)
    try:
        with mock.patch.object(ServeLoop, "_land", land):
            cfg, loop, reqs, syncs = _smoke_serve(dev, pipeline="async")
        assert not obs_metrics.default_registry()._pending
    finally:
        obs_metrics.set_enabled(False)
    assert all(len(r.out) == 3 for r in reqs)
    assert inside == []
    chip_smoke.check_syncs("async drain", syncs,
                           chip_smoke.async_expected_syncs(
                               loop.solve_log, cfg.deq.max_steps))
