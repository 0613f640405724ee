"""The train step updates its state in place, on the CPU.

  * ``adamw_update`` / ``sgdm_update`` write into the state's own tensors
    (the same ``data_ptr`` before and after; the returned trees are the
    given ones) and give, bit for bit, the values of the functional
    updates they replaced (kept below as the oracle, with the step's old
    skip-select), accepted and rejected, in f32 and bf16, over leaves
    split into several chunks (``CHUNK`` made small) with a ragged tail;
  * a step that ``skip_nonfinite`` rejects gives back the pre-step
    parameters, moments, step and carry bit for bit, in the same tensors;
  * ``init_train_state(params=p)`` copies ``p`` once: steps leave ``p`` bit
    for bit as it was;
  * ``Trainer._rollback`` without a checkpoint re-initialises from the
    original weights, not from weights the steps updated;
  * an async checkpoint save is not torn by an in-place update made
    before its writer runs.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import make_lm_batch_iterator
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.optim import optimizers as topt
from repro_torch.runtime.trainer import Trainer

# ---------------------------------------------------------------------------
# The functional updates the in-place ones replaced (the oracle)
# ---------------------------------------------------------------------------


def adamw_functional(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.1):
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if p.ndim >= 2:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = topt.tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: topt.tree_map(lambda t3: t3[i], out)  # noqa: E731
    return pick(0), topt.OptState(step, pick(1), pick(2))


def sgdm_functional(grads, state, params, lr, *, momentum=0.9,
                    weight_decay=0.0):
    def upd(p, g, m):
        gf = g.float()
        if p.ndim >= 2 and weight_decay:
            gf = gf + weight_decay * p.float()
        m2 = momentum * m + gf
        return (p.float() - lr * m2).to(p.dtype), m2

    out = topt.tree_map(upd, params, grads, state.mu)
    pick = lambda i: topt.tree_map(lambda t2: t2[i], out)  # noqa: E731
    return pick(0), topt.OptState(state.step + 1, pick(1), state.nu)


def keep(ok, new, old):
    """The step's old skip-select, written into the fresh update."""
    return topt.tree_map(lambda n, o: torch.where(ok, n, o, out=n), new, old)


# ---------------------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bit pattern (NaNs compare equal to themselves)."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.uint8, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def _flat(tree) -> list:
    """The tensors of nested dicts and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _same_bits(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(fa, fb))


def _clone(tree):
    return topt.tree_map(torch.clone, tree)


def _tree(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = {"stacked": (2, 3, 5, 7), "w": (4, 6), "b": (6,),
              "deep": {"x": (3, 5), "s": (1,)}}

    def build(spec):
        return {k: (build(v) if isinstance(v, dict) else
                    torch.randn(v, generator=g).to(dtype))
                for k, v in spec.items()}

    return build(shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opt", ["adamw", "sgdm"])
def test_updates_are_the_functional_ones_bit_for_bit(monkeypatch, dtype,
                                                     opt):
    # chunks of 7 elements: a leaf of 210 splits into 30, one of 24 into
    # 3 and a ragged 3
    monkeypatch.setattr(topt, "CHUNK", 7)
    params = _tree(dtype, 0)
    state = topt.adamw_init(params)
    ref_p, ref_s = _clone(params), topt.OptState(
        state.step.clone(), _clone(state.mu), _clone(state.nu))
    kw = {} if opt == "adamw" else dict(weight_decay=0.1)
    new_fn = topt.adamw_update if opt == "adamw" else topt.sgdm_update
    old_fn = adamw_functional if opt == "adamw" else sgdm_functional
    ptrs = [t.data_ptr() for t in _flat((params, state.mu,
                                        state.nu))]
    for i, verdict in enumerate((None, True, False, True)):
        grads = topt.tree_map(lambda p: 3 * p.float() + 1.0, _tree(dtype,
                                                                   10 + i))
        grads = topt.tree_map(lambda g: g.to(dtype), grads)
        lr = torch.tensor(1e-2 * (i + 1))
        ok = None if verdict is None else torch.tensor(verdict)
        want_p, want_s = old_fn(grads, ref_s, ref_p, lr, **kw)
        if ok is not None:
            want_p = keep(ok, want_p, ref_p)
            want_s = topt.OptState(want_s.step, keep(ok, want_s.mu, ref_s.mu),
                                   keep(ok, want_s.nu, ref_s.nu))
        got_p, got_s = new_fn(grads, state, params, lr, ok=ok, **kw)
        assert got_p is params and got_s.mu is state.mu
        assert _same_bits(got_p, want_p), i
        assert _same_bits((got_s.mu, got_s.nu), (want_s.mu, want_s.nu)), i
        assert int(got_s.step) == int(want_s.step) == i + 1
        assert [t.data_ptr() for t in _flat(
            (got_p, got_s.mu, got_s.nu))] == ptrs
        state, ref_p, ref_s = got_s, want_p, want_s


def test_update_refuses_a_non_contiguous_state():
    params = {"w": torch.randn(6, 4).t()}
    state = topt.adamw_init({"w": torch.zeros(4, 6)})
    with pytest.raises(ValueError, match="contiguous"):
        topt.adamw_update({"w": torch.ones(4, 6)}, state, params,
                          torch.tensor(1e-2))


def _state_snapshot(state):
    return (_clone(state.params), _clone(state.opt.mu), _clone(state.opt.nu),
            state.opt.step.clone(), state.step.clone(),
            (state.carry.z.clone(), state.carry.lowrank.u.clone(),
             state.carry.lowrank.v.clone(), state.carry.lowrank.count.clone(),
             state.carry.warm.clone(), state.carry.age.clone()))


def test_rejected_step_gives_back_the_whole_state():
    """A NaN final norm makes the loss NaN: the step's solve still runs and
    fills the carried ring, the update is rejected, and params, moments,
    the optimizer step and the carry come back bit for bit, in the same
    tensors."""
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(cfg, dtype="float32", deq=dataclasses.replace(
        cfg.deq, guard=False))
    tcfg = TrainConfig(steps=3, global_batch=2, seq_len=16, deq_carry="full",
                       skip_nonfinite=True, warmup_steps=1)
    params = lm.init_params(cfg, seed=0, device="cpu")
    params["deq_blocks"] = topt.tree_map(lambda t: t * 0.3,
                                         params["deq_blocks"])
    state = steps.init_train_state(cfg, tcfg, params=params)
    step = steps.build_train_step(cfg, tcfg)
    batches = make_lm_batch_iterator(cfg, 2, 16, seed=0, device="cpu")
    state, m = step(state, next(batches))   # moments and ring non-zero
    assert float(m["update_skipped"]) == 0.0
    assert int(state.carry.lowrank.count.min()) > 0
    state.params["final_norm"]["scale"].fill_(float("nan"))
    before = _state_snapshot(state)
    ptrs = [t.data_ptr() for t in _flat(
        (state.params, state.opt.mu, state.opt.nu))]
    new, m = step(state, next(batches))
    assert float(m["update_skipped"]) == 1.0
    assert float(m["consec_skips"]) == 1.0
    after = _state_snapshot(new)
    for a, b in zip(after[:3], before[:3]):
        assert _same_bits(a, b)
    assert int(after[3]) == int(before[3]) == 1          # optimizer step
    assert int(after[4]) == 2                            # the step counter
    for a, b in zip(after[5], before[5]):
        assert torch.equal(_bits(a), _bits(b))
    assert [t.data_ptr() for t in _flat(
        (new.params, new.opt.mu, new.opt.nu))] == ptrs


def test_init_train_state_leaves_the_callers_params_alone():
    cfg = dataclasses.replace(smoke_config("xlstm-1.3b"), dtype="float32")
    tcfg = TrainConfig(steps=2, global_batch=2, seq_len=8, lr=1e-2,
                       warmup_steps=1)
    params = lm.init_params(cfg, seed=0, device="cpu")
    before = _clone(params)
    state = steps.init_train_state(cfg, tcfg, params=params)
    assert not {t.data_ptr() for t in topt.tree_leaves(state.params)} & \
        {t.data_ptr() for t in topt.tree_leaves(params)}
    step = steps.build_train_step(cfg, tcfg)
    batches = make_lm_batch_iterator(cfg, 2, 8, seed=0, device="cpu")
    for _ in range(2):
        state, m = step(state, next(batches))
        assert float(m["update_skipped"]) == 0.0
    assert _same_bits(params, before)
    assert not _same_bits(state.params, before)


def test_rollback_without_a_checkpoint_restarts_from_the_original_weights():
    cfg = dataclasses.replace(smoke_config("xlstm-1.3b"), dtype="float32")
    tcfg = TrainConfig(steps=4, global_batch=2, seq_len=8, lr=1e-2,
                       warmup_steps=1, skip_budget=2)
    params = lm.init_params(cfg, seed=0, device="cpu")
    before = _clone(params)
    calls = []

    def loss_fn(p, b):  # two good steps, then non-finite ones
        calls.append(1)
        loss, aux = lm.loss_fn(p, b, cfg)
        return (loss if len(calls) <= 2 else loss * float("nan")), aux

    seen = []
    tr = Trainer(cfg, tcfg, loss_fn=loss_fn, params=params, device="cpu")
    state = tr.run(make_lm_batch_iterator(cfg, 2, 8, device="cpu"),
                   steps=4, log_every=1,
                   on_metrics=lambda i, m: seen.append(
                       (m["update_skipped"], m["consec_skips"])))
    assert seen == [(0.0, 0.0), (0.0, 0.0), (1.0, 1.0), (1.0, 2.0)]
    # the rollback's fresh state holds the weights the trainer was given
    assert int(state.opt.step) == 0
    assert _same_bits(state.params, before)
    assert _same_bits(params, before)


def test_async_checkpoint_is_not_torn_by_an_in_place_update(monkeypatch,
                                                            tmp_path):
    cfg = dataclasses.replace(smoke_config("xlstm-1.3b"), dtype="float32")
    tcfg = TrainConfig(steps=2, global_batch=2, seq_len=8, lr=1e-2,
                       warmup_steps=1)
    state = steps.init_train_state(cfg, tcfg, device="cpu")
    step = steps.build_train_step(cfg, tcfg)
    batches = make_lm_batch_iterator(cfg, 2, 8, seed=0, device="cpu")
    state, _ = step(state, next(batches))
    release = threading.Event()
    savez = np.savez

    def held_savez(*a, **k):  # the writer runs only after the next step
        assert release.wait(60)
        return savez(*a, **k)

    monkeypatch.setattr(ckpt_manager.np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state)
    at_save = (_clone(state.params), _clone(state.opt.mu),
               _clone(state.opt.nu))
    state, _ = step(state, next(batches))   # updates the same tensors
    assert not _same_bits(state.params, at_save[0])
    release.set()
    mgr.wait()
    template = steps.init_train_state(cfg, tcfg, device="cpu")
    got_step, got, _ = mgr.restore(template)
    assert got_step == 1
    assert _same_bits(got.params, at_save[0])
    assert _same_bits((got.opt.mu, got.opt.nu), at_save[1:])
    assert int(got.opt.step) == 1
