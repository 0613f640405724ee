"""The port's training slice against the JAX package's.

The same parameters (drawn by the JAX package, weight-tied blocks scaled by
0.3 so the solves converge, carried over by ``params_from_jax``) and the
same numpy-drawn batches (``SyntheticTokenDataset``, one recipe in both
packages) go through both packages on the CPU at the minicpm smoke config:

  * ``loss_fn``'s value and every gradient leaf against
    ``jax.value_and_grad(repro.models.lm.loss_fn)``: f32 activations with an
    f32 ring (tight) and with the default bf16 ring (loose);
  * a 3-step ``build_train_step`` trajectory (loss, grad norm, lr, solver
    steps) for ``deq_carry`` in state, full and off;
  * ``adamw_update``, ``clip_by_global_norm`` and the three schedules;
  * the trainer's checkpoint save / restore / resume, lean checkpoints,
    corruption fallback, rollback, and restart-safe batches (as
    ``tests/test_runtime.py`` holds the JAX trainer);
  * the launcher end to end on the CPU, and its rejection of an unknown
    ``--backward``.

Tolerances.  The loss is held at rtol 1e-5 and the forward solves must take
the same number of steps.  The gradients pass through the SHINE backward,
which applies the inverse each package builds from its own Broyden pairs:
f32 rounding of the iterates moves the last pairs (see
``tests/test_torch_estimators.py``), so gradients are held at rtol 1e-2
plus an atol of 1e-3 x each leaf's largest entry (f32 ring) and 3e-2 /
3e-2 x (bf16 ring, where one flipped bf16 rounding of a stored pair moves
later ones); along the trajectory the loss at rtol 1e-4 and the grad norm
at rtol 2e-3.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticTokenDataset as JDataset
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.parallel.sharding import ShardCtx
from repro_torch.checkpoint.manager import (
    CheckpointCorruptionError,
    CheckpointManager,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import (
    SyntheticTokenDataset,
    make_lm_batch_iterator,
)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.runtime.trainer import Trainer

CTX = ShardCtx.for_mesh(None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 8


def _cfg(make, qn_dtype="float32"):
    cfg = make("minicpm-2b", deq=True)
    return dataclasses.replace(
        cfg, dtype="float32",
        deq=dataclasses.replace(cfg.deq, qn_dtype=qn_dtype))


@pytest.fixture(scope="module")
def params():
    """JAX parameters (blocks x0.3) as a JAX tree and as numpy."""
    p = jlm.init_params(_cfg(jax_smoke_config), jax.random.PRNGKey(0))
    p["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                             p["deq_blocks"])
    return p, jax.tree_util.tree_map(np.asarray, p)


def _batch(index, vocab, seed=0):
    toks = JDataset(vocab, seed).batch(index, B, S + 1)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])})


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("qn_dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_leaf_match_jax(params, qn_dtype):
    jp, npp = params
    jcfg, tcfg = _cfg(jax_smoke_config, qn_dtype), _cfg(smoke_config,
                                                        qn_dtype)
    jb, tb = _batch(0, jcfg.vocab_size)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, jcfg, CTX, z_loss=1e-4),
        has_aux=True))(jp)
    tp = jax.tree_util.tree_map(
        lambda a: a.requires_grad_(True), tlm.params_from_jax(npp, "cpu"))
    lt, mt = tlm.loss_fn(tp, tb, tcfg, z_loss=1e-4)
    lt.backward()
    assert mt["deq_steps"] == float(mj["deq_steps"])
    for k in ("nll", "z", "tokens"):
        np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=1e-5)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    rtol, rel = (1e-2, 1e-3) if qn_dtype == "float32" else (3e-2, 3e-2)
    jleaves = dict(_leaves(gj))
    n = 0
    for path, t in _leaves(tp):
        want = _np(jleaves[path])
        assert t.grad is not None, path
        np.testing.assert_allclose(_np(t.grad), want, rtol=rtol,
                                   atol=rel * np.abs(want).max(),
                                   err_msg=path)
        n += 1
    assert n == len(jleaves) == 11


def _jax_state(jp, jcfg, jtcfg):
    carry = (jlm.deq_solve_carry(jcfg, B, S)
             if jsteps.train_carry_enabled(jcfg, jtcfg) else None)
    return jsteps.TrainState(jnp.zeros((), jnp.int32), jp,
                             jopt.adamw_init(jp), carry,
                             jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("mode", ["state", "full", "off"])
def test_three_step_trajectory_matches_jax(params, mode):
    jp, npp = params
    jcfg, tcfg = _cfg(jax_smoke_config), _cfg(smoke_config)
    kw = dict(steps=3, global_batch=B, seq_len=S, lr=1e-3, warmup_steps=2,
              deq_carry=mode)
    jtcfg, ttcfg = JTrainConfig(zero1=False, **kw), TrainConfig(**kw)
    jstep = jax.jit(jsteps.build_train_step(jcfg, jtcfg, CTX))
    tstep = tsteps.build_train_step(tcfg, ttcfg)
    js = _jax_state(jp, jcfg, jtcfg)
    ts = tsteps.init_train_state(tcfg, ttcfg,
                                 params=tlm.params_from_jax(npp, "cpu"))
    assert (ts.carry is None) == (mode == "off")
    for i in range(3):
        jb, tb = _batch(i, jcfg.vocab_size)
        js, mj = jstep(js, jb)
        ts, mt = tstep(ts, tb)
        assert mt["deq_steps"] == float(mj["deq_steps"]), i
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=2e-3)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        assert float(mt["update_skipped"]) == 0.0
    assert int(ts.step) == 3 and int(ts.opt.step) == 3
    if mode != "off":
        np.testing.assert_array_equal(ts.carry.age.numpy(),
                                      np.asarray(js.carry.age))


def test_grad_accum_matches_full_batch(params):
    """accum=2 over a split batch == one step over the whole batch (the
    solves are per row: a converged row is frozen, so splitting the batch
    does not change its iterates)."""
    _, npp = params
    tcfg = _cfg(smoke_config)
    _, tb = _batch(0, tcfg.vocab_size)
    out = {}
    for accum in (1, 2):
        ttcfg = TrainConfig(steps=1, global_batch=B, seq_len=S,
                            grad_accum=accum, clip_norm=1e9)
        state = tsteps.init_train_state(
            tcfg, ttcfg, params=tlm.params_from_jax(npp, "cpu"))
        assert (state.carry is None) == (accum == 2)
        new, m = tsteps.build_train_step(tcfg, ttcfg)(state, tb)
        out[accum] = (new.params["deq_blocks"]["attn"]["wq"], m["loss"])
    np.testing.assert_allclose(float(out[1][1]), float(out[2][1]), rtol=1e-5)
    np.testing.assert_allclose(out[1][0].numpy(), out[2][0].numpy(),
                               rtol=2e-2, atol=2e-4)


def test_adamw_clip_and_schedules_match_jax():
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 6), "b": (6,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) * 3
         for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(3):
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) * (step + 1) for k, v in g.items()}, 1.0)
        tg, tn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v) * (step + 1) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, jst = jopt.adamw_update(jg, jst, jp, jnp.float32(1e-2))
        tp, tst = topt.adamw_update(tg, tst, tp, torch.tensor(1e-2))
    for k in shapes:  # decay on the matrix only; f32 moments
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.nu[k].numpy(), np.asarray(jst.nu[k]),
                                   rtol=1e-6)
        assert tst.mu[k].dtype == torch.float32
    jq, jm = jopt.sgdm_update(jg, jst, jp, jnp.float32(1e-2),
                              weight_decay=0.1)
    tq, tm = topt.sgdm_update(tg, tst, tp, torch.tensor(1e-2),
                              weight_decay=0.1)
    for k in shapes:
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]),
                                   rtol=1e-6, atol=1e-7)
    assert int(tm.step) == int(jm.step) == 4
    for sched in ("cosine", "wsd", "linear"):
        kw = dict(steps=40, lr=3e-4, warmup_steps=10, schedule=sched)
        fj = jopt.make_schedule(JTrainConfig(**kw))
        ft = topt.make_schedule(TrainConfig(**kw))
        got = [float(ft(torch.tensor(s, dtype=torch.int32)))
               for s in range(45)]
        want = [float(fj(jnp.int32(s))) for s in range(45)]
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=sched)


def _tiny():
    cfg = smoke_config("minicpm-2b", deq=True)
    return dataclasses.replace(
        cfg, dtype="float32", d_model=32, num_heads=2, num_kv_heads=2,
        d_ff=64, vocab_size=128, head_dim=16,
        deq=dataclasses.replace(cfg.deq, max_steps=4))


def test_checkpoint_save_restore_resume(tmp_path):
    cfg = _tiny()
    tcfg = TrainConfig(steps=4, global_batch=2, seq_len=8, lr=1e-3,
                       checkpoint_dir=str(tmp_path), checkpoint_every=2)
    tr = Trainer(cfg, tcfg, device="cpu")
    state = tr.run(make_lm_batch_iterator(cfg, 2, 8, device="cpu"),
                   steps=4, log_every=100)
    assert int(state.step) == 4 and tr.ckpt.all_steps() == [2, 4]
    tr2 = Trainer(cfg, dataclasses.replace(tcfg, steps=6), device="cpu")
    restored = tr2.restore_or_init()
    assert int(restored.step) == 4 and int(restored.opt.step) == 4
    for (path, a), (_, b) in zip(_leaves(state.params),
                                 _leaves(restored.params)):
        assert torch.equal(a, b), path
    assert torch.equal(state.carry.z, restored.carry.z)
    assert torch.equal(state.carry.lowrank.u, restored.carry.lowrank.u)
    assert restored.carry.lowrank.u.dtype == torch.bfloat16
    # resume: the loop starts at the restored step and runs to 6
    seen = []
    tr2.run(make_lm_batch_iterator(cfg, 2, 8, start_step=4, device="cpu"),
            steps=6, log_every=1, on_metrics=lambda i, m: seen.append(i))
    assert seen == [5, 6]


def test_lean_checkpoint_zero_fills_the_ring(tmp_path):
    cfg = _tiny()
    tcfg = TrainConfig(steps=2, global_batch=2, seq_len=8,
                       checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       checkpoint_lean=True)
    tr = Trainer(cfg, tcfg, device="cpu")
    state = tr.run(make_lm_batch_iterator(cfg, 2, 8, device="cpu"),
                   steps=2, log_every=100)
    restored = tr.restore_or_init()
    assert float(state.carry.lowrank.u.abs().sum()) > 0
    assert float(restored.carry.lowrank.u.abs().sum()) == 0.0
    assert torch.equal(restored.carry.z, state.carry.z)


def test_checkpoint_atomicity_keep_and_corruption_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"w": torch.arange(4.0), "h": torch.ones(3, dtype=torch.bfloat16)}
    for s in (1, 2, 3):
        mgr.save(s, {k: v * s for k, v in tree.items()})
    assert mgr.all_steps() == [2, 3]
    os.makedirs(os.path.join(str(tmp_path), "step_4.tmp"))  # a crashed save
    assert mgr.latest_step() == 3
    with open(os.path.join(str(tmp_path), "step_3", "arrays.npz"), "wb") as f:
        f.write(b"truncated")
    step, state, _ = mgr.restore({k: torch.zeros_like(v)
                                  for k, v in tree.items()})
    assert step == 2 and state["h"].dtype == torch.bfloat16
    assert torch.equal(state["w"], torch.arange(4.0) * 2)
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(tree, step=3)


def test_rollback_past_the_skip_budget():
    cfg = _tiny()
    tcfg = TrainConfig(steps=3, global_batch=2, seq_len=8, skip_budget=2)

    def nan_loss(p, b):
        return p["final_norm"]["scale"].sum() * float("nan"), {}

    tr = Trainer(cfg, tcfg, loss_fn=nan_loss, device="cpu")
    seen = []
    state = tr.run(make_lm_batch_iterator(cfg, 2, 8, device="cpu"),
                   steps=3, log_every=1,
                   on_metrics=lambda i, m: seen.append(
                       (m["update_skipped"], m["consec_skips"])))
    assert seen == [(1.0, 1.0), (1.0, 2.0), (1.0, 1.0)]  # rolled back once
    assert int(state.opt.step) == 0 and state.carry is None


def test_batches_are_restart_safe_and_match_jax():
    cfg = _tiny()
    it = make_lm_batch_iterator(cfg, 4, 8, seed=7, device="cpu")
    b0, b1 = next(it), next(it)
    b1_again = next(make_lm_batch_iterator(cfg, 4, 8, seed=7, start_step=1,
                                           device="cpu"))
    assert torch.equal(b1["tokens"], b1_again["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    want = JDataset(cfg.vocab_size, 7).batch(1, 4, 9)
    np.testing.assert_array_equal(
        SyntheticTokenDataset(cfg.vocab_size, 7).batch(1, 4, 9), want)
    np.testing.assert_array_equal(b1["targets"].numpy(), want[:, 1:])


def test_launcher_rejects_unknown_backward(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--smoke", "--deq", "--device", "cpu",
                      "--backward", "no_such_estimator"])
    err = capsys.readouterr().err
    assert "no_such_estimator" in err
    for name in ("full", "jfb", "shine", "shine_fallback", "shine_refine",
                 "shine_cascade", "jfb_refine"):
        assert name in err


def test_train_launcher_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm-2b", "--smoke", "--deq", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--checkpoint-dir",
         str(tmp_path / "ck"), "--checkpoint-every", "1", "--metrics-out",
         str(tmp_path / "m.json")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "finished at step 2" in out.stdout
    assert "step     2 loss=" in out.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1", "step_2"]
