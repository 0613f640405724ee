"""Training the layer stack (no DEQ), with the reference's
rematerialisation, against the JAX package, on the CPU.

  * ``remat`` none / full / dots give the same loss and the same gradient
    leaves in f32 (to 1e-6): rematerialisation changes what is kept for the
    backward, not what is computed; for ``deepseek-v2-lite-16b`` (MLA +
    MoE), ``zamba2-2.7b`` (Mamba2 + the shared block) and ``xlstm-1.3b``
    (mLSTM + sLSTM) smoke configs;
  * ``build_train_step`` against the JAX package's for 3 AdamW steps
    (loss rtol 1e-4, grad norm 2e-3, lr 1e-6, and the updated parameters)
    for ``deepseek-v2-lite-16b``, ``deepseek-moe-16b``, ``zamba2-2.7b`` and
    ``xlstm-1.3b`` without the DEQ, and ``deepseek-moe-16b`` with it (the
    same solver steps every step; the weight-tied blocks scaled by 0.3 and
    an f32 ring, as in ``tests/test_torch_training.py``);
  * ``python -m repro_torch.launch.train`` without ``--deq`` on the CPU
    ends with ``finished at step 2``; with ``--device`` left at the card it
    raises here.
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
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

CTX = ShardCtx.for_mesh(None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _cfgs(arch, deq=False):
    out = []
    for make in (jax_smoke_config, smoke_config):
        cfg = dataclasses.replace(make(arch, deq=deq), dtype="float32")
        if deq:
            cfg = dataclasses.replace(cfg, deq=dataclasses.replace(
                cfg.deq, qn_dtype="float32"))
        out.append(cfg)
    return out


def _params(jcfg, deq=False):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if deq:
        jp["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                  jp["deq_blocks"])
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _batch(index, vocab):
    toks = JDataset(vocab, 0).batch(index, B, S + 1)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])})


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "xlstm-1.3b"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    _, tcfg = _cfgs(arch)
    _, npp = _params(_cfgs(arch)[0])
    _, tb = _batch(0, tcfg.vocab_size)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = jax.tree_util.tree_map(
            lambda a: a.requires_grad_(True), tlm.params_from_jax(npp, "cpu"))
        loss, _ = tlm.loss_fn(leaves, tb, cfg)
        loss.backward()
        out[remat] = (loss.item(), {p: _np(t.grad)
                                    for p, t in _leaves(leaves)})
    for remat in ("full", "dots"):
        np.testing.assert_allclose(out[remat][0], out["none"][0], rtol=1e-6)
        for p, g in out["none"][1].items():
            np.testing.assert_allclose(out[remat][1][p], g, rtol=1e-6,
                                       atol=1e-6 * np.abs(g).max(),
                                       err_msg=f"{remat} {p}")


def test_remat_wrap_checkpoints_only_in_training():
    cfg = smoke_config("zamba2-2.7b")

    def fn(x):
        return x * 2

    assert tlm._remat_wrap(fn, cfg, train=False) is fn
    assert tlm._remat_wrap(fn, dataclasses.replace(cfg, remat="none"),
                           train=True) is fn
    for remat in ("full", "dots"):
        wrapped = tlm._remat_wrap(fn, dataclasses.replace(cfg, remat=remat),
                                  train=True)
        assert wrapped is not fn
        assert float(wrapped(torch.ones(()))) == 2.0
    with pytest.raises(ValueError, match="remat"):
        tlm._remat_wrap(fn, dataclasses.replace(cfg, remat="some"), True)


@pytest.mark.parametrize("remat,calls", [("none", 6), ("full", 12),
                                         ("dots", 12)])
def test_remat_recomputes_the_units_in_the_backward(monkeypatch, remat,
                                                    calls):
    """Every Mamba layer runs once in the forward, and once more in the
    backward when the unit is rematerialised."""
    from repro_torch.models import ssm as tssm
    cfg = dataclasses.replace(smoke_config("zamba2-2.7b"), dtype="float32",
                              remat=remat)
    params = jax.tree_util.tree_map(lambda a: a.requires_grad_(True),
                                    tlm.init_params(cfg, seed=0,
                                                    device="cpu"))
    seen = []
    block = tssm.mamba2_block

    def counted(*a, **k):
        seen.append(1)
        return block(*a, **k)

    monkeypatch.setattr(tssm, "mamba2_block", counted)
    _, tb = _batch(0, cfg.vocab_size)
    loss, _ = tlm.loss_fn(params, tb, cfg)
    assert len(seen) == 6
    loss.backward()
    assert len(seen) == calls


def _jax_state(jp, jcfg, jtcfg):
    carry = (jlm.deq_solve_carry(jcfg, B, S)
             if jsteps.train_carry_enabled(jcfg, jtcfg) else None)
    return jsteps.TrainState(jnp.zeros((), jnp.int32), jp,
                             jopt.adamw_init(jp), carry,
                             jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("arch,deq", [("deepseek-v2-lite-16b", False),
                                      ("deepseek-moe-16b", False),
                                      ("zamba2-2.7b", False),
                                      ("deepseek-moe-16b", True),
                                      ("xlstm-1.3b", False)])
def test_three_train_steps_match_jax(arch, deq):
    jcfg, tcfg = _cfgs(arch, deq)
    jp, npp = _params(jcfg, deq)
    kw = dict(steps=3, global_batch=B, seq_len=S, lr=1e-3, warmup_steps=2)
    jtcfg, ttcfg = JTrainConfig(zero1=False, **kw), TrainConfig(**kw)
    jstep = jax.jit(jsteps.build_train_step(jcfg, jtcfg, CTX))
    tstep = tsteps.build_train_step(tcfg, ttcfg)
    js = _jax_state(jp, jcfg, jtcfg)
    ts = tsteps.init_train_state(tcfg, ttcfg,
                                 params=tlm.params_from_jax(npp, "cpu"))
    assert (ts.carry is None) == (not deq)
    for i in range(3):
        jb, tb = _batch(i, jcfg.vocab_size)
        js, mj = jstep(js, jb)
        ts, mt = tstep(ts, tb)
        if deq:
            assert mt["deq_steps"] == float(mj["deq_steps"]), i
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=2e-3)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        assert float(mt["update_skipped"]) == 0.0
    assert int(ts.step) == 3 and int(ts.opt.step) == 3
    jleaves = dict(_leaves(js.params))
    for path, t in _leaves(ts.params):
        want = _np(jleaves[path])
        np.testing.assert_allclose(_np(t), want, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(want).max(), 1.0),
                                   err_msg=path)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "xlstm-1.3b"])
def test_train_launcher_runs_without_deq(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--smoke", "--steps", "2", "--batch", "2", "--seq", "16"]
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"arch={arch}" in out.stdout and "deq=False" in out.stdout
    assert "remat=full" in out.stdout
    assert out.stdout.rstrip().endswith("finished at step 2")
    if not torch.cuda.is_available():  # the card is the default: no fallback
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=300, cwd=REPO)
        assert out.returncode != 0
        assert "none is available" in out.stderr
