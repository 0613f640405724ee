"""The port's examples against the JAX package's, on the same numpy inputs.

  * ``examples/torch_quickstart.py``: the three backward modes (full,
    SHINE, Jacobian-free) for 5 SGD steps from the same parameters and
    data as the JAX quickstart's loop over its own ``f``: every step's loss
    at rtol 1e-3 (both solve with a bf16 quasi-Newton ring, the
    quickstart's ``ImplicitConfig`` default);
  * ``examples/torch_serve_lm.py``: the JAX example's request stream
    through its ``ServeLoop`` and the port's, a smoke config in f32, the
    layer stack and the DEQ: every request's tokens equal;
  * ``examples/torch_train_deq_lm.py``: its ``hundred_m_config`` field by
    field the JAX example's, then at smoke width in f32 two ``Trainer``
    steps from JAX's initial parameters on the same batches: the losses at
    rtol 1e-4;
  * ``lm.param_count`` equal to the JAX package's for all ten configs;
  * each example runs with ``--device cpu`` and, with no card and no
    ``--device``, raises rather than fall back to the CPU.
"""

import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.data.pipeline import make_lm_batch_iterator as jax_batches
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx as JShardCtx
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import make_lm_batch_iterator
from repro_torch.models import lm
from repro_torch.runtime.trainer import Trainer

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)

jquick = importlib.import_module("quickstart")
jserve = importlib.import_module("serve_lm")
jtrain = importlib.import_module("train_deq_lm")
tquick = importlib.import_module("torch_quickstart")
tserve = importlib.import_module("torch_serve_lm")
ttrain = importlib.import_module("torch_train_deq_lm")

QUICK_STEPS = 5
QUICK_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The examples' small tensors on one intra-op thread: with a thread a
    core beside the other test workers, a 64-wide solve waits on its
    threads (16 s against 0.26 s for the quickstart's 5 steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_quick_losses(params, x, y, mode: str, steps: int) -> list[float]:
    """The JAX quickstart's loop (its ``f``, its config), every step's loss
    after the update."""
    from repro.implicit import (
        BackwardConfig,
        ForwardConfig,
        ImplicitConfig,
        implicit_fixed_point,
    )
    cfg = ImplicitConfig(
        forward=ForwardConfig(solver="broyden", max_steps=30, tol=1e-6),
        backward=BackwardConfig(estimator=mode, max_steps=30), memory=30)
    b, d = y.shape

    @jax.jit
    def loss_fn(p):
        z, _ = implicit_fixed_point(jquick.f, p, x, jnp.zeros((b, d)), cfg)
        return jnp.mean((z - y) ** 2)

    grad = jax.jit(jax.grad(loss_fn))
    p, out = params, []
    for _ in range(steps):
        g = grad(p)
        p = jax.tree_util.tree_map(lambda a, gg: a - 0.05 * gg, p, g)
        out.append(float(loss_fn(p)))
    return out


@pytest.mark.parametrize("mode", [m for m, _ in tquick.MODES])
def test_quickstart_losses_match_jax(mode):
    params, x, y = tquick.make_problem(torch.device("cpu"))
    got, _ = tquick.train(params, x, y, mode, steps=QUICK_STEPS,
                          log_every=1)
    want = _jax_quick_losses(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), mode, QUICK_STEPS)
    assert len(got) == QUICK_STEPS
    np.testing.assert_allclose(got, want, rtol=QUICK_RTOL)
    assert got[-1] < got[0]


def _f32(cfg):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.deq.enabled:
        cfg = dataclasses.replace(cfg, deq=dataclasses.replace(
            cfg.deq, qn_dtype="float32"))
    return cfg


@pytest.mark.parametrize("deq", [False, True])
def test_serve_lm_tokens_match_jax(deq):
    from repro.configs.registry import smoke_config as jsmoke
    from repro_torch.configs.registry import smoke_config

    jcfg = _f32(jsmoke("stablelm-3b", deq=deq))
    cfg = _f32(smoke_config("stablelm-3b", deq=deq))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    reqs = tserve.make_requests(cfg.vocab_size, 12)
    # the JAX example's own draw of the stream
    rng = np.random.default_rng(0)
    jreqs = [jserve.Request(
        uid=i, prompt=rng.integers(2, jcfg.vocab_size,
                                   size=int(rng.integers(4, 16))).tolist(),
        max_new_tokens=12) for i in range(12)]
    assert [r.prompt for r in reqs] == [r.prompt for r in jreqs]
    tserve.serve(params, cfg, reqs, slots=4)
    jserve.ServeLoop(jparams, jcfg, JShardCtx.for_mesh(None), slots=4,
                     max_len=96, eos_id=-1).drain(jreqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 12 for r in reqs)


def _fields(cfg) -> dict:
    return {f.name: (_fields(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


SMOKE_WIDTH = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                   d_ff=128, vocab_size=503, head_dim=16, max_seq=64)


def test_train_deq_lm_config_and_two_steps_match_jax():
    args = ("phi3-mini-3.8b", "shine_fallback", True)
    cfg, jcfg = ttrain.hundred_m_config(*args), jtrain.hundred_m_config(*args)
    assert _fields(cfg) == _fields(jcfg)
    assert lm.param_count(cfg) == jlm.param_count(jcfg)
    cfg = _f32(dataclasses.replace(cfg, **SMOKE_WIDTH))
    jcfg = _f32(dataclasses.replace(jcfg, **SMOKE_WIDTH))
    batch, seq, steps = 2, 16, 2
    tcfg = ttrain.train_config(cfg, steps, batch, seq, None)
    from repro.configs.base import TrainConfig as JTrainConfig
    jtcfg = JTrainConfig(**{f.name: getattr(tcfg, f.name)
                            for f in dataclasses.fields(JTrainConfig)})

    jlosses, losses = [], []
    jctx = JShardCtx.for_mesh(None)
    jb = jax_batches(jcfg, jctx, batch, seq, seed=0)
    JTrainer(jcfg, jtcfg, jctx).run(
        jb, steps=steps, log_every=1,
        on_metrics=lambda i, m: jlosses.append(float(m["loss"])))
    jb.close()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(jtcfg.seed))
    params = lm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    Trainer(cfg, tcfg, device="cpu", params=params).run(
        make_lm_batch_iterator(cfg, batch, seq, seed=0, device="cpu"),
        steps=steps, log_every=1,
        on_metrics=lambda i, m: losses.append(float(m["loss"])))
    assert len(losses) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_param_count_equals_jax_for_every_config():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name, cfg in ARCHS.items():
        assert lm.param_count(cfg) == jlm.param_count(JARCHS[name]), name


def test_examples_run_on_the_cpu_and_raise_without_a_card(tmp_path,
                                                          capsys):
    reqs = tserve.main(["--device", "cpu", "--requests", "3"])
    assert len(reqs) == 3 and all(len(r.out) == 12 for r in reqs)
    assert "served 3 requests / 36 tokens" in capsys.readouterr().out
    state = ttrain.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                         "--seq", "16", "--checkpoint-dir",
                         str(tmp_path / "ck")])
    assert int(state.step) == 1
    out = capsys.readouterr().out
    assert "family=dense deq=True backward=shine_fallback" in out
    assert "done at step 1" in out
    if torch.cuda.is_available():
        return
    for main in (tquick.main, tserve.main, ttrain.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([])
