"""The port's serving slice against the JAX package's.

The same parameters (drawn by the JAX package, carried over as numpy through
``params_from_jax``) and the same numpy-drawn prompts go through both
packages on the CPU, in f32, at a small DEQ config (the ``_deq_cfg`` pattern
of ``tests/test_prefix_cache.py``, weight-tied blocks scaled by 0.3 so the
cold solves converge):

  * prefill logits, KV caches and the solve's step count;
  * three warm-started decode steps (one slot frozen): logits, step counts,
    statuses;
  * a ``ServeLoop(pipeline="sync", record=True)`` drain of 6 requests over 2
    slots with mixed prompt lengths: identical greedy tokens, identical
    recorded per-solve step counts, logits within 1e-4;
  * the launcher end to end on the CPU.
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

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx
from repro.runtime.serving import Request as JRequest
from repro.runtime.serving import ServeLoop as JServeLoop
from repro_torch.configs.registry import smoke_config
from repro_torch.models import lm as tlm
from repro_torch.runtime.serving import Request, ServeLoop

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small(cfg):
    return dataclasses.replace(
        cfg, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=40, tol=1e-4, memory=16))


@pytest.fixture(scope="module")
def setup():
    jcfg = _small(jax_smoke_config("minicpm-2b", deq=True))
    tcfg = _small(smoke_config("minicpm-2b", deq=True))
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params["deq_blocks"] = jax.tree_util.tree_map(
        lambda a: a * 0.3, params["deq_blocks"])
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, tlm.params_from_jax(np_params, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_params_from_jax_round_trip():
    cfg = jax_smoke_config("minicpm-2b", deq=True)  # bf16 parameters
    params = jlm.init_params(cfg, jax.random.PRNGKey(3))
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    tparams = tlm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    decl = tlm.model_decl(smoke_config("minicpm-2b", deq=True))
    n = 0
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t, d = tparams, decl
        for k in keys:
            t, d = t[k], d[k]
        assert tuple(t.shape) == tuple(leaf.shape) == d.shape, keys
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), _np(leaf))
        n += 1
    assert n == 11  # embed, final norm, 2 norms + 4 attn + 3 mlp per block


def test_prefill_and_decode_match_jax(setup):
    jcfg, tcfg, jparams, tparams = setup
    b, s, max_len = 3, 6, 16
    toks = np.random.default_rng(1).integers(2, jcfg.vocab_size, size=(b, s))
    pc, pl = jlm.prefix_seed_carry(jcfg, b, s, [None] * b)  # all miss = cold
    jl, jc, _, jseed, _, jsteps = jlm.prefill(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg, CTX,
        max_len, carry=jlm.deq_solve_carry(jcfg, b, 1), prefix_carry=pc,
        prefix_len=pl)
    tl, tc, _, tseed, tsteps = tlm.prefill(
        tparams, {"tokens": torch.tensor(toks, dtype=torch.int32)}, tcfg,
        max_len, carry=tlm.deq_solve_carry(tcfg, b, 1, "cpu"),
        return_steps=True)
    assert tsteps == float(jsteps) and tsteps > 2
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for jt, tt in zip(jc["deq"], tc["deq"]):
        np.testing.assert_allclose(_np(tt), _np(jt), **TOL)
    np.testing.assert_allclose(_np(tseed.z), _np(jseed.z), **TOL)

    active = np.array([True, False, True])
    idx = np.full((b,), s, np.int32)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    for _ in range(3):
        jl, jc, jseed, jsteps, jst = jlm.decode_step(
            jparams, jc, jnp.asarray(tok), jnp.asarray(idx), jcfg, CTX,
            active=jnp.asarray(active), carry=jseed, return_steps=True,
            return_status=True)
        tl, tc, tseed, tsteps, tst = tlm.decode_step(
            tparams, tc, torch.from_numpy(tok), torch.from_numpy(idx), tcfg,
            active=torch.from_numpy(active), carry=tseed, return_steps=True,
            return_status=True)
        assert tsteps == float(jsteps)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_array_equal(tseed.age.numpy(),
                                      np.asarray(jseed.age))
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        idx = idx + active.astype(np.int32)


def test_serve_loop_drain_matches_jax(setup):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(2)
    lens = [5, 9, 5, 9, 9, 5]
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).tolist()
               for n in lens]
    jloop = JServeLoop(jparams, jcfg, CTX, slots=2, max_len=32,
                       pipeline="sync", record=True)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jloop.drain(jreqs)
    tloop = ServeLoop(tparams, tcfg, slots=2, max_len=32, pipeline="sync",
                      record=True)
    treqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
             for i, p in enumerate(prompts)]
    tloop.drain(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 4 and r.error is None for r in treqs)
    assert tloop.recorded_steps == jloop.recorded_steps
    assert tloop.prefill_calls == jloop.prefill_calls
    for uid, logits_j in jloop.recorded_logits.items():
        logits_t = tloop.recorded_logits[uid]
        assert len(logits_t) == len(logits_j)
        for a, b in zip(logits_t, logits_j):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **TOL)


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--deq", "--device", "cpu", "--requests", "4", "--slots", "2",
         "--max-new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 4 requests, 16 tokens" in out.stdout
