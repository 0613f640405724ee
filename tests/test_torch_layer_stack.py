"""The layer-stack LM (no DEQ) and the MoE families against the JAX
package, on the CPU.

For ``minicpm-2b`` with the DEQ off, ``deepseek-moe-16b`` (GQA + MoE) and
``deepseek-v2-lite-16b`` (MLA + MoE), at their smoke configs in f32, with
the parameters drawn by the JAX package and carried over through numpy:

  * ``forward`` logits (rtol 1e-4) and ``loss_fn`` (the MoE's weighted
    aux losses included; rtol 1e-5);
  * ``prefill`` then three ``decode_step`` calls: logits and every cache
    leaf (``group{i}`` trees; MLA's ``c_kv``/``k_pe``) at rtol 1e-4;
  * the port's own check of the reference's
    ``tests/test_archs.py::test_prefill_decode_matches_forward``: prefill
    over S tokens then one decode step give a full forward's logits over
    S + 1 (there in bf16 at 3e-2 / 4e-2; here in f32 at 1e-4, and for the
    MoE configs at a capacity factor that drops no token);
  * a non-DEQ ``ServeLoop``, sync and async, gives the JAX sync loop's
    tokens (logits at rtol 1e-4), with no carries and a no-op prefix cache.

Also the DEQ mode of ``deepseek-moe-16b`` (the reference's ``DEQ_ARCHS``):
forward logits, the prefill and decode solves' step counts and statuses;
the launcher without ``--deq`` for both DeepSeek configs and both
pipelines; ``params_from_jax`` over the group trees; ``init_params``,
which draws a 4-dim leaf a layer at a time with the reference's fan-in;
and that the new modules import neither JAX nor the JAX package.
"""

import dataclasses
import math
import os
import re
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
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import lm as tlm
from repro_torch.runtime.serving import Request, ServeLoop, cache_leaves

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("minicpm-2b", "deepseek-moe-16b", "deepseek-v2-lite-16b")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _setup(arch, deq=False):
    jcfg = dataclasses.replace(jax_smoke_config(arch, deq=deq),
                               dtype="float32")
    tcfg = dataclasses.replace(smoke_config(arch, deq=deq), dtype="float32")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if deq:
        jp["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                  jp["deq_blocks"])
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    return (request.param,) + _setup(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size,
                                                size=(b, s))


def test_forward_and_loss_match_jax(arch_setup):
    arch, jcfg, tcfg, jp, tp = arch_setup
    toks = _tokens(jcfg, 2, 12, 0)
    tgts = _tokens(jcfg, 2, 12, 1)
    jl, jaux = jax.jit(lambda p, t: jlm.forward(
        p, {"tokens": t}, jcfg, CTX, train=False))(jp, jnp.asarray(toks))
    tl, taux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)
    jloss, _ = jax.jit(lambda p, t, g: jlm.loss_fn(
        p, {"tokens": t, "targets": g}, jcfg, CTX))(
            jp, jnp.asarray(toks), jnp.asarray(tgts))
    tloss, tmet = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(tgts)}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if jcfg.family == "moe":
        assert float(tmet["moe_aux"]) > 0 and float(tmet["moe_z"]) > 0


def test_prefill_and_decode_match_jax(arch_setup):
    arch, jcfg, tcfg, jp, tp = arch_setup
    b, s, max_len = 2, 7, 16
    toks = _tokens(jcfg, b, s, 2)
    jl, jc, jlens = jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, jcfg, CTX, max_len))(jp, jnp.asarray(toks))
    tl, tc, tlens = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                tcfg, max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    jdec = jax.jit(lambda p, c, t, i: jlm.decode_step(p, c, t, i, jcfg, CTX))
    idx = np.asarray(jlens)
    for step in range(3):
        tok = _tokens(jcfg, b, 1, 10 + step)[:, 0].astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(idx))
        tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.from_numpy(idx.copy()), tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        idx = idx + 1
    assert sorted(tc) == sorted(jc)
    for key in tc:
        for tt, jt in zip(tc[key], jc[key]):
            assert tuple(tt.shape) == tuple(jt.shape)
            np.testing.assert_allclose(_np(tt), _np(jt), **TOL)


def test_prefill_then_decode_is_the_forward(arch_setup):
    arch, jcfg, tcfg, jp, tp = arch_setup
    if tcfg.family == "moe":
        # dropless: experts keep tokens first come first served in the
        # flattened (batch, seq) order, so over S and S + 1 tokens a full
        # expert drops different ones (the reference's semantics too)
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=tcfg.moe.num_experts / tcfg.moe.top_k))
    b, s = 2, 17
    toks = torch.from_numpy(_tokens(tcfg, b, s + 1, 3))
    full, _ = tlm.forward(tp, {"tokens": toks}, tcfg)
    pre, caches, lens = tlm.prefill(tp, {"tokens": toks[:, :s]}, tcfg, 32)
    np.testing.assert_allclose(_np(pre[:, -1]), _np(full[:, s - 1]), **TOL)
    dec, _ = tlm.decode_step(tp, caches, toks[:, s], lens, tcfg)
    np.testing.assert_allclose(_np(dec), _np(full[:, s]), **TOL)


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_serve_loop_without_deq_matches_jax(arch_setup, pipeline):
    arch, jcfg, tcfg, jp, tp = arch_setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).tolist()
               for n in (5, 8, 5, 8)]
    jloop = JServeLoop(jp, jcfg, CTX, slots=2, max_len=24, pipeline="sync",
                       record=True)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    jloop.drain(jreqs)
    tloop = ServeLoop(tp, tcfg, slots=2, max_len=24, pipeline=pipeline,
                      record=True, prefix_cache=True)
    assert tloop.carries is None and tloop.prefix is None \
        and tloop.prefix_store is None and not tloop._guarded
    treqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    tloop.drain(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 3 and r.error is None for r in treqs)
    assert tloop.prefill_calls == jloop.prefill_calls
    for uid, logits_j in jloop.recorded_logits.items():
        logits_t = tloop.recorded_logits[uid]
        assert len(logits_t) == len(logits_j)
        for a, b in zip(logits_t, logits_j):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **TOL)
    assert {s["steps"] for s in tloop.solve_log} == {0.0}


def test_deq_mode_of_deepseek_moe_matches_jax():
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b", deq=True)
    b, s, max_len = 2, 6, 16
    toks = _tokens(jcfg, b, s, 4)
    jl, _ = jax.jit(lambda p, t: jlm.forward(
        p, {"tokens": t}, jcfg, CTX, train=False))(jp, jnp.asarray(toks))
    tl, taux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert "moe_aux" not in taux  # the solve keeps no block aux, as in JAX
    pc, pl = jlm.prefix_seed_carry(jcfg, b, s, [None] * b)  # all cold
    jl, jc, _, jseed, _, jsteps, jst = jax.jit(
        lambda p, t, c, q, n: jlm.prefill(
            p, {"tokens": t}, jcfg, CTX, max_len, carry=c, prefix_carry=q,
            prefix_len=n, return_status=True))(
        jp, jnp.asarray(toks, jnp.int32), jlm.deq_solve_carry(jcfg, b, 1),
        pc, pl)
    tl, tc, _, tseed, tsteps, tst = tlm.prefill(
        tp, {"tokens": torch.from_numpy(toks)}, tcfg, max_len,
        carry=tlm.deq_solve_carry(tcfg, b, 1, "cpu"), return_steps=True,
        return_status=True)
    assert tsteps == float(jsteps)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    active = np.array([True, False])
    idx = np.full((b,), s, np.int32)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    jdec = jax.jit(lambda p, c, t, i, a, cy: jlm.decode_step(
        p, c, t, i, jcfg, CTX, active=a, carry=cy, return_steps=True,
        return_status=True))
    for _ in range(2):
        jl, jc, jseed, jsteps, jst = jdec(
            jp, jc, jnp.asarray(tok), jnp.asarray(idx), jnp.asarray(active),
            jseed)
        tl, tc, tseed, tsteps, tst = tlm.decode_step(
            tp, tc, torch.from_numpy(tok), torch.from_numpy(idx), tcfg,
            active=torch.from_numpy(active), carry=tseed, return_steps=True,
            return_status=True)
        assert tsteps == float(jsteps)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        idx = idx + active.astype(np.int32)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b"])
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_serve_launcher_runs_without_deq(arch, pipeline, capsys):
    serve_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--slots", "2",
                         "--max-new-tokens", "3", "--pipeline", pipeline])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    assert "served 3 requests, 9 tokens" in out
    assert f"{pipeline} pipeline: 0 blocking host syncs" in out


def test_serve_launcher_module_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-v2-lite-16b", "--smoke", "--device", "cpu", "--requests",
         "2", "--slots", "2", "--max-new-tokens", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 2 requests, 4 tokens" in out.stdout


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b"])
def test_params_from_jax_covers_the_group_trees(arch):
    cfg = jax_smoke_config(arch)  # bf16 parameters
    params = jlm.init_params(cfg, jax.random.PRNGKey(3))
    tparams = tlm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    decl = tlm.model_decl(smoke_config(arch))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        t, d = tparams, decl
        for p in path:
            t, d = t[p.key], d[p.key]
        assert tuple(t.shape) == tuple(leaf.shape) == d.shape, path
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), _np(leaf))
    assert sorted(k for k in tparams if k.startswith("group")) == [
        "group0", "group1"]
    n = sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    assert n == jlm.param_count(cfg)


def test_init_params_draws_stacked_expert_leaves_by_layer():
    cfg = smoke_config("deepseek-v2-lite-16b")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    decl = tlm.model_decl(cfg)
    wi_g = params["group1"]["moe"]["wi_g"]
    assert tuple(wi_g.shape) == decl["group1"]["moe"]["wi_g"].shape
    assert wi_g.dtype == torch.bfloat16 and wi_g.ndim == 4
    # the reference's fan-in: every dim but the last, stacked axis included
    want_std = 1 / math.sqrt(math.prod(wi_g.shape[:-1]))
    got = wi_g.float()
    # a normal truncated to [-2, 2] std has std 0.88 of the untruncated one
    assert abs(float(got.std()) / want_std - 0.88) < 0.05
    assert float(got.abs().max()) <= 2 * want_std * 1.01
    # each layer its own draw
    assert not torch.equal(wi_g[0], wi_g[1])
    assert params["group0"]["mlp"]["wi_g"].shape[-1] == cfg.moe.dense_d_ff
    leaves = cache_leaves(tlm.init_cache(cfg, 3, 8, "cpu"))
    assert [tuple(t.shape) for t in leaves] == [
        (1, 3, 8, cfg.mla.kv_lora_rank), (1, 3, 8, cfg.mla.qk_rope_dim),
        (2, 3, 8, cfg.mla.kv_lora_rank), (2, 3, 8, cfg.mla.qk_rope_dim)]


@pytest.mark.parametrize("path", ["models/moe.py", "models/attention.py",
                                  "configs/deepseek_v2_lite_16b.py",
                                  "configs/deepseek_moe_16b.py"])
def test_moe_and_mla_modules_import_neither_jax_nor_repro(path):
    src = open(os.path.join(REPO, "src", "repro_torch", path)).read()
    assert not re.search(r"^\s*(import|from) (jax|repro)\b", src, re.M), path
