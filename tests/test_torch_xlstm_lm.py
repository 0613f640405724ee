"""The SSM family (xLSTM: units of mLSTM layers and one sLSTM layer)
against the JAX package, on the CPU.

On ``xlstm-1.3b``'s smoke config in f32 (8 layers in two units of 3 mLSTM
+ 1 sLSTM, d 64, 4 heads, chunk 16), with the parameters drawn by the JAX
package and carried over through numpy:

  * ``forward`` logits (rtol 1e-4), ``loss_fn`` (1e-5) and every gradient
    leaf (1e-4);
  * ``prefill`` at S 17 and 37 (padded to two and three chunks) then three
    ``decode_step`` calls: logits and every cache leaf (the stacked
    ``MLSTMCache`` and the ``SLSTMCache``) at rtol 1e-4;
  * ``tests/test_archs.py::test_prefill_decode_matches_forward`` on the
    port (there bf16 at 3e-2 / 4e-2; here f32 at 1e-4);
  * the cache tree (no ``KVCache``, stabilisers at -1e30) and its batch
    axes;
  * ``ServeLoop``, sync and async, gives the JAX sync loop's tokens;
  * the DEQ mode (the reference's ``DEQ_ARCHS``): forward logits, the
    prefill and decode solves' steps and statuses, the stored caches, and
    every gradient leaf within the SHINE tolerance of
    ``tests/test_torch_training.py`` (f32 ring: rtol 1e-2 + 1e-3 x the
    leaf's largest entry);
  * the serve launcher with and without ``--deq`` on ``--device cpu``, and
    the train launcher with ``--deq``;
  * ``init_params``' draw of the nested stacks, and ``params_from_jax``
    over them.
"""

import dataclasses
import math

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
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm as tlm
from repro_torch.runtime.serving import (
    Request,
    ServeLoop,
    cache_batch_axes,
    cache_leaves,
)

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _setup(deq=False):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH, deq=deq),
                               dtype="float32")
    tcfg = dataclasses.replace(smoke_config(ARCH, deq=deq), dtype="float32")
    if deq:
        f32_ring = dict(qn_dtype="float32")
        jcfg = dataclasses.replace(jcfg, deq=dataclasses.replace(
            jcfg.deq, **f32_ring))
        tcfg = dataclasses.replace(tcfg, deq=dataclasses.replace(
            tcfg.deq, **f32_ring))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if deq:  # the weight-tied units scaled so the solves converge
        jp["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                  jp["deq_blocks"])
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def deq_setup():
    return _setup(deq=True)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size,
                                                size=(b, s))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _cache_pairs(tc, jc, path=""):
    """(path, port leaf, JAX leaf) over the port's cache tree, the JAX
    tree indexed by the same keys and fields."""
    if isinstance(tc, dict):
        assert sorted(tc) == sorted(jc), path
        for k in tc:
            yield from _cache_pairs(tc[k], jc[k], f"{path}/{k}")
    elif isinstance(tc, tuple):
        assert tc._fields == jc._fields, path
        for f in tc._fields:
            yield from _cache_pairs(getattr(tc, f), getattr(jc, f),
                                    f"{path}.{f}")
    else:
        yield path, tc, jc


def _grads_match(tp, gj, rtol, rel):
    jleaves = dict(_leaves(gj))
    n = 0
    for path, t in _leaves(tp):
        want = _np(jleaves[path])
        assert t.grad is not None, path
        np.testing.assert_allclose(_np(t.grad), want, rtol=rtol,
                                   atol=rel * np.abs(want).max(),
                                   err_msg=path)
        n += 1
    # embedding, lm_head, final norm; a unit's mLSTM norm + 8 leaves and
    # its sLSTM norm + 6
    assert n == len(jleaves) == 19


def test_forward_loss_and_gradients_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(jcfg, 2, 20, 0)
    tgts = _tokens(jcfg, 2, 20, 1)
    jl, _ = jax.jit(lambda p, t: jlm.forward(
        p, {"tokens": t}, jcfg, CTX, train=False))(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                            train=False)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, jcfg, CTX), has_aux=True))(jp)
    leaves = jax.tree_util.tree_map(lambda a: a.clone().requires_grad_(True),
                                    tp)
    lt, _ = tlm.loss_fn(leaves, {"tokens": torch.from_numpy(toks),
                                 "targets": torch.from_numpy(tgts)}, tcfg)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    _grads_match(leaves, gj, 1e-4, 1e-4)


@pytest.mark.parametrize("seq", [17, 37])
def test_prefill_and_decode_match_jax(setup, seq):
    jcfg, tcfg, jp, tp = setup
    b, max_len = 2, 48
    toks = _tokens(jcfg, b, seq, 2)
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
    pairs = list(_cache_pairs(tc, jc))
    assert [p for p, _, _ in pairs] == [
        "/group0/mlstm.C", "/group0/mlstm.n", "/group0/mlstm.m",
        "/group0/slstm.c", "/group0/slstm.n", "/group0/slstm.h",
        "/group0/slstm.m"]
    for path, tt, jt in pairs:
        assert tuple(tt.shape) == tuple(jt.shape), path
        np.testing.assert_allclose(_np(tt), _np(jt), err_msg=path, **TOL)


def test_prefill_then_decode_is_the_forward(setup):
    _, tcfg, _, tp = setup
    b, s = 2, 17
    toks = torch.from_numpy(_tokens(tcfg, b, s + 1, 3))
    full, _ = tlm.forward(tp, {"tokens": toks}, tcfg, train=False)
    pre, caches, lens = tlm.prefill(tp, {"tokens": toks[:, :s]}, tcfg, 32)
    np.testing.assert_allclose(_np(pre[:, -1]), _np(full[:, s - 1]), **TOL)
    dec, _ = tlm.decode_step(tp, caches, toks[:, s], lens, tcfg)
    np.testing.assert_allclose(_np(dec), _np(full[:, s]), **TOL)


def test_cache_tree_and_batch_axes(setup):
    _, tcfg, _, _ = setup
    caches = tlm.init_cache(tcfg, 3, 8, "cpu")
    assert sorted(caches["group0"]) == ["mlstm", "slstm"]   # no KVCache
    shapes = [tuple(t.shape) for t in cache_leaves(caches)]
    # 2 units x 3 mLSTM layers; 4 heads of 32; the sLSTM's 4 heads of 16
    assert shapes == [(2, 3, 3, 4, 32, 32), (2, 3, 3, 4, 32), (2, 3, 3, 4),
                      (2, 3, 4, 16), (2, 3, 4, 16), (2, 3, 4, 16),
                      (2, 3, 4, 16)]
    assert cache_batch_axes(tcfg) == [2, 2, 2, 1, 1, 1, 1]
    leaves = cache_leaves(caches)
    assert all(t.dtype == torch.float32 for t in leaves)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    neg = float(np.float32(-1e30))
    for t, cold in zip(leaves, (0.0, 0.0, neg, 0.0, 0.0, 0.0, neg)):
        assert bool((t == cold).all())
    # the same tree, leaf for leaf, as the reference's
    jcaches = jlm.init_cache(jax_smoke_config(ARCH), 3, 8)
    for path, tt, jt in _cache_pairs(caches, jcaches):
        np.testing.assert_array_equal(_np(tt), _np(jt), err_msg=path)
    deq = tlm.init_cache(smoke_config(ARCH, deq=True), 3, 8, "cpu")
    assert [tuple(t.shape)[:3] for t in cache_leaves(deq)] == [
        (2, 3, 3)] * 3 + [(2, 3, 4)] * 4


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_serve_loop_matches_jax(setup, pipeline):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).tolist()
               for n in (5, 19, 5, 19)]
    jloop = JServeLoop(jp, jcfg, CTX, slots=2, max_len=32, pipeline="sync",
                       record=True)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    jloop.drain(jreqs)
    tloop = ServeLoop(tp, tcfg, slots=2, max_len=32, pipeline=pipeline,
                      record=True)
    treqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    tloop.drain(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 3 and r.error is None for r in treqs)
    for uid, logits_j in jloop.recorded_logits.items():
        for a, b in zip(tloop.recorded_logits[uid], logits_j):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **TOL)


def test_deq_mode_matches_jax(deq_setup):
    jcfg, tcfg, jp, tp = deq_setup
    b, s, max_len = 2, 6, 16
    toks = _tokens(jcfg, b, s, 4)
    jl, jaux = jax.jit(lambda p, t: jlm.forward(
        p, {"tokens": t}, jcfg, CTX, train=False))(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, taux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert taux["deq_steps"] == float(jaux["deq_steps"])
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
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
    # the stored caches: the final pass at z* (the recurrent states of
    # every row, the frozen row's included)
    for path, tt, jt in _cache_pairs(tc, jc):
        np.testing.assert_allclose(_np(tt), _np(jt), err_msg=path, **TOL)


def test_deq_gradients_match_jax(deq_setup):
    jcfg, tcfg, jp, tp = deq_setup
    toks = _tokens(jcfg, 2, 8, 6)
    tgts = _tokens(jcfg, 2, 8, 7)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, jcfg, CTX), has_aux=True))(jp)
    leaves = jax.tree_util.tree_map(lambda a: a.clone().requires_grad_(True),
                                    tp)
    lt, mt = tlm.loss_fn(leaves, {"tokens": torch.from_numpy(toks),
                                  "targets": torch.from_numpy(tgts)}, tcfg)
    lt.backward()
    assert mt["deq_steps"] == float(mj["deq_steps"])
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    _grads_match(leaves, gj, 1e-2, 1e-3)


@pytest.mark.parametrize("deq", [False, True])
def test_serve_launcher_runs(deq, capsys):
    serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "3", "--slots", "2",
                         "--max-new-tokens", "3"]
                        + (["--deq"] if deq else []))
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out
    assert "served 3 requests, 9 tokens" in out
    assert "async pipeline: 0 blocking host syncs recorded {}" in out


def test_train_launcher_runs_with_deq(capsys):
    train_launcher.main(["--arch", ARCH, "--smoke", "--deq", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "deq=True" in out
    assert out.rstrip().endswith("finished at step 2")


def test_init_params_draws_the_nested_stacks():
    cfg = smoke_config(ARCH)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    decl = tlm.model_decl(cfg)
    m = params["group0"]["mlstm"]["m"]
    s = params["group0"]["slstm"]["s"]
    assert tuple(m["w_q"].shape) == (2, 3, 4, 32, 32)
    assert tuple(s["r"].shape) == (2, 4, 4, 16, 16)
    assert decl["group0"]["slstm"]["s"]["bias"].init == "zeros"
    assert not s["bias"].any() and bool((m["f_bias"] == 1).all())
    w_up = m["w_up"].float()
    assert tuple(w_up.shape) == (2, 3, 64, 256)
    # the reference's fan-in: every dim but the last, both stacked axes
    want_std = 1 / math.sqrt(2 * 3 * 64)
    assert abs(float(w_up.std()) / want_std - 0.88) < 0.05
    assert not torch.equal(w_up[0], w_up[1])
    for leaf in (m["w_i"], s["r"]):               # "normal", scale 0.02
        assert abs(float(leaf.float().std()) - 0.02) < 0.004


def test_params_from_jax_covers_the_nested_stacks():
    cfg = jax_smoke_config(ARCH)  # bf16 parameters
    params = jlm.init_params(cfg, jax.random.PRNGKey(3))
    tparams = tlm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    decl = tlm.model_decl(smoke_config(ARCH))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        t, d = tparams, decl
        for p in path:
            t, d = t[p.key], d[p.key]
        assert tuple(t.shape) == tuple(leaf.shape) == d.shape, path
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), _np(leaf))
    n = sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    assert n == jlm.param_count(cfg) == sum(
        math.prod(d.shape) for _, d in _leaves(decl))
