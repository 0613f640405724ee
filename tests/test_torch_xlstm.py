"""The port's xLSTM cells and blocks against the JAX package, on the CPU.

On the SSM smoke config (``xlstm-1.3b``: d 64, 4 heads, mLSTM inner 128 in
heads of 32, sLSTM heads of 16, ff 64, ``chunk=16``) in f32, with inputs
and parameters drawn from numpy seeds or by the JAX package and carried
over through numpy:

  * ``mlstm_cell_chunked`` at S = 37 (two full chunks and one padded with
    state-neutral gates), from a cold and from a warm cache: ``y`` and
    ``(C, n, m)`` at rtol 1e-4, atol 1e-4 x the output's scale;
  * ``mlstm_step`` at rtol 1e-5, and the chunked cell against the port's
    own sequential ``mlstm_step`` (1e-5);
  * ``mlstm_block`` and ``slstm_block`` with and without a cache (the
    sLSTM's input projection hoisted over the sequence: rtol 1e-5), and
    neither writes the cache it is given;
  * the cold caches: zeros, stabilisers at -1e30;
  * finite gradients at xLSTM-1.3B's chunk of 256 over S = 300;
  * the chunk loop's ``autograd.Function`` (``y``, the final state and
    every input gradient) against the plain loop and against JAX's cell
    through ``jax.vjp`` at rtol 1e-5, and the sLSTM time loop's against
    its plain loop; on ``meta``, the peak bytes of each loop's forward and
    backward against what its Function saves.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import xlstm as jxl
from repro.parallel.sharding import ShardCtx, init_tree
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txl

CTX = ShardCtx.for_mesh(None)
ARCH = "xlstm-1.3b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, err_msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(jax_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(smoke_config(ARCH), dtype="float32"))


def _layer(decl_fn, cfgs, seed):
    jcfg, _ = cfgs
    jp = init_tree(decl_fn(jcfg), jax.random.PRNGKey(seed),
                   dtype=jnp.float32)
    return jp, tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")


@pytest.fixture(scope="module")
def mlstm(cfgs):
    jp, tp = _layer(jxl.mlstm_decl, cfgs, 0)
    # a per-head forget bias that is not all ones
    fb = np.random.default_rng(9).uniform(-1.0, 2.0, jp["f_bias"].shape)
    jp["f_bias"] = jnp.asarray(fb, jnp.float32)
    tp["f_bias"] = torch.from_numpy(fb.astype(np.float32))
    return jp, tp


@pytest.fixture(scope="module")
def slstm(cfgs):
    jp, tp = _layer(jxl.slstm_decl, cfgs, 1)
    bias = 0.5 * np.random.default_rng(8).standard_normal(jp["bias"].shape)
    jp["bias"] = jnp.asarray(bias, jnp.float32)
    tp["bias"] = torch.from_numpy(bias.astype(np.float32))
    return jp, tp


def _cell_inputs(b, s, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, s, h, hd)).astype(np.float32)
           for _ in range(3)]
    i_pre = rng.normal(0.0, 2.0, (b, s, h)).astype(np.float32)
    f_pre = rng.normal(2.0, 2.0, (b, s, h)).astype(np.float32)
    return qkv + [i_pre, f_pre]


def _mlstm_cache(b, h, hd, warm, seed):
    if not warm:
        return [np.zeros((b, h, hd, hd), np.float32),
                np.zeros((b, h, hd), np.float32),
                np.full((b, h), -1e30, np.float32)]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, hd, hd)).astype(np.float32),
            rng.uniform(0.5, 2.0, (b, h, hd)).astype(np.float32),
            rng.uniform(-2.0, 2.0, (b, h)).astype(np.float32)]


def _slstm_cache(b, h, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.uniform(0.5, 2.0, (b, h, hd)).astype(np.float32),
            0.5 * rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.uniform(-2.0, 2.0, (b, h, hd)).astype(np.float32)]


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("warm", [False, True])
def test_mlstm_chunked_cell_matches_jax(cfgs, warm):
    _, tcfg = cfgs
    _, h, hd = txl._mlstm_dims(tcfg)
    inp = _cell_inputs(2, 37, h, hd, 0)
    cache = _mlstm_cache(2, h, hd, warm, 1)
    jy, jc = jax.jit(functools.partial(jxl.mlstm_cell_chunked, chunk=16))(
        *_j(inp), jxl.MLSTMCache(*_j(cache)))
    ty, tc = txl.mlstm_cell_chunked(*_t(inp), txl.MLSTMCache(*_t(cache)),
                                    16)
    assert tuple(ty.shape) == (2, 37, h, hd)
    _close(ty, jy, 1e-4, "y")
    for f in txl.MLSTMCache._fields:
        _close(getattr(tc, f), getattr(jc, f), 1e-4, f)


def test_mlstm_step_matches_jax(cfgs):
    _, tcfg = cfgs
    _, h, hd = txl._mlstm_dims(tcfg)
    inp = [a[:, 0] for a in _cell_inputs(3, 1, h, hd, 2)]
    for warm in (False, True):
        cache = _mlstm_cache(3, h, hd, warm, 3)
        jy, jc = jax.jit(jxl.mlstm_step)(*_j(inp),
                                          jxl.MLSTMCache(*_j(cache)))
        ty, tc = txl.mlstm_step(*_t(inp), txl.MLSTMCache(*_t(cache)))
        _close(ty, jy, 1e-5, f"y warm={warm}")
        for f in txl.MLSTMCache._fields:
            _close(getattr(tc, f), getattr(jc, f), 1e-5, f)


@pytest.mark.parametrize("warm", [False, True])
def test_chunked_cell_is_the_sequential_step(cfgs, warm):
    _, tcfg = cfgs
    _, h, hd = txl._mlstm_dims(tcfg)
    q, k, v, i_pre, f_pre = _t(_cell_inputs(2, 37, h, hd, 4))
    cache0 = txl.MLSTMCache(*_t(_mlstm_cache(2, h, hd, warm, 5)))
    got, gc = txl.mlstm_cell_chunked(q, k, v, i_pre, f_pre, cache0, 16)
    cache, ys = cache0, []
    for t in range(37):
        y, cache = txl.mlstm_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                  f_pre[:, t], cache)
        ys.append(y)
    _close(got, torch.stack(ys, dim=1), 1e-5, "y")
    for f in txl.MLSTMCache._fields:
        _close(getattr(gc, f), getattr(cache, f), 1e-5, f)


@pytest.mark.parametrize("seq", [1, 37])
@pytest.mark.parametrize("cached", [False, True])
def test_mlstm_block_matches_jax(cfgs, mlstm, seq, cached):
    jcfg, tcfg = cfgs
    jp, tp = mlstm
    _, h, hd = txl._mlstm_dims(tcfg)
    x = np.random.default_rng(6).standard_normal(
        (2, seq, tcfg.d_model)).astype(np.float32)
    cache = _mlstm_cache(2, h, hd, True, 7) if cached else None
    jy, jc = jax.jit(lambda p, x, c: jxl.mlstm_block(p, x, jcfg, CTX, c))(
        jp, jnp.asarray(x), None if cache is None
        else jxl.MLSTMCache(*_j(cache)))
    tc_in = None if cache is None else txl.MLSTMCache(*_t(cache))
    ty, tc = txl.mlstm_block(tp, torch.from_numpy(x), tcfg, tc_in)
    _close(ty, jy, 1e-4, "out")
    assert (tc is None) == (jc is None) == (not cached)
    if cached:
        for f in txl.MLSTMCache._fields:
            _close(getattr(tc, f), getattr(jc, f), 1e-4, f)
            # the block returns a new cache and leaves the given one alone
            assert getattr(tc, f) is not getattr(tc_in, f)
            np.testing.assert_array_equal(getattr(tc_in, f).numpy(),
                                          cache[txl.MLSTMCache._fields
                                                .index(f)])


@pytest.mark.parametrize("seq", [1, 23])
@pytest.mark.parametrize("cached", [False, True])
def test_slstm_block_matches_jax(cfgs, slstm, seq, cached):
    """The hoisted input projection (one GEMM over all rows) against the
    reference's per-step one: rtol 1e-5."""
    jcfg, tcfg = cfgs
    jp, tp = slstm
    h = tcfg.num_heads
    hd = tcfg.d_model // h
    x = np.random.default_rng(10).standard_normal(
        (2, seq, tcfg.d_model)).astype(np.float32)
    cache = _slstm_cache(2, h, hd, 11) if cached else None
    jy, jc = jax.jit(lambda p, x, c: jxl.slstm_block(p, x, jcfg, CTX, c))(
        jp, jnp.asarray(x), None if cache is None
        else jxl.SLSTMCache(*_j(cache)))
    tc_in = None if cache is None else txl.SLSTMCache(*_t(cache))
    ty, tc = txl.slstm_block(tp, torch.from_numpy(x), tcfg, tc_in)
    _close(ty, jy, 1e-5, "out")
    assert (tc is None) == (jc is None) == (not cached)
    if cached:
        for i, f in enumerate(txl.SLSTMCache._fields):
            _close(getattr(tc, f), getattr(jc, f), 1e-5, f)
            np.testing.assert_array_equal(getattr(tc_in, f).numpy(),
                                          cache[i])
    # one step of the cell against the reference's
    xt = x[:, 0]
    c0 = cache if cached else [np.asarray(a) for a in
                               jxl.slstm_cache_shape(jcfg, 2)]
    jh, jc1 = jax.jit(lambda p, x, c: jxl.slstm_cell_step(p, x, c, jcfg))(
        jp, jnp.asarray(xt), jxl.SLSTMCache(*_j(c0)))
    th, tc1 = txl.slstm_cell_step(tp, torch.from_numpy(xt),
                                  txl.SLSTMCache(*_t(c0)), tcfg)
    _close(th, jh, 1e-5, "hidden")
    for f in txl.SLSTMCache._fields:
        _close(getattr(tc1, f), getattr(jc1, f), 1e-5, f)


def test_blocks_match_their_sequential_oracles(cfgs, mlstm, slstm):
    _, tcfg = cfgs
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 37, tcfg.d_model)).astype(np.float32))
    for (_, tp), block, oracle in (
            (mlstm, txl.mlstm_block, txl.mlstm_scan_ref),
            (slstm, txl.slstm_block, txl.slstm_scan_ref)):
        got, _ = block(tp, x, tcfg)
        _close(got, oracle(tp, x, tcfg), 1e-5, block.__name__)


def test_cold_caches_match_jax(cfgs):
    jcfg, tcfg = cfgs
    for jfn, tfn in ((jxl.mlstm_cache_shape, txl.mlstm_cache_shape),
                     (jxl.slstm_cache_shape, txl.slstm_cache_shape)):
        jc, tc = jfn(jcfg, 3), tfn(tcfg, 3, "cpu")
        assert tc._fields == jc._fields
        for a, b in zip(tc, jc):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(tc.m.max()) == float(np.float32(-1e30))
    # each leaf is its own tensor (the stack stores into them one by one)
    sc = txl.slstm_cache_shape(tcfg, 2, "cpu")
    assert len({t.data_ptr() for t in sc}) == 4


def test_long_chunk_gradients_are_finite(cfgs, mlstm):
    """xLSTM-1.3B's chunk of 256 over S = 300 (one full chunk, one padded
    with -1e30 / +1e30 gates): output and every gradient finite, and the
    output the sequential oracle's."""
    _, tcfg = cfgs
    cfg = dataclasses.replace(tcfg, xlstm=dataclasses.replace(tcfg.xlstm,
                                                              chunk=256))
    _, tp = mlstm
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 300, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    y, _ = txl.mlstm_block(leaves, x, cfg)
    y.square().sum().backward()
    assert torch.isfinite(y).all()
    assert torch.isfinite(x.grad).all()
    for k, t in leaves.items():
        assert torch.isfinite(t.grad).all(), k
        assert t.grad.abs().max() > 0, k
    _close(y, txl.mlstm_scan_ref({k: v.detach() for k, v in leaves.items()},
                                 x.detach(), cfg), 1e-4, "y")


@pytest.mark.parametrize("warm", [False, True])
def test_chunk_function_matches_the_plain_loop_and_jax_vjp(cfgs, warm):
    """``mlstm_cell_chunked`` where a gradient is wanted runs the chunk
    loop as ``_MLSTMChunks`` (the chunk entry states saved, each chunk
    recomputed in the backward): its ``y``, final state and the gradient
    of every input (q, k, v, both gates and the entry state) for random
    cotangents, against the plain loop (``mlstm_cell_chunked_ref``) and
    JAX's ``mlstm_cell_chunked`` through ``jax.vjp``, f32, rtol 1e-5, at S
    37 (the third chunk padded)."""
    _, tcfg = cfgs
    _, h, hd = txl._mlstm_dims(tcfg)
    arrs = _cell_inputs(2, 37, h, hd, 20) + _mlstm_cache(2, h, hd, warm, 21)
    rng = np.random.default_rng(22)
    cots = [rng.standard_normal(a.shape).astype(np.float32)
            for a in [arrs[0]] + arrs[5:]]

    def jcell(*a):
        y, c = jxl.mlstm_cell_chunked(*a[:5], jxl.MLSTMCache(*a[5:]), 16)
        return (y, *c)

    jout, vjp = jax.vjp(jax.jit(jcell), *_j(arrs))
    jgrads = vjp(tuple(_j(cots)))
    runs = {}
    for name, fn in (("function", txl.mlstm_cell_chunked),
                     ("plain", txl.mlstm_cell_chunked_ref)):
        args = [t.requires_grad_(True) for t in _t(arrs)]
        y, c = fn(*args[:5], txl.MLSTMCache(*args[5:]), 16)
        assert (type(y.grad_fn).__name__ == "_MLSTMChunksBackward") == (
            name == "function")
        runs[name] = [y, *c] + list(torch.autograd.grad((y, *c), args,
                                                        _t(cots)))
    names = ["y", "C", "n", "m", "dq", "dk", "dv", "di", "df", "dC", "dn",
             "dm"]
    for i, name in enumerate(names):
        got = runs["function"][i]
        _close(got, runs["plain"][i], 1e-5, name + " vs plain")
        _close(got, (list(jout) + list(jgrads))[i], 1e-5, name + " vs jax")
        assert torch.isfinite(got).all(), name


def _meta_leaf(*shape):
    return torch.empty(shape, device="meta").requires_grad_(True)


def test_chunk_function_keeps_entry_states_not_chunk_intermediates():
    """On ``meta``, the peak of the cell's forward and backward
    (``LiveBytes(block=1)``: every storage made, each at its bytes) at B 2,
    S 250, 4 heads of 32, chunk 16 (16 chunks): under 8 f32 copies of q
    (``y``, its cotangent, the q/k/v gradients, a spare) plus twice the 16
    chunk entry states (the saved ones and the backward's per-chunk
    state gradients).  The plain loop keeps every chunk's intermediates:
    5.55 MB against this bound's 3.13 MB; the Function 2.44 MB."""
    b, s, h, hd, chunk = 2, 250, 4, 32, 16
    q, k, v = (_meta_leaf(b, s, h, hd) for _ in range(3))
    gates = [_meta_leaf(b, s, h) for _ in range(2)]
    state = [_meta_leaf(b, h, hd, hd), _meta_leaf(b, h, hd),
             _meta_leaf(b, h)]
    args = [q, k, v] + gates + state
    with dryrun.LiveBytes(block=1) as live:
        y, c = txl.mlstm_cell_chunked(q, k, v, *gates,
                                      txl.MLSTMCache(*state), chunk)
        torch.autograd.grad((y, *c), args, [torch.ones_like(t)
                                            for t in (y, *c)])
    nc = -(-s // chunk)
    qkv = b * s * h * hd * 4
    entry = b * h * (hd * hd + hd + 1) * 4
    assert live.peak < 8 * qkv + 2 * nc * entry, live.peak


def test_slstm_function_matches_the_plain_loop(cfgs):
    """The sLSTM time loop where a gradient is wanted runs as
    ``_SLSTMSteps`` (each step's ``(c, n, m)`` saved, each step recomputed
    in the backward): hidden outputs, the last state and the gradient of
    ``r``, ``pre`` and the entry state against the plain loop
    (``slstm_steps_ref``, which runs ``_slstm_recur`` step by step), f32,
    from a cold and a warm state; on ``meta`` at B 2, S 64, the peak of
    its forward and backward stays under the plain loop's."""
    _, tcfg = cfgs
    h = tcfg.num_heads
    hd = tcfg.d_model // h
    rng = np.random.default_rng(23)
    r = (0.3 * rng.standard_normal((4, h, hd, hd))).astype(np.float32)
    pre = rng.standard_normal((2, 23, 4 * tcfg.d_model)).astype(np.float32)
    for warm in (False, True):
        st = (_slstm_cache(2, h, hd, 24) if warm else
              [t.numpy() for t in txl.slstm_cache_shape(tcfg, 2)])
        runs = {}
        for name, fn in (("function", txl.slstm_steps),
                         ("plain", txl.slstm_steps_ref)):
            args = [t.requires_grad_(True) for t in _t([r, pre] + st)]
            y, c = fn(args[0], args[1], txl.SLSTMCache(*args[2:]), tcfg)
            cots = [torch.from_numpy(np.random.default_rng(25).standard_normal(
                t.shape).astype(np.float32)) for t in (y, *c)]
            runs[name] = [y, *c] + list(torch.autograd.grad((y, *c), args,
                                                            cots))
        for i, (got, want) in enumerate(zip(runs["function"], runs["plain"])):
            _close(got, want, 1e-5, f"warm={warm} output {i}")
    peaks = {}
    for name, fn in (("function", txl.slstm_steps),
                     ("plain", txl.slstm_steps_ref)):
        args = [_meta_leaf(4, h, hd, hd), _meta_leaf(2, 64, 4 * tcfg.d_model),
                _meta_leaf(2, h, hd), _meta_leaf(2, h, hd),
                _meta_leaf(2, h, hd), _meta_leaf(2, h, hd)]
        with dryrun.LiveBytes(block=1) as live:
            y, c = fn(args[0], args[1], txl.SLSTMCache(*args[2:]), tcfg)
            torch.autograd.grad((y, *c), args, [torch.ones_like(t)
                                                for t in (y, *c)])
        peaks[name] = live.peak
    assert peaks["function"] < peaks["plain"] / 2, peaks
