"""The port's Mamba2 (SSD) block against the JAX package, on the CPU.

On the hybrid smoke config (``zamba2-2.7b``: d 64, state 16, SSM head dim
16, so 8 heads, ``chunk=16``) in f32, with one layer's parameters drawn by
the JAX package (``A_log`` and ``dt_bias`` given values, which ``zeros``
would hide) and carried over through numpy:

  * ``mamba2_block`` chunked at S = 16 (one chunk), 23 (padded to two with
    ``dt = 0`` steps) and 48 (three chunks), from a zero and from a non-zero
    cache, and the decode step: outputs and every ``MambaCache`` leaf at
    rtol 1e-4;
  * the chunked block against the port's own sequential
    ``mamba2_scan_ref``;
  * the gradients of every Mamba leaf and of the input against
    ``jax.grad``;
  * the block leaves the cache it is given as it was;
  * the chunk-256 case that overflows a decay masked after the
    exponential: finite gradients;
  * ``softplus`` is ``jax.nn.softplus`` past 20, and the conv sums its
    shifted products in the reference's order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro.parallel.sharding import ShardCtx, init_tree
from repro_torch.configs.registry import smoke_config
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "zamba2-2.7b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(smoke_config(ARCH), dtype="float32")
    jp = init_tree(jssm.mamba2_decl(jcfg), jax.random.PRNGKey(0),
                   dtype=jnp.float32)
    rng = np.random.default_rng(0)
    nh = jp["A_log"].shape[0]
    jp["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, nh), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5, nh), jnp.float32)
    jp["D"] = jnp.asarray(rng.uniform(0.5, 1.5, nh), jnp.float32)
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _cache(cfg, b, seed):
    """A non-zero cache, the same for both packages."""
    shp = tssm.mamba2_cache_shape(cfg, b)
    rng = np.random.default_rng(seed)
    return [0.5 * rng.standard_normal(tuple(t.shape)).astype(np.float32)
            for t in shp]


@pytest.mark.parametrize("seq", [16, 23, 48])
@pytest.mark.parametrize("warm", [False, True])
def test_chunked_block_matches_jax(setup, seq, warm):
    jcfg, tcfg, jp, tp = setup
    x = _x(tcfg, 2, seq, seq)
    state, conv = _cache(tcfg, 2, 7) if warm else [
        np.zeros(tuple(t.shape), np.float32)
        for t in tssm.mamba2_cache_shape(tcfg, 2)]
    jy, jc = jax.jit(lambda p, xx, s, c: jssm.mamba2_block(
        p, xx, jcfg, CTX, jssm.MambaCache(s, c)))(jp, x, state, conv)
    tc_in = tssm.MambaCache(torch.from_numpy(state.copy()),
                            torch.from_numpy(conv.copy()))
    ty, tc = tssm.mamba2_block(tp, torch.from_numpy(x), tcfg, tc_in)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for a, b in zip(tc, jc):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    # the cache passed in is left as it was
    np.testing.assert_array_equal(tc_in.state.numpy(), state)
    np.testing.assert_array_equal(tc_in.conv.numpy(), conv)
    # no cache: the same outputs, no new cache
    jy0, jn = jssm.mamba2_block(jp, jnp.asarray(x), jcfg, CTX)
    ty0, tn = tssm.mamba2_block(tp, torch.from_numpy(x), tcfg)
    assert tn is None and jn is None
    np.testing.assert_allclose(_np(ty0), _np(jy0), **TOL)


def test_decode_steps_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    state, conv = _cache(tcfg, 3, 8)
    jc = jssm.MambaCache(jnp.asarray(state), jnp.asarray(conv))
    tc = tssm.MambaCache(torch.from_numpy(state), torch.from_numpy(conv))
    step = jax.jit(lambda p, xx, c: jssm.mamba2_block(p, xx, jcfg, CTX, c))
    for t in range(3):
        x = _x(tcfg, 3, 1, 30 + t)
        jy, jc = step(jp, x, jc)
        ty, tc = tssm.mamba2_block(tp, torch.from_numpy(x), tcfg, tc)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("seq", [16, 23, 48])
def test_chunked_block_matches_its_scan_ref(setup, seq):
    _, tcfg, _, tp = setup
    x = torch.from_numpy(_x(tcfg, 2, seq, 100 + seq))
    chunked, _ = tssm.mamba2_block(tp, x, tcfg)
    np.testing.assert_allclose(_np(chunked),
                               _np(tssm.mamba2_scan_ref(tp, x, tcfg)), **TOL)


@pytest.mark.parametrize("seq", [23, 48])
def test_gradients_match_jax(setup, seq):
    jcfg, tcfg, jp, tp = setup
    x = _x(tcfg, 2, seq, 200 + seq)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba2_block(p, xx, jcfg, CTX)[0] * cot)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tssm.mamba2_block(leaves, xt, tcfg)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(jgx), rtol=1e-4, atol=1e-4)
    assert sorted(leaves) == sorted(jgp)
    for k, t in leaves.items():
        scale = max(float(np.abs(_np(jgp[k])).max()), 1e-6)
        np.testing.assert_allclose(_np(t.grad), _np(jgp[k]), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


def test_long_chunk_gradients_are_finite(setup):
    """At Zamba2's chunk of 256 the masked-out decays ``exp(cum_i - cum_j)``
    overflow f32; masking before the exponential keeps them out of the
    gradient."""
    _, tcfg, _, tp = setup
    cfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                            chunk=256))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    with torch.no_grad():
        leaves["dt_bias"].fill_(2.0)     # dt ~ 2: cum reaches ~ -500
        leaves["A_log"].fill_(0.0)
    x = torch.from_numpy(_x(cfg, 1, 256, 5))
    y, _ = tssm.mamba2_block(leaves, x, cfg)
    y.square().sum().backward()
    assert torch.isfinite(y).all()
    for k, t in leaves.items():
        assert torch.isfinite(t.grad).all(), k
    np.testing.assert_allclose(_np(y), _np(tssm.mamba2_scan_ref(
        {k: v.detach() for k, v in leaves.items()}, x, cfg)), **TOL)


def test_softplus_and_conv_order_match_jax():
    x = np.array([-30.0, -5.0, 0.0, 5.0, 19.0, 20.5, 25.0, 60.0], np.float32)
    np.testing.assert_array_equal(
        tssm._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    win = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for window in (None, win):
        jo, jw = jssm._causal_conv(
            jnp.asarray(u), jnp.asarray(w),
            None if window is None else jnp.asarray(window))
        to, tw = tssm._causal_conv(
            torch.from_numpy(u), torch.from_numpy(w),
            None if window is None else torch.from_numpy(window))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
