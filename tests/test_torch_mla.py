"""The port's multi-head latent attention (``mla_attention``) against the
JAX package's, on the CPU.

DeepSeek-V2-Lite's smoke widths (4 heads, kv_lora_rank 32, qk_nope 16 +
qk_rope 8, v 16), f32, the parameters of the JAX package's first layer:

  * prefill without a cache;
  * prefill into a cache (the latents written at ``cache_index`` 0; the
    attention over the step's own latents);
  * decode with the naive path (K and V rebuilt from the whole cache, v
    zero-padded to the qk width) and with the absorbed path (the latent
    space, ``absorbed_decode``), at ragged cache positions;

output at rtol 1e-4 and the cache's ``c_kv`` and ``k_pe`` after every
write.  Also: the declarations, and the cache shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx
from repro_torch.configs.registry import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

CTX = ShardCtx.for_mesh(None)
ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(absorbed=False):
    out = []
    for make in (jax_smoke_config, smoke_config):
        cfg = make(ARCH)
        out.append(dataclasses.replace(
            cfg, dtype="float32",
            mla=dataclasses.replace(cfg.mla, absorbed_decode=absorbed)))
    return out


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    p = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: a[0], p["group0"]["attn"])
    return jp, tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _pos(start, s):
    return np.asarray(start, np.int32)[:, None] + np.arange(s, dtype=np.int32)


def _close_cache(tc, jc):
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_mla_prefill_without_cache_matches_jax(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    x = _x(2, 7, jcfg.d_model, 0)
    pos = _pos([0, 0], 7)
    jout, _ = jattn.mla_attention(jp, jnp.asarray(x), jcfg, CTX,
                                  jnp.asarray(pos))
    tout, tcache = tattn.mla_attention(tp, torch.from_numpy(x), tcfg,
                                       torch.from_numpy(pos))
    assert tcache is None
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_cached_prefill_and_decode_match_jax(params, absorbed):
    jcfg, tcfg = _cfgs(absorbed)
    jp, tp = params
    b, s, t = 2, 6, 12
    kshape, vshape = tattn.mla_cache_shapes(tcfg, b, t)
    jshape = jattn.mla_cache_shape(jcfg, b, t)
    assert (kshape, vshape) == (jshape.k.shape, jshape.v.shape)
    jc = jattn.KVCache(jnp.zeros(kshape, jnp.float32),
                       jnp.zeros(vshape, jnp.float32))
    jmla = jax.jit(lambda p, a, q, c, i: jattn.mla_attention(
        p, a, jcfg, CTX, q, c, i))
    tc = tattn.KVCache(torch.zeros(kshape), torch.zeros(vshape))
    x = _x(b, s, jcfg.d_model, 1)
    idx = np.zeros((b,), np.int32)
    pos = _pos(idx, s)
    jout, jc = jmla(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                    jnp.asarray(idx))
    tout, tc = tattn.mla_attention(tp, torch.from_numpy(x), tcfg,
                                   torch.from_numpy(pos), tc,
                                   torch.from_numpy(idx))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    _close_cache(tc, jc)
    # decode at ragged positions: row 1 is two tokens behind row 0
    idx = np.array([s, s - 2], np.int32)
    for step in range(3):
        x1 = _x(b, 1, jcfg.d_model, 10 + step)
        pos = idx[:, None]
        jout, jc = jmla(jp, jnp.asarray(x1), jnp.asarray(pos), jc,
                        jnp.asarray(idx))
        tout, tc = tattn.mla_attention(tp, torch.from_numpy(x1), tcfg,
                                       torch.from_numpy(pos), tc,
                                       torch.from_numpy(idx))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        _close_cache(tc, jc)
        idx = idx + 1


def test_mla_declarations_match_jax():
    jcfg, tcfg = _cfgs()
    jdecl = jattn.mla_decl(jcfg)
    tdecl = tattn.mla_decl(tcfg)
    assert sorted(jdecl) == sorted(tdecl)
    for k, d in jdecl.items():
        assert (tdecl[k].shape, tdecl[k].init) == (d.shape, d.init), k
    m = tcfg.mla
    assert tdecl["wq"].shape[1] == tcfg.num_heads * (m.qk_nope_dim
                                                     + m.qk_rope_dim)
