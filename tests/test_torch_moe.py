"""The port's fine-grained MoE (``repro_torch/models/moe.py``) against the
JAX package's, on the CPU.

The same numpy inputs go through both packages:

  * ``_route``: expert ids, gates, the load-balance loss and the router
    z-loss, with ``norm_topk`` on and off (f32; ids exactly, the rest at
    rtol 1e-5);
  * the dispatch: at a ``capacity_factor`` of 0.5, where experts drop
    tokens, each expert keeps exactly the tokens, in the same order, that
    the reference's ``_expert_bucket`` keeps; also a decode-sized batch
    below the capacity, where nothing drops;
  * ``moe_block``: output (rtol 1e-5) and aux losses, with drops and
    without, the router as the reference's ``init_params`` leaves it;
  * in bf16 a near-tied router score may pick another expert for one token
    (the two packages sum the f32 logits in another order), so the bf16
    check asserts that the packages agree on at least 99% of the
    (token, k) routes and holds the output of the tokens whose routes all
    agree at the bf16 tolerance (rtol 2e-2, atol 2e-2), dropless.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.parallel.sharding import ShardCtx
from repro_torch.configs.registry import smoke_config
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

CTX = ShardCtx.for_mesh(None)
ARCH = "deepseek-moe-16b"
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def _cfgs(dtype="float32", **moe):
    out = []
    for make in (jax_smoke_config, smoke_config):
        cfg = make(ARCH)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _inputs(t, d, e, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, e))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("norm_topk", [True, False])
def test_route_matches_jax(norm_topk):
    jcfg, tcfg = _cfgs(norm_topk=norm_topk)
    x, w = _inputs(48, jcfg.d_model, jcfg.moe.num_experts)
    ji, jg, jaux, jz = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ti, tg, taux, tz = tmoe._route(torch.from_numpy(x), torch.from_numpy(w),
                                   tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    np.testing.assert_allclose(float(tz), float(jz), **TOL)
    if norm_topk:
        np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("tokens,cf", [(64, 0.5), (40, 0.5), (4, 1.25)])
def test_dispatch_keeps_the_tokens_jax_keeps(tokens, cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    e = jcfg.moe.num_experts
    x, w = _inputs(tokens, jcfg.d_model, e, seed=tokens)
    ji, jg, _, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg)
    cap = jmoe._capacity(tokens, jcfg.moe)
    assert tmoe._capacity(tokens, tcfg.moe) == cap
    tab, slot = tmoe._expert_buckets(torch.from_numpy(np.array(ji)), e,
                                     min(tokens, cap))
    dropped = 0
    for ex in range(e):
        perm, _, valid = jmoe._expert_bucket(ji, jg, ex, cap)
        want = np.asarray(perm)[np.asarray(valid)]
        got = tab[ex].numpy()
        np.testing.assert_array_equal(got[got < tokens], want)
        dropped += int((np.asarray(ji) == ex).sum()) - len(want)
    # every kept pair points at its row of the buffer, every dropped one at
    # the zero row past it
    kept = slot < e * tab.shape[1]
    assert int((~kept).sum()) == dropped
    rows = slot[kept]
    assert torch.equal(tab.reshape(-1)[rows],
                       torch.arange(tokens)[:, None].expand_as(slot)[kept])
    if cf < 1:
        assert dropped > 0       # the capacity binds: tokens were dropped
    else:
        assert dropped == 0 and tab.shape[1] == tokens  # C = T < capacity


def _block_params(jcfg, seed=0):
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    moe_p = jax.tree_util.tree_map(lambda a: a[0], params["group1"]["moe"])
    return moe_p, tlm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, moe_p), "cpu")


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_block_matches_jax(cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp, tp = _block_params(jcfg)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, a: jmoe.moe_block(p, a, jcfg, CTX))(
        jp, jnp.asarray(x))
    tout, taux = tmoe.moe_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)


def test_moe_block_bf16_routes_agree_with_jax():
    e = smoke_config(ARCH).moe.num_experts
    # dropless, so that one flipped route moves only its own token
    jcfg, tcfg = _cfgs(dtype="bfloat16", capacity_factor=e / 2)
    jp, tp = _block_params(jcfg)
    x = np.random.default_rng(4).standard_normal(
        (4, 64, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ji, _, _, _ = jmoe._route(xj.reshape(-1, jcfg.d_model), jp["router"],
                              jcfg)
    ti, _, _, _ = tmoe._route(xt.reshape(-1, tcfg.d_model), tp["router"],
                              tcfg)
    ji = np.sort(np.asarray(ji), -1)
    ti = np.sort(ti.numpy(), -1)
    agree = (ji == ti)
    assert agree.mean() >= 0.99, agree.mean()
    jout, _ = jax.jit(lambda p, a: jmoe.moe_block(p, a, jcfg, CTX))(jp, xj)
    tout, _ = tmoe.moe_block(tp, xt, tcfg)
    same = agree.all(-1)
    got = tout.float().numpy().reshape(-1, jcfg.d_model)[same]
    want = np.asarray(jout, np.float32).reshape(-1, jcfg.d_model)[same]
    np.testing.assert_allclose(got, want, **TOL_BF16)


def test_moe_declarations_match_jax():
    jcfg, tcfg = _cfgs()
    jdecl = jmoe.moe_decl(jcfg)
    tdecl = tmoe.moe_decl(tcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        jdecl, is_leaf=lambda a: hasattr(a, "axes"))[0]
    for path, d in flat:
        t = tdecl
        for p in path:
            t = t[p.key]
        assert (t.shape, t.init, t.scale) == (d.shape, d.init, d.scale)
    assert tdecl["shared"]["wi_g"].shape == (
        tcfg.d_model, tcfg.moe.num_shared * tcfg.moe.expert_d_ff)
