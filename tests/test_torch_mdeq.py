"""The port's multiscale DEQ against the JAX package's, on the CPU, at
``tests/test_mdeq.py``'s config ``MDEQConfig(image_size=12, channels=(8,
16))`` with the JAX parameters carried across (``params_from_jax``) and the
same ``synthetic_cifar`` draws.

  * ``ravel_state`` / ``pack_state``: element for element, structure,
    shapes and dtypes (NHWC leaves pack as the JAX package packs them);
  * the layout pieces: "SAME" convolutions at strides 1 and 2,
    ``jax.image.resize(..., "nearest")`` at factor 2 (``F.interpolate``
    picks input ``i // 2``: exact), and the group norm (``F.group_norm``
    on the NCHW view against the reference's NHWC reshape: rtol 1e-5);
  * ``mdeq_f`` once: rtol 1e-5, atol 1e-5 of its largest entry;
  * ``mdeq_forward``: with an f32 ring the same ``n_steps`` and logits at
    rtol 1e-4; with the bf16 ring the same ``n_steps`` and rtol 2e-2 (the
    LM's recorded bf16-ring difference);
  * the gradient of every backward mode ``tests/test_mdeq.py`` uses, fed
    one shared forward (the JAX Broyden solve's ``z*`` and ring, handed to
    the port's fixed point in place of its own solve): rtol 1e-3 of each
    leaf's scale;
  * the behavioural checks of ``tests/test_mdeq.py`` on the port: finite
    shapes and a falling residual, finite gradients in every mode, a loss
    that falls over 12 SGD steps with ``shine_fallback``, and SHINE's
    gradient aligned with the full backward's.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mdeq_cifar import MDEQConfig as JMDEQConfig
from repro.core import solvers as jsol
from repro.core.deq import DEQConfig as JDEQConfig
from repro.implicit import ImplicitConfig as JImplicitConfig
from repro.implicit.pytree import pack_state as j_pack
from repro.implicit.pytree import ravel_state as j_ravel
from repro.models import mdeq as jm
from repro_torch.configs.mdeq_cifar import MDEQConfig
from repro_torch.core.deq import DEQConfig
from repro_torch.core.lowrank import LowRank
from repro_torch.core.solvers import SolveResult
from repro_torch.implicit import ImplicitConfig
from repro_torch.implicit import solvers as implicit_solvers
from repro_torch.implicit.pytree import pack_state, ravel_state
from repro_torch.models import mdeq as tm
from repro_torch.obs.tape import SolveTape

KW = dict(image_size=12, channels=(8, 16), max_steps=12, memory=12)
CFG, JCFG = MDEQConfig(**KW), JMDEQConfig(**KW)
BACKWARDS = ["full", "shine", "jfb", "shine_fallback"]


@pytest.fixture(scope="module")
def setup():
    jparams = jm.init_mdeq(JCFG, jax.random.PRNGKey(0))
    tparams = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    jimages, jlabels = jm.synthetic_cifar(8, JCFG, seed=0)
    images, labels = tm.synthetic_cifar(8, CFG, seed=0, device="cpu")
    return (jparams, {"images": jimages, "labels": jlabels},
            tparams, {"images": images, "labels": labels})


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _close(got: torch.Tensor, want, rtol: float, rel_atol: float = 0.0):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=rtol,
        atol=rel_atol * float(np.abs(want).max()))


def test_synthetic_cifar_and_params_match_jax(setup):
    jparams, jbatch, tparams, batch = setup
    np.testing.assert_array_equal(batch["images"].numpy(),
                                  np.asarray(jbatch["images"]))
    np.testing.assert_array_equal(batch["labels"].numpy(),
                                  np.asarray(jbatch["labels"]))
    np.testing.assert_array_equal(
        tparams["blocks"]["s1"]["conv1"].permute(2, 3, 1, 0).numpy(),
        np.asarray(jparams["blocks"]["s1"]["conv1"]))
    # the port's own init: JAX's shapes (conv weights OIHW) and scales
    own = tm.init_mdeq(CFG, seed=0, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat:
        keys = [p.key for p in path]
        got = own
        for k in keys:
            got = got[k]
        want = np.asarray(leaf)
        shape = want.shape if want.ndim != 4 else (
            want.shape[3], want.shape[2], want.shape[0], want.shape[1])
        assert tuple(got.shape) == shape, keys
        assert abs(float(got.std()) - float(want.std())) <= \
            0.35 * float(want.std()) + 1e-6, keys


def test_ravel_state_matches_jax_element_for_element():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    b = rng.normal(size=(3, 2, 2, 5)).astype(np.float32)
    c = rng.normal(size=(3, 7)).astype(np.float32)
    jtree = {"s2": jnp.asarray(b).astype(jnp.bfloat16),
             "s1": (jnp.asarray(a), jnp.asarray(c))}
    ttree = {"s2": _t(b).to(torch.bfloat16), "s1": (_t(a), _t(c))}
    jflat, junravel = j_ravel(jtree)
    tflat, tunravel = ravel_state(ttree)
    assert tflat.dtype == torch.float32 and tflat.shape == (3, 32 + 20 + 7)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tunravel(tflat * 2)
    jback = junravel(jflat * 2)
    assert back["s2"].dtype == torch.bfloat16
    assert isinstance(back["s1"], tuple)
    for got, want in ((back["s1"][0], jback["s1"][0]),
                      (back["s1"][1], jback["s1"][1]),
                      (back["s2"], jback["s2"])):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # a single tensor passes through; a single leaf in a tuple unpacks
    x = _t(a)
    flat, unravel = ravel_state(x)
    assert flat is x and unravel(flat) is flat
    flat, unravel = ravel_state((x,))
    assert flat is x and unravel(flat)[0] is flat
    # the legacy helper flattens even one leaf, and unpacks to a list
    jp, junpack = j_pack([jnp.asarray(a), jnp.asarray(b)])
    tp, tunpack = pack_state([_t(a), _t(b)])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert [tuple(t.shape) for t in tunpack(tp)] == [(3, 4, 4, 2),
                                                     (3, 2, 2, 5)]
    with pytest.raises(ValueError, match="leading batch axis"):
        ravel_state((_t(a), _t(a)[:2]))


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1)])
def test_conv_same_padding_matches_jax(stride, k):
    rng = np.random.default_rng(stride * 10 + k)
    x = rng.normal(size=(2, 12, 12, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    want = jm._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = tm._conv(_t(x), _t(w).permute(3, 2, 0, 1), stride)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5, 1e-6)


def test_nearest_resize_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 6, 4)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 12, 12, 4), "nearest")
    got = tm._upsample(_t(x), (12, 12))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # input i // 2, explicitly
    np.testing.assert_array_equal(got.numpy(), x[:, [i // 2 for i in
                                                     range(12)]][
        :, :, [i // 2 for i in range(12)]])


@pytest.mark.parametrize("c,groups", [(24, 8), (12, 8), (16, 8)])
def test_group_norm_matches_jax(c, groups):
    rng = np.random.default_rng(c)
    x = (3.0 * rng.normal(size=(2, 6, 6, c)) + 1.0).astype(np.float32)
    p = {"scale": rng.normal(size=(c,)).astype(np.float32),
         "bias": rng.normal(size=(c,)).astype(np.float32)}
    want = jm._gn({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), groups)
    got = tm._gn({k: _t(v) for k, v in p.items()}, _t(x), groups)
    _close(got, want, 1e-5, 1e-6)


def test_mdeq_f_matches_jax(setup):
    jparams, _, tparams, _ = setup
    rng = np.random.default_rng(1)
    x1, z1 = (rng.normal(size=(8, 12, 12, 8)).astype(np.float32)
              for _ in range(2))
    x2, z2 = (rng.normal(size=(8, 6, 6, 16)).astype(np.float32)
              for _ in range(2))
    want = jax.jit(lambda p, a, b, c, d: jm.mdeq_f(p, (a, b), (c, d), JCFG))(
        jparams, x1, x2, z1, z2)
    got = tm.mdeq_f(tparams, (_t(x1), _t(x2)), (_t(z1), _t(z2)), CFG)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("qn_dtype,rtol", [("float32", 1e-4),
                                           ("bfloat16", 2e-2)])
def test_mdeq_forward_matches_jax(setup, qn_dtype, rtol):
    jparams, jbatch, tparams, batch = setup
    kw = dict(max_steps=12, tol=1e-3, memory=12, qn_dtype=qn_dtype)
    jlogits, jstats = jax.jit(lambda p, im: jm.mdeq_forward(
        p, im, JCFG, JImplicitConfig.from_strings(**kw)))(
        jparams, jbatch["images"])
    logits, stats = tm.mdeq_forward(tparams, batch["images"], CFG,
                                    ImplicitConfig.from_strings(**kw))
    assert stats.n_steps == int(jstats.n_steps)
    np.testing.assert_array_equal(stats.status.numpy(),
                                  np.asarray(jstats.status))
    _close(logits, jlogits, rtol, rtol)
    _close(stats.trace[:stats.n_steps], np.asarray(jstats.trace)[
        :stats.n_steps], 10 * rtol)


def _jax_forward_solve(jparams, jimages, deq_cfg):
    """The JAX package's forward Broyden solve of ``mdeq_forward``, on the
    packed state, as its fixed point runs it."""
    icfg = jm.implicit_config(JCFG, deq_cfg)
    x1 = jax.nn.relu(jm._conv(jimages, jparams["stem"]))
    x2 = jax.nn.relu(jm._conv(x1, jparams["inj2"], 2))
    b = jimages.shape[0]
    z0 = (jnp.zeros((b, 12, 12, 8)), jnp.zeros((b, 6, 6, 16)))
    flat, unravel = j_ravel(z0)

    def f(z):
        return j_ravel(jm.mdeq_f(jparams, (x1, x2), unravel(z), JCFG))[0]

    return jax.jit(lambda z: jsol.broyden_solve(
        lambda zz: zz - f(zz), z, icfg.solver_cfg()))(flat)


def _as_port_result(r) -> SolveResult:
    lr = r.lowrank
    return SolveResult(
        z=_t(r.z), lowrank=LowRank(alpha=_t(lr.alpha).reshape(()),
                                   u=_t(lr.u.astype(jnp.float32)).to(
                                       torch.bfloat16),
                                   v=_t(lr.v.astype(jnp.float32)).to(
                                       torch.bfloat16),
                                   count=_t(lr.count)),
        residual=_t(r.residual), n_steps=int(r.n_steps),
        converged=_t(r.converged), trace=_t(r.trace), aux={},
        tape=SolveTape(*[_t(a) for a in r.tape]), status=_t(r.status))


@pytest.mark.parametrize("backward", BACKWARDS)
def test_mdeq_gradients_match_jax_from_a_shared_forward(setup, backward):
    jparams, jbatch, tparams, batch = setup
    kw = dict(max_steps=12, tol=CFG.tol, memory=12, backward=backward,
              backward_max_steps=12)
    jg = jax.jit(jax.grad(lambda p: jm.mdeq_loss(p, jbatch, JCFG,
                                                 JDEQConfig(**kw))[0]))(
        jparams)
    shared = _as_port_result(_jax_forward_solve(jparams, jbatch["images"],
                                                JDEQConfig(**kw)))
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                    tparams)
    with mock.patch.object(implicit_solvers, "call_solver",
                           lambda *a, **k: shared):
        loss, _ = tm.mdeq_loss(params, batch, CFG, DEQConfig(**kw))
    loss.backward()
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = params
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        _close(got.grad, want, 1e-3, 1e-3)


def test_forward_shapes_and_residual(setup):
    _, _, tparams, batch = setup
    logits, stats = tm.mdeq_forward(tparams, batch["images"], CFG)
    assert logits.shape == (8, CFG.num_classes)
    assert torch.isfinite(logits).all()
    assert float(stats.residual.mean()) < float(stats.trace[0].mean())


@pytest.mark.parametrize("backward", BACKWARDS)
def test_mdeq_grads_finite_all_modes(setup, backward):
    _, _, tparams, batch = setup
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                    tparams)
    deq_cfg = DEQConfig(max_steps=12, tol=CFG.tol, memory=12,
                        backward=backward, backward_max_steps=12)
    tm.mdeq_loss(params, batch, CFG, deq_cfg)[0].backward()
    assert all(torch.isfinite(t.grad).all()
               for t in jax.tree_util.tree_leaves(params))


def test_mdeq_trains_with_shine(setup):
    _, _, tparams, batch = setup
    deq_cfg = DEQConfig(max_steps=12, tol=CFG.tol, memory=12,
                        backward="shine_fallback")
    p = jax.tree_util.tree_map(lambda t: t.clone(), tparams)
    losses = []
    for _ in range(12):
        leaves = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), p)
        loss, _ = tm.mdeq_loss(leaves, batch, CFG, deq_cfg)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            p = jax.tree_util.tree_map(lambda a: (a - 0.05 * a.grad).detach(),
                                       leaves)
    assert losses[-1] < losses[0] - 0.05, losses


def test_shine_vs_full_gradient_alignment(setup):
    _, _, tparams, batch = setup

    def grad_of(backward):
        params = jax.tree_util.tree_map(
            lambda t: t.clone().requires_grad_(True), tparams)
        deq_cfg = DEQConfig(max_steps=25, tol=1e-6, memory=25,
                            backward=backward, backward_max_steps=40,
                            backward_tol=1e-8)
        tm.mdeq_loss(params, batch, CFG, deq_cfg)[0].backward()
        return [t.grad for t in jax.tree_util.tree_leaves(params)]

    g_full, g_shine = grad_of("full"), grad_of("shine_fallback")
    num = sum(float((a * b).sum()) for a, b in zip(g_full, g_shine))
    na = np.sqrt(sum(float((a * a).sum()) for a in g_full))
    nb = np.sqrt(sum(float((b * b).sum()) for b in g_shine))
    assert num / (na * nb) > 0.5


def test_implicit_config_matches_jax():
    for deq_cfg in (None, ("shine_fallback", 7)):
        if deq_cfg is None:
            got, want = tm.implicit_config(CFG), jm.implicit_config(JCFG)
        else:
            got = tm.implicit_config(CFG, DEQConfig(backward=deq_cfg[0],
                                                    max_steps=deq_cfg[1]))
            want = jm.implicit_config(JCFG, JDEQConfig(
                backward=deq_cfg[0], max_steps=deq_cfg[1]))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
