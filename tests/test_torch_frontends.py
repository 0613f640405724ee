"""The audio and vlm families against the JAX package, on the CPU.

``hubert-xlarge`` (a non-causal GELU encoder over the stub frontend's
frame embeddings, a classifier head over 512 padded classes) and
``pixtral-12b`` (a GQA decoder with the stub vision tower's patch
embeddings prepended: 8 image tokens at the smoke size), at their smoke
configs in f32, with the parameters drawn by the JAX package and carried
over through numpy, and the batches of the reference's
``tests/test_archs.py`` drawn by the port's ``stub_batch`` from a numpy
seed:

  * ``forward`` logits (rtol 1e-4), ``loss_fn`` (rtol 1e-5; the image
    positions dropped before the cross entropy) and every gradient leaf
    (rtol 1e-4, atol 1e-4 x the leaf's largest entry), for both families;
  * the vlm ``prefill`` then two ``decode_step`` calls, text-only and with
    ``image_embeds``: logits and every cache leaf against JAX's (rtol
    1e-4), the lengths counting the image tokens; and prefill over S then
    one decode step against the port's own forward over S + 1 at the
    reference's 3e-2 / 4e-2 (``tests/test_archs.py``);
  * HuBERT's DEQ train step (``tests/test_archs.py::test_deq_mode_trains``):
    a finite loss and residual, every gradient leaf finite, the gradient
    non-zero; the DEQ forward of both families against JAX's;
  * the parameter trees of both families, DEQ on and off, equal the
    reference's ``model_decl`` leaf by leaf (the audio classifier head);
  * ``stub_batch``'s shapes, dtypes and ranges for each family;
  * HuBERT's GELU MLP (``tanh``, ``jax.nn.gelu``'s default) at its
    published width, d 1280 and ff 5120, against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import stub_batch
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("hubert-xlarge", "pixtral-12b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{f}")
    else:
        yield path, tree


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
def setup(request):
    return (request.param,) + _setup(request.param)


def _batch(cfg, b, s, seed):
    """The port's ``stub_batch`` on the CPU and its JAX twin."""
    tb = stub_batch(cfg, b, s, seed=seed, device="cpu")
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def test_forward_loss_and_every_gradient_leaf_match_jax(setup):
    arch, jcfg, tcfg, jp, tp = setup
    tb, jb = _batch(tcfg, 2, 24, 0)
    jl, _ = jax.jit(lambda p, b: jlm.forward(p, b, jcfg, CTX,
                                             train=False))(jp, jb)
    with torch.no_grad():
        tl, _ = tlm.forward(tp, tb, tcfg, train=False)
    assert tl.shape == (2, 24, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, jcfg, CTX), has_aux=True))(jp)
    leaves = jax.tree_util.tree_map(
        lambda a: a.clone().requires_grad_(True), tp)
    lt, _ = tlm.loss_fn(leaves, tb, tcfg)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    jleaves = dict(_leaves(gj))
    got = dict(_leaves(leaves))
    assert sorted(got) == sorted(jleaves)
    for path, t in got.items():
        want = _np(jleaves[path])
        # the audio encoder never reads its token embedding: no gradient
        # in the port, zeros in JAX
        g = torch.zeros_like(t) if t.grad is None else t.grad
        np.testing.assert_allclose(_np(g), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=path)
    # the image positions carry no target: dropping them is the loss
    if tcfg.family == "vlm":
        n = tcfg.num_image_tokens
        with torch.no_grad():
            text_only = tlm.forward(tp, {"tokens": tb["tokens"]}, tcfg,
                                    train=False)[0]
        assert text_only.shape[1] == tl.shape[1] - n


def _cache_allclose(tc, jc):
    jl = dict(_leaves(jc))
    tl = dict(_leaves(tc))
    assert sorted(tl) == sorted(jl)
    for path, t in tl.items():
        np.testing.assert_allclose(_np(t), _np(jl[path]), err_msg=path,
                                   **TOL)


@pytest.mark.parametrize("images", [False, True])
def test_vlm_prefill_and_decode_match_jax(images):
    jcfg, tcfg, jp, tp = _setup("pixtral-12b")
    b, s, max_len, n = 2, 7, 32, tcfg.num_image_tokens
    tb, jb = _batch(tcfg, b, n + s, 3)
    if not images:
        tb, jb = ({"tokens": x["tokens"]} for x in (tb, jb))
    jl, jc, jlens = jax.jit(lambda p, bb: jlm.prefill(
        p, bb, jcfg, CTX, max_len))(jp, jb)
    tl, tc, tlens = tlm.prefill(tp, tb, tcfg, max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    assert tlens.tolist() == [s + (n if images else 0)] * b
    _cache_allclose(tc, jc)
    jdec = jax.jit(lambda p, c, t, i: jlm.decode_step(p, c, t, i, jcfg, CTX))
    idx = np.array(jlens)
    rng = np.random.default_rng(4)
    for _ in range(2):
        tok = rng.integers(2, tcfg.vocab_size, size=b).astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(idx))
        tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.from_numpy(idx), tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        idx = idx + 1
    _cache_allclose(tc, jc)


@pytest.mark.parametrize("images", [False, True])
def test_vlm_prefill_and_decode_give_the_forward(images):
    """The reference's ``test_prefill_decode_matches_forward`` on the
    port: prefill over S tokens (after the images) then one decode step
    give a forward's logits over S + 1, at its 3e-2 / 4e-2."""
    _, tcfg, _, tp = _setup("pixtral-12b")
    b, s, n = 2, 17, tcfg.num_image_tokens
    tb = stub_batch(tcfg, b, n + s + 1, seed=5, device="cpu")
    toks = tb["tokens"]
    img = {"image_embeds": tb["image_embeds"]} if images else {}
    off = n if images else 0
    with torch.no_grad():
        full, _ = tlm.forward(tp, {"tokens": toks, **img}, tcfg, train=False)
    pre, caches, lens = tlm.prefill(tp, {"tokens": toks[:, :s], **img}, tcfg,
                                    48)
    np.testing.assert_allclose(_np(pre[:, -1]), _np(full[:, off + s - 1]),
                               rtol=3e-2, atol=3e-2)
    dec, _ = tlm.decode_step(tp, caches, toks[:, s], lens, tcfg)
    np.testing.assert_allclose(_np(dec), _np(full[:, off + s]), rtol=4e-2,
                               atol=4e-2)


def test_deq_forward_matches_jax_and_hubert_deq_trains():
    for arch in ARCHS:
        jcfg, tcfg, jp, tp = _setup(arch, deq=True)
        tb, jb = _batch(tcfg, 2, 16, 0)
        jl, _ = jax.jit(lambda p, b: jlm.forward(p, b, jcfg, CTX,
                                                 train=False))(jp, jb)
        with torch.no_grad():
            tl, _ = tlm.forward(tp, tb, tcfg, train=False)
        # the SHINE solves of the two packages stop within the solver's
        # tolerance of each other (tests/test_torch_training.py)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-2,
                                   atol=1e-3 * np.abs(_np(jl)).max())
    # tests/test_archs.py::test_deq_mode_trains on the port (HuBERT)
    _, tcfg, _, tp = _setup("hubert-xlarge", deq=True)
    tb, _ = _batch(tcfg, 2, 16, 1)
    leaves = jax.tree_util.tree_map(
        lambda a: a.clone().requires_grad_(True), tp)
    loss, metrics = tlm.loss_fn(leaves, tb, tcfg)
    assert np.isfinite(loss.item())
    assert np.isfinite(float(metrics["deq_residual"]))
    loss.backward()
    # only the token embedding, which the audio encoder never reads, has
    # no gradient (JAX's is zeros)
    assert [p for p, t in _leaves(leaves) if t.grad is None] == \
        ["/embed/embedding"]
    grads = [t.grad for _, t in _leaves(leaves) if t.grad is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    assert gnorm > 1e-4


@pytest.mark.parametrize("deq", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_trees_equal_the_reference_s(arch, deq):
    jcfg = jax_smoke_config(arch, deq=deq)
    tcfg = smoke_config(arch, deq=deq)
    want = {p: tuple(d.shape) for p, d in _leaves(jlm.model_decl(jcfg))}
    got = {p: tuple(d.shape) for p, d in _leaves(tlm.model_decl(tcfg))}
    assert got == want
    if arch == "hubert-xlarge":  # the classifier head over padded classes
        assert got["/embed/lm_head"] == (tcfg.d_model, tcfg.padded_vocab)
        assert got["/embed/embedding"] == (tcfg.padded_vocab, tcfg.d_model)
    # params_from_jax carries the reference's tree across leaf for leaf
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for (pt, t), (pj, j) in zip(_leaves(tp), _leaves(jp)):
        assert pt == pj
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=pt)


@pytest.mark.parametrize("arch", ARCHS + ("minicpm-2b",))
def test_stub_batch_shapes(arch):
    cfg = smoke_config(arch)
    b = stub_batch(cfg, 3, 20, seed=7, device="cpu")
    again = stub_batch(cfg, 3, 20, seed=7, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    n = cfg.num_image_tokens if cfg.family == "vlm" else 0
    want = {"audio": {"embeds", "targets"},
            "vlm": {"tokens", "image_embeds", "targets"}}.get(
                cfg.family, {"tokens", "targets"})
    assert set(b) == want
    assert tuple(b["targets"].shape) == (3, 20 - n)
    assert b["targets"].dtype == torch.int32
    assert 0 <= int(b["targets"].min()) and \
        int(b["targets"].max()) < cfg.vocab_size
    if "embeds" in b:
        assert tuple(b["embeds"].shape) == (3, 20, cfg.d_model)
    if "image_embeds" in b:
        assert tuple(b["image_embeds"].shape) == (3, n, cfg.d_model)
        assert b["image_embeds"].dtype == torch.float32
    if "tokens" in b:
        assert tuple(b["tokens"].shape) == (3, 20 - n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax_at_hubert_width(dtype):
    cfg = jax_get_config("hubert-xlarge")
    assert (cfg.act, cfg.d_model, cfg.d_ff) == ("gelu", 1280, 5120)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 1280)).astype(np.float32)
    p = {"wi": rng.standard_normal((1280, 5120)).astype(np.float32) / 36,
         "wo": rng.standard_normal((5120, 1280)).astype(np.float32) / 72}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jlayers.mlp({k: jnp.asarray(v, jdt) for k, v in p.items()},
                       jnp.asarray(x, jdt), cfg, CTX)
    got = tlayers.mlp({k: torch.tensor(v).to(tdt) for k, v in p.items()},
                      torch.tensor(x).to(tdt))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
