"""The chunked attention (``kernels/flash_xla.py``), the plain attention's
``q_offset`` and soft cap, the blocked plain version and ``ops.attention``'s
``impl`` policy, against the JAX package, on the CPU.

  * ``flash_attention_xla`` forward and VJP at the six cases of the
    reference's ``tests/test_kernels.py::test_flash_xla_fwd_bwd_vs_oracle``
    against JAX's ``flash_attention_xla`` and ``attention_ref`` (its
    tolerances: 5e-5 forward, 5e-4 gradients); a property sweep over
    ragged shapes, GQA and causality (``tests/test_steps_and_ft.py``'s,
    1e-4); ``unroll`` True and False bit for bit; ``q_offset`` with more
    keys than queries, a ``kv_length`` 0 row and bf16 operands against
    JAX's;
  * ``ref.attention_ref`` with ``q_offset`` (T > S) and
    ``logits_soft_cap``, and ``ref.attention_blocked_ref``, against JAX's;
  * ``ops.attention`` under ``auto`` switches to the chunked path at 2^20
    score cells exactly (``tests/test_kernels.py``'s 1 x 1024 x 1024
    case, 5e-5), below it takes the plain version; ``flash_xla``, ``ref``
    and ``pallas_interpret`` on CPU tensors; ``pallas`` on CPU tensors
    and an unknown impl raise; the model's attention follows
    ``cfg.attn_impl``;
  * the CUDA prefill wrapper refuses causal attention with T > S (its
    check comes before any device check, so no card is needed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels import ref as jref
from repro.kernels.flash_xla import flash_attention_xla as jflash
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_xla import flash_attention_xla as tflash
from repro_torch.models import lm as tlm


def _draw(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _vjp_jax(fn, arrays, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _vjp_torch(fn, arrays, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,bq,bkv,unroll", [
    (2, 128, 128, 4, 4, 16, True, 32, 32, False),
    (2, 128, 128, 4, 4, 16, True, 32, 32, True),
    (2, 128, 128, 8, 2, 16, True, 32, 64, False),
    (2, 128, 128, 8, 2, 16, False, 32, 64, True),
    (1, 100, 100, 4, 4, 16, True, 32, 32, False),     # ragged padding
    (1, 96, 160, 4, 2, 16, False, 32, 32, False),     # cross attention
])
def test_flash_xla_forward_and_vjp_match_jax(b, s, t, h, kv, hd, causal,
                                             bq, bkv, unroll):
    q, k, v, g = _draw(s + t + h, (b, s, h, hd), (b, t, kv, hd),
                       (b, t, kv, hd), (b, s, h, hd))
    kw = dict(causal=causal, block_q=bq, block_kv=bkv, unroll=unroll)
    got, g_got = _vjp_torch(lambda *a: tflash(*a, **kw), (q, k, v), g)
    want, g_want = _vjp_jax(lambda *a: jflash(*a, **kw), (q, k, v), g)
    oracle, g_oracle = _vjp_jax(
        lambda *a: jref.attention_ref(*a, causal=causal), (q, k, v), g)
    for w in (want, oracle):
        np.testing.assert_allclose(got, w, rtol=5e-5, atol=5e-5)
    for ws in (g_want, g_oracle):
        for a, w in zip(g_got, ws):
            np.testing.assert_allclose(a, w, rtol=5e-4, atol=5e-4)


@settings(max_examples=15, deadline=None)
@given(
    st.integers(1, 2),                      # batch
    st.integers(1, 6),                      # q len (x16)
    st.integers(1, 6),                      # kv len (x16)
    st.sampled_from([(2, 2), (4, 2), (4, 1)]),  # (heads, kv_heads)
    st.booleans(),                          # causal
)
def test_flash_xla_property_random_shapes(b, sq, tk, hkv, causal):
    h, kv = hkv
    s, t = sq * 16 + 3, tk * 16 + 5    # deliberately non-multiples
    if causal and t < s:
        t = s
    q, k, v = _draw(b * 1000 + s + t + h, (b, s, h, 8), (b, t, kv, 8),
                    (b, t, kv, 8))
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    got = tflash(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                 causal=causal, block_q=16, block_kv=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flash_xla_unroll_changes_nothing():
    q, k, v, g = (torch.tensor(a).to(torch.bfloat16) for a in _draw(
        0, (2, 128, 4, 32), (2, 128, 4, 32), (2, 128, 4, 32),
        (2, 128, 4, 32)))
    outs = []
    for unroll in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = tflash(*leaves, block_q=32, block_kv=64, unroll=unroll)
        outs.append((out,) + torch.autograd.grad(out, leaves, g))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("case", ["q_offset", "kv_length", "bf16"])
def test_flash_xla_offset_lengths_and_bf16_match_jax(case):
    b, s, t, h, kv, hd = 2, 40, 70, 4, 2, 16
    q, k, v, g = _draw(11, (b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd),
                       (b, s, h, hd))
    kw = dict(causal=True, block_q=16, block_kv=32)
    if case == "q_offset":   # q is the tail of the key axis, T > S
        kw["q_offset"] = t - s
    if case == "kv_length":  # a row with no visible key averages them all
        kw.update(causal=False, kv_length=np.array([37, 0], np.int32))
        t_kw = dict(kw, kv_length=torch.tensor(kw["kv_length"]))
        j_kw = dict(kw, kv_length=jnp.asarray(kw["kv_length"]))
    else:
        t_kw = j_kw = kw
    if case == "bf16":
        kw["q_offset"] = t - s
        tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        got = tflash(tq, tk, tv, **kw).float().numpy()
        want = np.asarray(jflash(jq, jk, jv, **kw), np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        return
    got, g_got = _vjp_torch(lambda *a: tflash(*a, **t_kw), (q, k, v), g)
    want, g_want = _vjp_jax(lambda *a: jflash(*a, **j_kw), (q, k, v), g)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    for a, w in zip(g_got, g_want):
        np.testing.assert_allclose(a, w, rtol=5e-4, atol=5e-4)
    if case == "q_offset":  # the plain versions agree with it
        oracle = np.asarray(jref.attention_ref(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True,
            q_offset=t - s))
        plain = ref.attention_ref(*(torch.tensor(a) for a in (q, k, v)),
                                  causal=True, q_offset=t - s).numpy()
        np.testing.assert_allclose(got, oracle, rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(plain, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 5.0])
@pytest.mark.parametrize("q_offset", [0, 9])
def test_attention_ref_offset_and_soft_cap_match_jax(cap, q_offset):
    b, s, t, h, kv, hd = 2, 23, 32, 4, 2, 16
    q, k, v = _draw(3, (b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    lens = np.array([32, 11], np.int32)
    want = np.asarray(jref.attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True,
        kv_length=jnp.asarray(lens), q_offset=q_offset, scale=0.3,
        logits_soft_cap=cap))
    got = ref.attention_ref(*(torch.tensor(a) for a in (q, k, v)),
                            causal=True, kv_length=torch.tensor(lens),
                            q_offset=q_offset, scale=0.3,
                            logits_soft_cap=cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_blocked_ref_matches_jax(causal):
    """Not causal against JAX's ``attention_blocked_ref``; causal against
    JAX's dense ``attention_ref`` (the reference's blocked version raises
    under ``causal=True``: its causal mask comes out at the wrong rank)."""
    b, s, t, h, kv, hd = 2, 30, 30, 4, 2, 16
    q, k, v = _draw(4, (b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    lens = np.array([30, 17], np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    if causal:
        with pytest.raises(ValueError):
            jref.attention_blocked_ref(*jargs, causal=True, block=8)
        want = jref.attention_ref(*jargs, causal=True,
                                  kv_length=jnp.asarray(lens))
    else:
        want = jref.attention_blocked_ref(*jargs, causal=False,
                                          kv_length=jnp.asarray(lens),
                                          block=8)
    got = ref.attention_blocked_ref(*(torch.tensor(a) for a in (q, k, v)),
                                    causal=causal,
                                    kv_length=torch.tensor(lens), block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_auto_takes_flash_xla_at_2_20_cells_on_the_cpu():
    q, k, v = _draw(5, (1, 1024, 2, 32), (1, 1024, 2, 32), (1, 1024, 2, 32))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    assert ops.attention_route(None, tq, tk) == "flash_xla"
    assert ops.attention_route("auto", tq[:, :1023], tk) == "plain"
    got = ops.attention(tq, tk, tv, causal=True)
    want = np.asarray(jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                         causal=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)
    assert torch.equal(got, tflash(tq, tk, tv, causal=True))


def test_impl_policy_on_cpu_tensors():
    q, k, v = (torch.tensor(a) for a in _draw(6, (2, 9, 4, 16),
                                              (2, 9, 2, 16), (2, 9, 2, 16)))
    plain = ref.attention_ref(q, k, v, causal=True)
    for impl in ("ref", "pallas_interpret", "auto", None):
        assert ops.attention_route(impl, q, k) == "plain"
        assert torch.equal(ops.attention(q, k, v, impl=impl), plain)
    chunked = ops.attention(q, k, v, impl="flash_xla", block_q=4, block_kv=4)
    np.testing.assert_allclose(chunked.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="impl="):
        ops.attention(q, k, v, impl="triton")


def test_model_attention_follows_the_config_s_impl(monkeypatch):
    cfg = dataclasses.replace(smoke_config("pixtral-12b"), dtype="float32")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12))
    seen = []
    route = ops.attention_route
    monkeypatch.setattr(ops, "attention_route",
                        lambda impl, q, k: seen.append(impl) or route(
                            impl, q, k))
    outs = {}
    for impl in ("auto", "flash_xla", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl, attn_block_q=4,
                                attn_block_kv=8)
        with torch.no_grad():
            outs[impl] = tlm.forward(params, {"tokens": toks}, c,
                                     train=False)[0]
    assert seen == ["auto"] * 2 + ["flash_xla"] * 2 + ["ref"] * 2
    np.testing.assert_allclose(outs["flash_xla"].numpy(),
                               outs["auto"].numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(outs["ref"], outs["auto"])


def test_cuda_prefill_wrapper_refuses_causal_t_above_s():
    q = torch.zeros(1, 8, 2, 64)
    kv = torch.zeros(1, 12, 2, 64)
    with pytest.raises(ValueError, match="T=12 > S=8"):
        cuda_fa.flash_attention(q, kv, kv, causal=True)
    # not causal, or S >= T: the wrapper goes on to its device check
    for qq, kk, causal in ((q, kv, False), (kv, q, True)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_fa.flash_attention(qq, kk, kk, causal=causal)
