"""The port's kernel layer against the JAX package's.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held against
the JAX oracles (``repro.kernels.ref``) on identical numpy inputs, at f32
and bf16, at the tolerances of ``tests/test_kernels.py`` (f32: rtol 1e-4 /
atol 1e-3; bf16: 2e-2).  They are also held once against the Pallas kernels
run in interpret mode, which pins the TPU kernels' own semantics (the
rmsnorm precision split included).  The Hopper kernels themselves run only
on the card: ``tests/test_torch_cuda.py`` compares them with the plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-3)


def _both(a, dtype="float32"):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    a = np.asarray(a)
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def _qn_inputs(rng, m, bsz, dim, k):
    u = rng.standard_normal((m, bsz, dim)).astype(np.float32)
    v = rng.standard_normal((m, bsz, dim)).astype(np.float32)
    xs = rng.standard_normal((k, bsz, dim)).astype(np.float32)
    count = rng.integers(0, m + 1, size=bsz)
    mask = (np.arange(m)[:, None] < count[None, :]).astype(np.float32)
    return u, v, xs, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transpose", [(False,), (True, False),
                                       (True, False, True)])
def test_qn_apply_multi_ref_matches_jax(transpose, dtype):
    rng = np.random.default_rng(len(transpose))
    u, v, xs, mask = _qn_inputs(rng, 6, 3, 40, len(transpose))
    (ju, tu), (jv, tv) = _both(u, dtype), _both(v, dtype)
    (jx, tx), (jm, tm) = _both(xs), _both(mask)
    want = jref.qn_apply_multi_ref(ju, jv, jx, jnp.float32(0.7), jm,
                                   transpose)
    got = tops.qn_apply_multi(tu, tv, tx, torch.tensor(0.7), tm, transpose)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    _close(got, want, dtype)


def _broyden_inputs(rng, m, bsz, dim):
    u = 0.3 * rng.standard_normal((m, bsz, dim)).astype(np.float32)
    v = 0.3 * rng.standard_normal((m, bsz, dim)).astype(np.float32)
    g = rng.standard_normal((bsz, dim)).astype(np.float32)
    s = 0.1 * rng.standard_normal((bsz, dim)).astype(np.float32)
    hg = rng.standard_normal((bsz, dim)).astype(np.float32)
    s[3] = 0.0  # den = 0 < eps: the append is refused for this row
    count = np.array([m + 2, 2, m, 0, 5][:bsz])  # wrapped, ragged, full, empty
    mask = (np.arange(m)[:, None] < np.minimum(count, m)[None, :])
    slot = (count % m).astype(np.int32)
    active = np.array([True, True, False, True, True][:bsz])
    return u, v, g, s, hg, mask.astype(np.float32), slot, active


@pytest.mark.parametrize("dtype", DTYPES)
def test_broyden_step_ref_matches_jax(dtype):
    rng = np.random.default_rng(7)
    u, v, g, s, hg, mask, slot, active = _broyden_inputs(rng, 6, 5, 24)
    (ju, tu), (jv, tv) = _both(u, dtype), _both(v, dtype)
    jg, tg = _both(g)
    js, ts = _both(s)
    jh, th = _both(hg)
    jm, tm = _both(mask)
    want = jref.broyden_step_ref(ju, jv, jg, js, jh, jnp.float32(1.0), jm,
                                 jnp.asarray(slot), jnp.asarray(active), 1e-8)
    got = tops.broyden_step(tu, tv, tg, ts, th, torch.tensor(1.0), tm,
                            torch.from_numpy(slot), torch.from_numpy(active),
                            1e-8)
    names = ("new_u", "new_v", "hg_new", "b", "den", "ev_u", "ev_v")
    for name, gt, wt in zip(names, got, want):
        assert tuple(gt.shape) == tuple(wt.shape), name
        _close(gt, wt, dtype)
    # the refused rows (inactive row 2, den-under-eps row 3) keep their ring
    for row in (2, 3):
        np.testing.assert_array_equal(_np(got[0][:, row]), _np(tu[:, row]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv,lengths", [(4, None), (2, (7, 3)), (1, (5, 0))])
def test_attention_ref_matches_jax(kv, lengths, dtype):
    rng = np.random.default_rng(kv)
    b, s, h, hd = 2, 7, 4, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    want = jref.attention_ref(jq, jk, jv, causal=True, kv_length=jl)
    got = tops.attention(tq, tk, tv, causal=True, kv_length=tl)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_ref_matches_jax(dtype):
    rng = np.random.default_rng(3)
    b, t, h, kv, hd = 3, 20, 4, 2, 16
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    lens = np.array([1, 11, 20], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_ref_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    want = jref.rmsnorm_ref(jx, jw, 1e-5)
    got = tops.rmsnorm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def test_broyden_step_ref_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    u, v, g, s, hg, mask, slot, active = _broyden_inputs(rng, 8, 5, 200)
    (ju, tu), (jv, tv) = _both(u, "bfloat16"), _both(v, "bfloat16")
    jg, tg = _both(g)
    js, ts = _both(s)
    jh, th = _both(hg)
    jm, tm = _both(mask)
    want = jops.broyden_step(ju, jv, jg, js, jh, jnp.float32(1.0), jm,
                             jnp.asarray(slot), jnp.asarray(active), 1e-8,
                             impl="pallas_interpret")
    got = tops.broyden_step(tu, tv, tg, ts, th, torch.tensor(1.0), tm,
                            torch.from_numpy(slot), torch.from_numpy(active),
                            1e-8)
    for gt, wt in zip(got, want):
        _close(gt, wt, "bfloat16")


def test_attention_ref_matches_pallas_interpret():
    rng = np.random.default_rng(12)
    b, s, h, kv, hd = 2, 16, 4, 2, 16
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    lens = np.array([16, 9], np.int32)
    want = jops.attention(jq, jk, jv, causal=True,
                          kv_length=jnp.asarray(lens),
                          impl="pallas_interpret")
    got = tops.attention(tq, tk, tv, causal=True,
                         kv_length=torch.from_numpy(lens))
    _close(got, want, "bfloat16")


def test_rmsnorm_ref_matches_pallas_interpret_within_bf16():
    """The precision split: the Pallas kernel scales in f32, the plain
    version (as the JAX oracle) in the activation dtype; at bf16 they agree
    within the bf16 tolerance."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, "bfloat16"), _both(w, "bfloat16")
    want = jops.rmsnorm(jx, jw, 1e-5, impl="pallas_interpret")
    got = tops.rmsnorm(tx, tw, 1e-5)
    _close(got, want, "bfloat16")


def test_qn_stream_counters_count_one_pass_per_broyden_step():
    rng = np.random.default_rng(0)
    u, v, g, s, hg, mask, slot, active = _broyden_inputs(rng, 4, 5, 8)
    t = [torch.from_numpy(a) for a in (u, v, g, s, hg, mask, slot, active)]
    tops.reset_qn_stream_stats()
    tops.broyden_step(t[0].to(torch.bfloat16), t[1].to(torch.bfloat16),
                      *t[2:5], torch.tensor(1.0), *t[5:], 1e-8)
    st = tops.qn_stream_stats()
    assert (st.calls, st.rhs) == (1, 2)
    assert st.uv_bytes == tops.qn_stream_bytes(4, 5, 8, 2, (False, True))


def test_ops_refuse_mixed_devices():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        tops.rmsnorm(x, torch.zeros(4, device="meta"))


# ---------------------------------------------------------------------------
# lowrank_append and qn_apply (off every path; ported as ops)
# ---------------------------------------------------------------------------


def _append_inputs(rng, m, bsz, dim):
    u = rng.standard_normal((m, bsz, dim)).astype(np.float32)
    v = rng.standard_normal((m, bsz, dim)).astype(np.float32)
    s, hy, b = (rng.standard_normal((bsz, dim)).astype(np.float32)
                for _ in range(3))
    inv_den = rng.standard_normal(bsz).astype(np.float32)
    slot = rng.integers(0, m, size=bsz).astype(np.int32)
    upd = (np.arange(bsz) % 2 == 0).astype(np.float32)
    return u, v, s, hy, b, inv_den, slot, upd


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,bsz,dim", [(2, 1, 8), (6, 3, 100)])
def test_lowrank_append_matches_jax_ref_and_pallas_interpret(m, bsz, dim,
                                                              dtype):
    rng = np.random.default_rng(m * 31 + dim)
    u, v, s, hy, b, inv_den, slot, upd = _append_inputs(rng, m, bsz, dim)
    (ju, tu), (jv, tv) = _both(u, dtype), _both(v, dtype)
    js, ts = _both(s)
    jh, th = _both(hy)
    jb, tb = _both(b)
    jargs = (js, jh, jb, jnp.asarray(inv_den), jnp.asarray(slot),
             jnp.asarray(upd))
    targs = (ts, th, tb, torch.from_numpy(inv_den), torch.from_numpy(slot),
             torch.from_numpy(upd))
    got = tops.lowrank_append(tu, tv, *targs)
    for impl in ("ref", "pallas_interpret"):
        want = jops.lowrank_append(ju, jv, *jargs, impl=impl)
        for gt, wt in zip(got, want):
            assert gt.dtype == tu.dtype
            # a copy (evicted rows, untouched rows) or one rounding of the
            # same f32 product: equal at either dtype
            np.testing.assert_array_equal(_np(gt), _np(wt))
    # functional on the CPU: the inputs are left as they were
    np.testing.assert_array_equal(_np(tu), _np(_both(u, dtype)[1]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_qn_apply_matches_jax_ref_and_pallas_interpret(dtype):
    rng = np.random.default_rng(21)
    u, v, xs, mask = _qn_inputs(rng, 5, 3, 100, 1)
    (ju, tu), (jv, tv) = _both(u, dtype), _both(v, dtype)
    (jx, tx), (jm, tm) = _both(xs[0], dtype), _both(mask)
    got = tops.qn_apply(tu, tv, tx, torch.tensor(0.7), tm)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for impl in ("ref", "pallas_interpret"):
        want = jops.qn_apply(ju, jv, jx, jnp.float32(0.7), jm, impl=impl)
        _close(got, want, dtype)
    # the K=1 case of qn_apply_multi
    _close(got, tops.qn_apply_multi(tu, tv, tx[None], torch.tensor(0.7),
                                    tm, (False,))[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowrank_apply_update_append_transpose_match_jax(dtype):
    from repro.core.lowrank import LowRank as JLowRank
    from repro_torch.core.lowrank import LowRank as TLowRank
    rng = np.random.default_rng(8)
    m, bsz, dim = 4, 3, 10
    u, v = (rng.standard_normal((m, bsz, dim)).astype(np.float32)
            for _ in range(2))
    s, hy, b, a = (rng.standard_normal((bsz, dim)).astype(np.float32)
                   for _ in range(4))
    den = np.array([0.5, -2.0, 3.0], np.float32)
    count = np.array([m + 1, 2, 0], np.int32)
    mask = np.array([True, False, True])
    (ju, tu), (jv, tv) = _both(u, dtype), _both(v, dtype)
    jl = JLowRank(alpha=jnp.float32(1.0), u=ju, v=jv,
                  count=jnp.asarray(count))
    tl = TLowRank(alpha=torch.tensor(1.0), u=tu, v=tv,
                  count=torch.from_numpy(count))
    jh, jev_u, jev_v = jl.apply_update(jnp.asarray(s), jnp.asarray(hy),
                                       jnp.asarray(b), jnp.asarray(den),
                                       jnp.asarray(mask))
    th, tev_u, tev_v = tl.apply_update(*(torch.from_numpy(x) for x in
                                         (s, hy, b, den, mask)))
    for got, want in ((th.u, jh.u), (th.v, jh.v), (tev_u, jev_u),
                      (tev_v, jev_v)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    np.testing.assert_array_equal(th.count.numpy(), np.asarray(jh.count))
    ja = jl.append(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    ta = tl.append(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(ta.u), _np(ja.u))
    np.testing.assert_array_equal(_np(ta.v), _np(ja.v))
    x = rng.standard_normal((bsz, dim)).astype(np.float32)
    _close(tl.transpose().matvec(torch.from_numpy(x)),
           jl.transpose().matvec(jnp.asarray(x)), "float32")
    _close(tl.transpose().matvec(torch.from_numpy(x)),
           tl.rmatvec(torch.from_numpy(x)), "float32")


# ---------------------------------------------------------------------------
# the autograd wrappers of attention and rmsnorm
# ---------------------------------------------------------------------------


def _jax_vjp(fn, inputs, cot):
    return jax.jit(lambda ins, c: jax.vjp(fn, *ins)[1](c))(inputs, cot)


def _grads(fn, inputs, cot):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_and_rmsnorm_wrappers_give_plain_autograd_grads(dtype):
    """The wrapper route (autograd.Function: forward by the op, backward by
    recomputing the plain version) against autograd straight through the
    plain version (bit for bit), and at f32 against JAX's custom VJP (in
    bf16 the weight gradient sums rows in another order than XLA, a few
    bf16 steps apart)."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(17)
    b, s, h, kv, hd = 2, 7, 4, 2, 16
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                                (b, s, h, hd)))
    tq, tk, tv, tg = (_both(a, dtype)[1] for a in (q, k, v, g))
    out_w, grads_w = _grads(lambda *a: tops.attention(*a, causal=True),
                            (tq, tk, tv), tg)
    out_p, grads_p = _grads(lambda *a: tref.attention_ref(*a, causal=True),
                            (tq, tk, tv), tg)
    assert torch.equal(out_w, out_p)
    for gw, gp in zip(grads_w, grads_p):
        assert torch.equal(gw, gp)
    if dtype == "float32":
        jq, jk, jv, jg = (_both(a, dtype)[0] for a in (q, k, v, g))
        for gw, gj in zip(grads_w, _jax_vjp(
                lambda *a: jops.attention(*a, causal=True, impl="ref"),
                (jq, jk, jv), jg)):
            _close(gw, gj, dtype)

    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    gx = rng.standard_normal((3, 5, 48)).astype(np.float32)
    (jx, tx), (jw, tw), (jgx, tgx) = (_both(a, dtype) for a in (x, w, gx))
    out_w, grads_w = _grads(lambda *a: tops.rmsnorm(*a, 1e-5), (tx, tw), tgx)
    out_p, grads_p = _grads(lambda *a: tref.rmsnorm_ref(*a, 1e-5), (tx, tw),
                            tgx)
    assert torch.equal(out_w, out_p)
    for gw, gp in zip(grads_w, grads_p):
        assert torch.equal(gw, gp)
    if dtype == "float32":
        for gw, gj in zip(grads_w, _jax_vjp(
                lambda *a: jops.rmsnorm(*a, 1e-5, impl="ref"), (jx, jw),
                jgx)):
            _close(gw, gj, dtype)
