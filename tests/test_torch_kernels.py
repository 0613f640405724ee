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
