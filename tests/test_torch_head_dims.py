"""The dense DEQ LM at the registered configs' head dims against the JAX
package's, on the CPU.

``phi3-mini-3.8b`` (head dim 96), ``stablelm-3b`` (80) and
``internlm2-20b`` (128, grouped query heads) at tiny widths: 2 query heads
(over 1 kv head for InternLM2's grouping), d_model 32, 2 weight-tied
blocks, f32.  The same parameters (drawn by the JAX package) and prompts
go through both packages: prefill logits and solver steps, then two
warm-started decode steps with one slot frozen (logits, steps, statuses),
at the tolerances of ``tests/test_torch_serving.py``.  Also: the attention
kernel's head dims are the registry's, in the wrapper and in the CUDA
source alike.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import ShardCtx
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.models import lm as tlm

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)
HEAD_DIMS = {"stablelm-3b": (80, 2), "phi3-mini-3.8b": (96, 2),
             "internlm2-20b": (128, 1)}


def _tiny(cfg, hd, kv):
    return dataclasses.replace(
        cfg, d_model=32, num_heads=2, num_kv_heads=kv, d_ff=64,
        vocab_size=128, head_dim=hd, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=40, tol=1e-4, memory=16))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", sorted(HEAD_DIMS))
def test_prefill_and_decode_match_jax_at_head_dim(arch):
    hd, kv = HEAD_DIMS[arch]
    assert ARCHS[arch].head_dim == hd
    jcfg = _tiny(jax_smoke_config(arch, deq=True), hd, kv)
    tcfg = _tiny(smoke_config(arch, deq=True), hd, kv)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jp["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                              jp["deq_blocks"])
    tp = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b, s, max_len = 3, 6, 16
    toks = np.random.default_rng(1).integers(2, jcfg.vocab_size, size=(b, s))
    pc, pl = jlm.prefix_seed_carry(jcfg, b, s, [None] * b)  # all cold
    jl, jc, _, jseed, _, jsteps = jlm.prefill(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg, CTX, max_len,
        carry=jlm.deq_solve_carry(jcfg, b, 1), prefix_carry=pc,
        prefix_len=pl)
    tl, tc, _, tseed, tsteps = tlm.prefill(
        tp, {"tokens": torch.tensor(toks, dtype=torch.int32)}, tcfg, max_len,
        carry=tlm.deq_solve_carry(tcfg, b, 1, "cpu"), return_steps=True)
    assert tsteps == float(jsteps) and tsteps > 2
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for jt, tt in zip(jc["deq"], tc["deq"]):
        assert tt.shape[-2:] == (kv, hd)
        np.testing.assert_allclose(_np(tt), _np(jt), **TOL)

    active = np.array([True, False, True])
    idx = np.full((b,), s, np.int32)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    for _ in range(2):
        jl, jc, jseed, jsteps, jst = jlm.decode_step(
            jp, jc, jnp.asarray(tok), jnp.asarray(idx), jcfg, CTX,
            active=jnp.asarray(active), carry=jseed, return_steps=True,
            return_status=True)
        tl, tc, tseed, tsteps, tst = tlm.decode_step(
            tp, tc, torch.from_numpy(tok), torch.from_numpy(idx), tcfg,
            active=torch.from_numpy(active), carry=tseed, return_steps=True,
            return_status=True)
        assert tsteps == float(jsteps)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        idx = idx + active.astype(np.int32)


def test_kernel_head_dims_are_the_registry_s():
    src = (build.CSRC / "flash_attention.cu").read_text()
    cases = tuple(int(d) for d in re.findall(r"FA_CASE\((\d+)\)\n", src))
    assert cases == cuda_fa.HEAD_DIMS
    # an MLA config attends at qk_nope + qk_rope (v padded to it); its
    # smoke width (16 + 8 = 24) runs only the plain version on the CPU;
    # the SSM family (xLSTM) has no attention
    attending = {n: c for n, c in ARCHS.items() if c.family != "ssm"}
    want = {cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
            if cfg.attn_type == "mla" else cfg.head_dim
            for cfg in attending.values()} | {
        smoke_config(name).head_dim for name in attending
        if attending[name].attn_type != "mla"}
    assert want == set(cuda_fa.HEAD_DIMS)
