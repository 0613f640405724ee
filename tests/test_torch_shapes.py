"""The port's shape suites and cell layouts against the JAX package's.

``repro_torch.configs.shapes`` is held to ``repro.configs.shapes`` for all
ten configs: ``SHAPES``, the skip rules and ``valid_cells``; the rules
``make_ctx`` picks for every arch x shape on the single-pod and multi-pod
meshes (JAX's as ``AbstractMesh``es), with sequence parallelism on and
off; and every input ``input_specs`` gives -- the batch, and for the decode
shapes the caches (JAX's through ``jax.eval_shape``) -- leaf by leaf, by
path: shape, dtype and spec (``None`` without a mesh).
"""

import dataclasses

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import shapes as jshapes
from repro.configs.registry import get_config as jax_get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch.dryrun import leaves_with_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import ShardCtx

MESH_KINDS = ("none", "single", "multi")


def _meshes(kind):
    if kind == "none":
        return None, None
    if kind == "single":
        return (make_production_mesh(),
                AbstractMesh((16, 16), ("data", "model")))
    return (make_production_mesh(multi_pod=True),
            AbstractMesh((2, 16, 16), ("pod", "data", "model")))


def _jpath(path) -> str:
    parts = []
    for p in path:
        parts.append(str(getattr(p, "key", getattr(p, "name", getattr(
            p, "idx", p)))))
    return "." + ".".join(parts)


def _torch_leaves(tree, specs, prefix=""):
    """``{path: (shape, dtype name, spec)}`` of a port input tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, None if specs is None else specs[k],
                                     f"{prefix}.{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for f, v, s in zip(tree._fields, tree,
                           specs if specs is not None else [None] * len(tree)):
            out.update(_torch_leaves(v, s, f"{prefix}.{f}"))
        return out
    ((t, s),) = leaves_with_specs(tree, specs)
    return {prefix: (tuple(t.shape), str(t.dtype).replace("torch.", ""), s)}


def _jax_leaves(tree):
    out = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(tree)[0]:
        sh = sds.sharding
        out[_jpath(path)] = (tuple(sds.shape), str(sds.dtype),
                             None if sh is None else tuple(sh.spec))
    return out


def test_shapes_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert tshapes.valid_cells(cfg) == jshapes.valid_cells(jcfg)
        for name in tshapes.SHAPES:
            assert tshapes.cell_skip_reason(cfg, tshapes.SHAPES[name]) == \
                jshapes.cell_skip_reason(jcfg, jshapes.SHAPES[name])
            assert tshapes.rules_for_shape(tshapes.SHAPES[name]).table == \
                jshapes.rules_for_shape(jshapes.SHAPES[name]).table


@pytest.mark.parametrize("arch", list(ARCHS))
def test_make_ctx_rules_equal_jax(arch):
    for sp in (False, True):
        cfg = get_config(arch, seq_parallel=sp)
        jcfg = jax_get_config(arch, seq_parallel=sp)
        for kind in MESH_KINDS:
            tm, jm = _meshes(kind)
            for name in tshapes.SHAPES:
                got = tshapes.make_ctx(cfg, tm, tshapes.SHAPES[name])
                want = jshapes.make_ctx(jcfg, jm, jshapes.SHAPES[name])
                assert dict(got.rules.table) == dict(want.rules.table), \
                    (sp, kind, name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_and_caches_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for kind in MESH_KINDS:
        tm, jm = _meshes(kind)
        for name in tshapes.valid_cells(cfg):
            shape = tshapes.SHAPES[name]
            ctx = tshapes.make_ctx(cfg, tm, shape)
            jctx = jshapes.make_ctx(jcfg, jm, jshapes.SHAPES[name])
            inputs, specs = tshapes.input_specs(cfg, shape, ctx)
            got = _torch_leaves(inputs, specs)
            want = _jax_leaves(jshapes.input_specs(jcfg, jshapes.SHAPES[name],
                                                   jctx))
            assert got == want, (kind, name)


def test_cache_sharding_without_a_mesh_is_none():
    cfg = get_config("zamba2-2.7b")
    caches = tshapes.input_specs(cfg, tshapes.SHAPES["decode_32k"],
                                 ShardCtx.for_mesh(None))[0]["caches"]
    specs = tshapes.cache_sharding(cfg, ShardCtx.for_mesh(None), caches)
    assert {s for _, s in leaves_with_specs(caches, specs)} == {None}
    assert {t.device.type for t, _ in leaves_with_specs(caches)} == {"meta"}
