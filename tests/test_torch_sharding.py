"""The port's sharding rules and parameter specs against the JAX package's.

``repro_torch.parallel.sharding`` is held to ``repro.parallel.sharding``:
the five rule tables key for key, the reference's unit cases
(``tests/test_sharding.py``), and for all ten configs at full size the spec
and ZeRO-1 spec of every parameter, by path, under every rule set with no
mesh, the raw rules, and the single-pod and multi-pod meshes (JAX's as
``AbstractMesh``es, which need no devices).  A spec is a plain tuple here,
a ``PartitionSpec`` there: they are compared as tuples.  The declarations
(shape, axes, initializer, scale) and ``num_params`` equal JAX's too.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.parallel import sharding as jsh
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch.mesh import (
    ONE_CARD,
    MeshSpec,
    make_production_mesh,
    make_test_mesh,
)
from repro_torch.models import lm
from repro_torch.models.layers import ParamDecl
from repro_torch.parallel import sharding as tsh

RULE_SETS = ("TRAIN_RULES", "TRAIN_SP_RULES", "DECODE_RULES",
             "PREFILL_RULES", "LONG_CONTEXT_RULES")
MESHES = ("raw", "none", "single", "multi")


def _jax_mesh(kind):
    if kind == "single":
        return AbstractMesh((16, 16), ("data", "model"))
    return AbstractMesh((2, 16, 16), ("pod", "data", "model"))


def _rules(kind, name):
    """(port rules, JAX rules, port mesh, JAX mesh) for a mesh kind."""
    tr, jr = getattr(tsh, name), getattr(jsh, name)
    if kind == "raw":
        return tr, jr, None, None
    if kind == "none":
        return (tsh.rules_for_mesh(tr, None), jsh.rules_for_mesh(jr, None),
                None, None)
    tm = make_production_mesh(multi_pod=kind == "multi")
    jm = _jax_mesh(kind)
    return tsh.rules_for_mesh(tr, tm), jsh.rules_for_mesh(jr, jm), tm, jm


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (jsh.ParamDecl, jsh.P)))[0]
    return {"".join(f"/{p.key}" for p in path): v for path, v in leaves}


@pytest.mark.parametrize("name", RULE_SETS)
def test_rule_tables_equal_jax(name):
    assert dict(getattr(tsh, name).table) == dict(getattr(jsh, name).table)
    assert dict(tsh.NULL_CTX.rules.table) == dict(jsh.NULL_CTX.rules.table)


def test_spec_basic_and_dedup():
    r = tsh.TRAIN_RULES
    assert r.spec(("embed", "mlp")) == (None, "model")
    # a mesh axis appears at most once: the second "model" user degrades
    assert r.spec(("heads", "kv")) == ("model", None)
    assert r.spec(("batch", "seq", "embed_act")) == (("pod", "data"), None,
                                                     None)
    with pytest.raises(KeyError, match="unknown logical axis"):
        r.spec(("nope",))


def test_decode_rules_shard_cache_sequence():
    assert tsh.DECODE_RULES.spec(("layers", "batch", "kv_seq", None, None)) \
        == (None, ("pod", "data"), "model", None, None)


def test_long_context_rules_context_parallel():
    spec = tsh.LONG_CONTEXT_RULES.spec(("layers", "batch", "kv_seq", None,
                                        None))
    assert spec == (None, None, ("pod", "data"), None, None)


def test_rules_for_mesh_drops_missing_axes():
    r = tsh.rules_for_mesh(tsh.TRAIN_RULES, make_test_mesh())
    assert r.spec(("batch",)) == ("data",)  # "pod" dropped, 1-tuple unwrapped
    assert tsh.rules_for_mesh(tsh.TRAIN_RULES, None).spec(("mlp",)) == (None,)


def test_zero1_spec_shards_largest_replicated_dim():
    d = ParamDecl((1024, 4096), ("embed", "mlp"))
    assert tsh.zero1_spec(d, tsh.TRAIN_RULES) == ("data", "model")
    # vocab took "model"; embed picks up "data"
    d2 = ParamDecl((50304, 2048), ("vocab", "embed"))
    assert tsh.zero1_spec(d2, tsh.TRAIN_RULES) == ("model", "data")
    d3 = ParamDecl((64,), ("scale",))
    assert tsh.zero1_spec(d3, tsh.TRAIN_RULES) == ("data",)
    # an indivisible dim stays replicated
    assert tsh.zero1_spec(ParamDecl((30,), ("scale",)), tsh.TRAIN_RULES,
                          zero_size=16) == (None,)


def test_decl_axes_length_is_checked():
    with pytest.raises(ValueError, match="vs axes"):
        ParamDecl((4, 4), ("embed",))


def test_shard_ctx_local_shape_and_axis_size():
    ctx = tsh.ShardCtx.for_mesh(make_production_mesh(multi_pod=True))
    assert ctx.axis_size("batch") == 32
    assert ctx.axis_size("mlp") == 16
    assert ctx.axis_size("embed") == 1
    # uneven splits round up (the padded last shard)
    assert ctx.local_shape((30, 100, 7), ("batch", "mlp", None)) == (1, 7, 7)
    assert tsh.ShardCtx.for_mesh(None).local_shape((30, 5),
                                                   ("batch", "mlp")) == (30, 5)
    assert tsh.ShardCtx.for_mesh(ONE_CARD).local_shape(
        (30, 5), ("batch", "mlp")) == (30, 5)


def test_mesh_descriptions():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert (single.axis_names, dict(single.shape), single.size) == \
        (("data", "model"), {"data": 16, "model": 16}, 256)
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    assert multi.size == 512 and ONE_CARD.size == 1
    assert dict(ONE_CARD.shape) == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        MeshSpec(("data",), (1, 2))


@pytest.mark.parametrize("deq", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_declarations_and_num_params_equal_jax(arch, deq):
    cfg, jcfg = get_config(arch, deq=deq), jax_get_config(arch, deq=deq)
    mine = _flat(lm.model_decl(cfg))
    theirs = _jflat(jlm.model_decl(jcfg))
    assert sorted(mine) == sorted(theirs)
    for path, d in mine.items():
        j = theirs[path]
        assert (d.shape, d.axes, d.init, d.scale) == \
            (tuple(j.shape), tuple(j.axes), j.init, j.scale), path
    for active in (False, True):
        assert cfg.num_params(active_only=active) == \
            jcfg.num_params(active_only=active)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_spec_trees_equal_jax(arch):
    """Every parameter's spec and ZeRO-1 spec, by path, for every rule set
    on every mesh kind (the DEQ form too)."""
    assert set(ARCHS) == set(JARCHS)
    for deq in (False, True):
        decl = lm.model_decl(get_config(arch, deq=deq))
        jdecl = jlm.model_decl(jax_get_config(arch, deq=deq))
        for name in RULE_SETS:
            for kind in MESHES:
                tr, jr, tm, jm = _rules(kind, name)
                zsize = 0 if tm is None else tm.shape["data"]
                got = _flat(tsh.spec_tree(decl, tr))
                want = {k: tuple(v) for k, v in
                        _jflat(jsh.spec_tree(jdecl, jr)).items()}
                assert got == want, (name, kind)
                got = _flat(tsh.zero1_spec_tree(decl, tr, zero_size=zsize))
                want = {k: tuple(v) for k, v in _jflat(jsh.zero1_spec_tree(
                    jdecl, jr, zero_size=zsize)).items()}
                assert got == want, (name, kind, "zero1")
