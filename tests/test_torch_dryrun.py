"""The port's dry-run (``repro_torch.launch.dryrun``) and its struct helpers.

  * the reduced depths and layer periods the reference's tests expect
    (``tests/test_dryrun_tools.py``);
  * per-device argument bytes of every cell on the single-pod and
    multi-pod meshes equal the sum over JAX's ``param_structs`` /
    ``train_state_structs`` / ``input_specs`` of each leaf's shard shape
    under ``NamedSharding(AbstractMesh, spec)`` (an uneven split, which JAX
    refuses, counted at its rounded-up shard);
  * ``train_state_structs`` is leaf for leaf ``init_train_state``;
  * the ``meta`` FLOP and byte counts of a smoke train step, prefill and
    decode step equal the counts of the same step on real CPU tensors,
    exactly; the extrapolation from two depths equals a whole count;
  * kernel ops take the CPU's routes on ``meta`` tensors, and a mix with
    the card's raises;
  * one full-size cost cell (MiniCPM-2B ``prefill_32k`` on the single pod)
    through ``main``, its count held to the analytic matrix-product count
    of the model (projections, tiles of the chunked attention, the head).
"""

import dataclasses
import json
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import shapes as jshapes
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel.sharding import NULL_CTX

DEQ_ARCHS = ("minicpm-2b", "deepseek-moe-16b", "zamba2-2.7b")


def test_reduced_depths_per_family():
    assert dryrun._reduced_depths(ARCHS["minicpm-2b"]) == (1, 2)
    assert dryrun._reduced_depths(ARCHS["zamba2-2.7b"]) == (6, 12)
    assert dryrun._reduced_depths(ARCHS["xlstm-1.3b"]) == (8, 16)
    moe = dryrun._reduced_depths(ARCHS["deepseek-moe-16b"])
    assert moe[1] - moe[0] == 1
    assert moe[0] > ARCHS["deepseek-moe-16b"].moe.first_k_dense - 1
    assert dryrun._layer_period(ARCHS["zamba2-2.7b"]) == 6
    assert dryrun._layer_period(ARCHS["pixtral-12b"]) == 1


def _jax_bytes(tree) -> int:
    total = 0
    for sds in jax.tree_util.tree_leaves(tree):
        sh = sds.sharding
        try:
            local = sh.shard_shape(sds.shape)
        except ValueError:  # uneven: the padded shard
            sizes = sh.mesh.shape
            spec = tuple(sh.spec) + (None,) * (len(sds.shape) - len(sh.spec))
            local = tuple(
                -(-d // math.prod(sizes[n] for n in
                                  ((e,) if isinstance(e, str) else e or ())))
                for d, e in zip(sds.shape, spec))
        total += math.prod(local) * np.dtype(sds.dtype).itemsize
    return total


def _jax_argument_bytes(arch, shape_name, multi, deq) -> int:
    jcfg = jax_get_config(arch, deq=deq)
    shape = jshapes.SHAPES[shape_name]
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
            else AbstractMesh((16, 16), ("data", "model")))
    ctx = jshapes.make_ctx(jcfg, mesh, shape)
    specs = jshapes.input_specs(jcfg, shape, ctx)
    if shape.kind == "train":
        tcfg = JTrainConfig(global_batch=shape.global_batch,
                            seq_len=shape.seq_len, zero1=True)
        args = (jsteps.train_state_structs(jcfg, tcfg, ctx), specs["batch"])
    elif shape.kind == "prefill":
        args = (jsteps.param_structs(jcfg, ctx), specs["batch"])
    else:
        args = (jsteps.param_structs(jcfg, ctx), specs["caches"],
                specs["tokens"], specs["cache_index"])
    return sum(_jax_bytes(a) for a in args)


def _cells():
    out = [(a, s, False) for a, c in ARCHS.items()
           for s in tshapes.valid_cells(c)]
    return out + [(a, "train_4k", True) for a in DEQ_ARCHS]


@pytest.mark.parametrize("arch,shape_name,deq", _cells())
def test_argument_bytes_equal_jax_shards(arch, shape_name, deq):
    shape = tshapes.SHAPES[shape_name]
    tcfg = dryrun._train_config(shape, 1)
    cfg = get_config(arch, deq=deq)
    cfg = dryrun._costing_config(cfg, cfg.num_layers)
    for multi in (False, True):
        mem = dryrun.memory_cell(cfg, shape,
                                 make_production_mesh(multi_pod=multi), tcfg,
                                 run=False)
        assert mem["argument_bytes"] == _jax_argument_bytes(
            arch, shape_name, multi, deq), multi
        assert mem["temp_bytes"] is None
        if shape.kind != "prefill":
            assert 0 < mem["alias_bytes"] <= mem["output_bytes"]


@pytest.mark.parametrize("deq", [False, True])
def test_train_state_structs_match_real_state(deq):
    cfg = smoke_config("minicpm-2b", deq=deq)
    tcfg = TrainConfig(global_batch=2, seq_len=8, zero1=False)
    struct, specs = steps.train_state_structs(cfg, tcfg, NULL_CTX)
    state = steps.init_train_state(cfg, tcfg, device="cpu")
    got = [(tuple(t.shape), t.dtype) for t, _ in
           dryrun.leaves_with_specs(struct, specs)]
    want = [(tuple(t.shape), t.dtype) for t, _ in
            dryrun.leaves_with_specs(state)]
    assert got == want
    assert (state.carry is not None) == deq
    assert specs is None  # no mesh: replicated
    assert {t.device.type for t, _ in dryrun.leaves_with_specs(struct)} == \
        {"meta"}


def _real_args(cell, cfg, shape, tcfg, gen):
    """The cell's arguments as real CPU tensors (random parameters and
    tokens, cold caches and state)."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda *sz: torch.randint(0, cfg.vocab_size, sz,  # noqa: E731
                                    generator=gen, dtype=torch.int32)
    if shape.kind == "train":
        batch = {"tokens": tok(b, s), "targets": tok(b, s)}
        return (steps.init_train_state(cfg, tcfg, device="cpu"), batch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    if shape.kind == "prefill":
        return (params, {"tokens": tok(b, s)})
    return (params, lm.init_cache(cfg, b, s, device="cpu"), tok(b),
            torch.tensor([3, 7][:b], dtype=torch.int32))


@pytest.mark.parametrize("arch,deq", [
    ("minicpm-2b", False), ("minicpm-2b", True),
    ("deepseek-v2-lite-16b", False), ("zamba2-2.7b", False)])
def test_meta_counts_equal_real_cpu_counts(arch, deq):
    cfg = smoke_config(arch, deq=deq)
    cfg = dryrun._costing_config(dataclasses.replace(
        cfg, dtype="float32", deq=dataclasses.replace(cfg.deq, max_steps=3)),
        cfg.num_layers)
    gen = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        shape = tshapes.ShapeSuite(kind, kind, 8, 2)
        tcfg = dryrun._train_config(shape, 1)
        cell = dryrun.build_cell(cfg, shape, None, tcfg)
        meta = dryrun.count_cost(cell)
        real = dryrun.count_cost(dataclasses.replace(
            cell, args=_real_args(cell, cfg, shape, tcfg, gen)))
        assert meta["flops"] > 0
        assert (meta["flops"], meta["bytes"]) == \
            (real["flops"], real["bytes"]), kind


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch,deq", [
    ("minicpm-2b", False), ("deepseek-moe-16b", False),
    ("zamba2-2.7b", False), ("minicpm-2b", True)])
def test_extrapolation_equals_a_whole_count(arch, deq, kind):
    """FLOPs extrapolate exactly, and so do the bytes of a forward and of a
    DEQ step (linear in the solver steps).  A layer stack's backward is not
    linear in bytes: the gradient of each layer's slice of a stacked leaf
    is written into a zero tensor of the whole stack (``select``'s
    backward), so the extrapolation understates a deep stack's bytes."""
    base = smoke_config(arch, deq=deq)
    shape = tshapes.ShapeSuite(kind, kind, 16, 2)
    tcfg = dryrun._train_config(shape, 1)
    if deq:
        cfg = dataclasses.replace(base, deq=dataclasses.replace(
            base.deq, max_steps=6))
        whole = dataclasses.replace(cfg, deq=dataclasses.replace(
            cfg.deq, unroll=True))
    else:
        l0, l1 = dryrun._reduced_depths(base)
        cfg = dataclasses.replace(base, num_layers=l0 + 2 * (l1 - l0))
        whole = cfg
    got = dryrun.cost_cell(cfg, shape, None, tcfg)
    want = dryrun.count_cost(dryrun.build_cell(whole, shape, None, tcfg))
    assert got["extrapolation_axis"] == ("solver_steps" if deq else "layers")
    assert got["extrapolated"]["flops"] == want["flops"]
    if deq or kind == "prefill":
        assert got["extrapolated"]["bytes"] == want["bytes"]
    else:
        assert got["extrapolated"]["bytes"] < want["bytes"]


def test_meta_takes_the_cpu_routes_and_a_card_mix_raises():
    q = torch.empty(2, 16, 4, 8, device="meta")
    assert ops._on_card(q) is False
    assert ops.attention_route(None, q, q) == "plain"
    big = torch.empty(1, 1024, 4, 8, device="meta")
    assert ops.attention_route(None, big, big) == "flash_xla"
    assert ops.rmsnorm(q, torch.empty(8, device="meta")).device.type == "meta"
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="all-meta"):
        ops._on_card(q, card)
    with pytest.raises(ValueError, match="all-meta"):
        ops._on_card(torch.empty(2), q)


def test_main_runs_a_full_size_cost_cell(tmp_path):
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "prefill_32k",
                        "--mesh", "single", "--variant", "cost",
                        "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "minicpm-2b__prefill_32k__single__cost.json"
                      ).read_text())
    cfg = get_config("minicpm-2b")
    b, s, d, ff = 32, 32768, cfg.d_model, cfg.d_ff
    h, hd = cfg.num_heads, cfg.head_dim_
    # the chunked attention's tiles at or below the causal diagonal
    tiles = sum((i * 512 + 511) // 1024 + 1 for i in range(s // 512))
    layer = (2 * b * s * (2 * d * cfg.attn_dim + 2 * d * cfg.kv_dim
                          + 3 * d * ff)
             + tiles * 4 * 512 * 1024 * hd * h * b)
    head = 2 * b * s * d * cfg.padded_vocab
    ext = res["extrapolated"]
    assert ext["flops_per_layer"] == layer
    assert ext["flops"] == head + cfg.num_layers * layer
    assert sorted(res["depths"]) == ["1", "2"]
    assert res["num_layers"] == 40 and res["chips"] == 256
    assert ext["collective_bytes"] is None
    assert ext["bytes"] > 0 and res["params"] == cfg.num_params()


def test_live_bytes_counts_new_storages_at_their_blocks_and_their_peak():
    """Allocations count at their 512-byte block from the op that makes
    them until they are freed; views and in-place ops of the arguments
    allocate nothing."""
    arg = torch.empty(1000, device="meta")            # 4000 B, not counted
    with dryrun.LiveBytes() as live:
        v = arg[:10].view(2, 5)                       # a view: nothing
        arg.add_(1)                                   # in place: nothing
        a = arg * 2                                   # 4000 -> 4096
        b = torch.empty(10, device="meta")            # 40 -> 512
        del a
        c = b + 1                                     # 512
    assert (live.peak, live.current) == (4096 + 512, 1024)
    del v, b, c
    assert live.current == 0


def test_meta_is_a_device_only_by_name_and_the_launchers_refuse_it():
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    assert resolve_device("meta").type == "meta"
    assert lm.init_cache(smoke_config("zamba2-2.7b"), 2, 8, "meta")[
        "group0"]["mamba"].state.device.type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    for main in (serve.main, train.main):
        with pytest.raises(SystemExit):
            main(["--smoke", "--device", "meta"])


def test_all_cells_is_the_reference_matrix_plus_one_card(tmp_path):
    cells = dryrun.all_cells()
    assert len(cells) == len(set(cells)) == 10 * 4 * 3 + 3 * 3 + sum(
        len(tshapes.valid_cells(c)) for c in ARCHS.values())
    ones = [c for c in cells if c[2] == "one"]
    assert {c[3] for c in ones} == {"memory"} and not any(c[4] for c in ones)
    assert dryrun.cell_name(("minicpm-2b", "train_4k", "single", "cost",
                             True)) == "minicpm-2b/train_4k/single/cost/deq"
    with pytest.raises(ValueError, match="names no cell"):
        dryrun.run_all(tmp_path, 1, 10, ("minicpm-2b/train_4k/two/cost",))
    assert dryrun.run_cell("hubert-xlarge", "decode_32k", "one",
                           "memory") == {
        "skipped": "encoder-only: no autoregressive decode"}
