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
    of the model (projections, tiles of the chunked attention, the head),
    its collective bytes those of the sharded step on a fake 256-rank
    world (the layers' all-reduces and all-gathers, by their ring factors);
  * the collective accounting (``collective_bytes``) against the
    reference's on the reference's own HLO example, and ``Collectives``
    reading both the functional and the plain ``c10d`` collectives with
    their groups' sizes;
  * a fake world's cells: a smoke memory cell on the 256-rank single pod
    with ``temp_bytes`` and ``collectives``; the sharded loss allocates no
    tensor of the whole global logits; the faults the fake world found
    (a ``fake`` group refused for a CPU mesh, ``distribute_tree`` failing
    on a ``None`` leaf).  ``tests/test_torch_distributed.py`` holds a fake
    (2, 2) world's cells against the real gloo world's, collective by
    collective and byte for byte.
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
    assert ext["bytes"] > 0 and res["params"] == cfg.num_params()
    # the sharded step on a fake 256-rank world: per layer, the attention
    # and MLP outputs' all-reduces over "model" (16), and the gathers over
    # it where 36 heads do not divide 16: q's projection (144 columns a
    # rank) and the attention output, whose shards of 3 heads (none on
    # the last 4 ranks) DTensor pads to 16 x 3 = 48 heads to gather
    depth = {int(k): v for k, v in res["depths"].items()}
    assert depth[2]["collective_counts"] == {"all-reduce": 5,
                                             "all-gather": 4}
    rows = b // 16 * s                       # one device's tokens
    act = rows * d * 2                       # a bf16 (rows, d) activation
    layer = (2 * (2 * act * 15 / 16) + act * 15 / 16
             + act * 48 / 36 * 15 / 16)
    assert ext["collective_bytes_per_layer"] == layer
    assert ext["collective_bytes"] == depth[1]["collective_bytes"] + (
        cfg.num_layers - 1) * layer


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


# ---------------------------------------------------------------------------
# collectives and the fake world
# ---------------------------------------------------------------------------

# the reference's HLO example (tests/test_dryrun_tools.py) as issued
# collectives: (kind, result bytes, group size)
REF_HLO_RECORDS = [
    ("all-reduce", 16 * 128 * 4, 4),                 # f32[16,128], {0..3}
    ("all-gather", 64 * 256 * 2, 4),                 # bf16[64,256], [2,4]
    ("reduce-scatter", 8 * 128 * 4, 4),              # f32[8,128], {0..3}
    ("collective-permute", 32 * 2, 1),               # bf16[32]
    ("all-reduce", (128 + 64) * 4, 2),               # (f32[128], f32[64])
]


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun`` without its XLA_FLAGS line reaching this
    process (as ``tests/test_dryrun_tools.py`` imports it)."""
    import importlib
    import os
    before = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


def test_collective_bytes_equals_the_reference_on_its_hlo_example(
        ref_dryrun):
    from test_dryrun_tools import HLO
    want = ref_dryrun.collective_bytes(HLO)
    got = dryrun.collective_bytes(REF_HLO_RECORDS)
    assert got["counts"] == want["counts"]
    assert got["bytes"].keys() == want["bytes"].keys()
    for kind, b in want["bytes"].items():
        assert got["bytes"][kind] == pytest.approx(b), kind
    one = "%ar = f32[128]{0} all-reduce(%x), replica_groups={{0}}, to_apply=%a"
    assert ref_dryrun.collective_bytes(one) == dryrun.collective_bytes(
        [("all-reduce", 512, 1)]) == {"bytes": {"total": 0}, "counts": {}}


def test_collectives_reads_functional_and_c10d_ops_with_their_groups():
    """DTensor's redistributions reach the functional ops, direct calls
    the ``c10d`` ops; each record carries its result bytes and its
    group's size (a mesh dim's 4, the world's 8)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import MeshSpec

    with dryrun.fake_world(MeshSpec(("data", "model"), (2, 4))) as mesh:
        x = distribute_tensor(torch.empty(8, 12, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        part = torch.empty(3, device="meta")
        with dryrun.Collectives() as coll:
            x.redistribute(mesh, [Replicate(), Replicate()])
            dist.all_gather([torch.empty_like(part) for _ in range(4)], part,
                            group=mesh.get_group(1))
            dist.all_reduce(torch.empty(5, device="meta"))
    assert [tuple(r) for r in coll.records] == [
        ("all-gather", 8 * 12 * 4, 4), ("all-gather", 4 * 3 * 4, 4),
        ("all-reduce", 5 * 4, 8)]
    assert not dist.is_initialized()


def test_a_fake_group_builds_a_cpu_mesh_and_the_backends_stay_checked(
        monkeypatch):
    """F4: ``build_device_mesh`` took only gloo for a CPU mesh, so the
    dry-run's fake world could not build one.  A CUDA mesh still needs
    NCCL, a CPU mesh gloo or fake."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    spec = mesh_mod.MeshSpec(("data", "model"), (2, 2))
    with dryrun.fake_world(spec) as dm:
        assert dm.mesh_dim_names == ("data", "model")
        assert tuple(dm.mesh.shape) == (2, 2)
        with pytest.raises(RuntimeError, match="cuda mesh runs on nccl"):
            mesh_mod._check_backend("cuda")
    for backend, device in (("gloo", "cuda"), ("nccl", "cpu")):
        monkeypatch.setattr(dist, "get_backend", lambda b=backend: b)
        with pytest.raises(RuntimeError, match=f"process group is {backend}"):
            mesh_mod._check_backend(device)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    mesh_mod._check_backend("cuda")


def test_distribute_tree_passes_a_none_leaf():
    """F6: the train state of a config without a DEQ has ``carry=None``,
    which ``distribute_tree`` tried to detach."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.parallel.sharding import ShardCtx, distribute_tree

    cfg = smoke_config("minicpm-2b")
    tcfg = TrainConfig(global_batch=4, seq_len=8, zero1=True)
    spec = MeshSpec(("data", "model"), (2, 2))
    with dryrun.fake_world(spec) as dm:
        state, specs = steps.train_state_structs(
            cfg, tcfg, ShardCtx.for_mesh(dm))
        assert state.carry is None and specs.carry is None
        placed = distribute_tree(state, specs, dm)
    assert placed.carry is None
    assert tuple(placed.params["embed"]["embedding"].to_local().shape) == (
        cfg.padded_vocab // 2, cfg.d_model)


@pytest.mark.parametrize("vocab", [4096, 8192])
def test_a_single_pod_memory_cell_of_a_smoke_arch(vocab):
    """On the fake 256-rank world: the sharded step's peak in the local
    shards and every collective it issued; ``argument_bytes`` as without
    running it.  The peak grows with the vocab over the 16 "model" ranks
    that split it, a few f32 copies of a rank's rows at ``V / 16`` above
    the smoke vocab's (F10: gathered, five copies at the whole ``V``)."""
    shape = tshapes.ShapeSuite("train", "train", 64, 32)
    tcfg = dryrun._train_config(shape, 1)
    mesh = dryrun.mesh_for("single")
    temps = {}
    for v in (512, vocab):
        cfg = dryrun._costing_config(dataclasses.replace(
            smoke_config("minicpm-2b"), vocab_size=v), 2)
        with dryrun.fake_world(mesh) as world:
            mem = dryrun.memory_cell(cfg, shape, mesh, tcfg, run=True,
                                     world=world)
        temps[v] = mem["temp_bytes"]
    laid = dryrun.memory_cell(cfg, shape, mesh, tcfg, run=False)
    assert mem["argument_bytes"] == laid["argument_bytes"]
    assert mem["temp_bytes"] > 0 and mem["run_seconds"] >= 0
    counts = mem["collectives"]["counts"]
    assert counts["all-reduce"] > 0 and counts["reduce-scatter"] > 0
    assert mem["collectives"]["bytes"]["total"] > 0
    rows = shape.global_batch // mesh.shape["data"] * shape.seq_len
    grown = temps[vocab] - temps[512]
    assert 0 < grown < 6 * rows * (vocab - 512) // mesh.shape["model"] * 4


def test_a_single_pod_xlstm_cell_splits_its_padded_heads():
    """F12: the 4-head smoke xLSTM (one unit: 3 mLSTM + 1 sLSTM layers; S
    128, 8 chunks of 16; 2 rows a rank) on the fake 256-rank world, whose
    "model" 16 does not divide its heads.  Every rank ran all 4 heads of
    the mLSTM chunk loop and autograd kept every chunk's intermediates:
    8.18 MB of temp on the parent.  Now each rank runs one head of the
    heads padded to 16 and keeps its chunk entry states and inputs: 1.47
    MB.  Bound: four times the unit's four layers' one-head chunk states
    and inputs a rank (1.90 MB)."""
    from repro_torch.models import xlstm as txl

    shape = tshapes.ShapeSuite("train", "train", 128, 32)
    tcfg = dryrun._train_config(shape, 1)
    mesh = dryrun.mesh_for("single")
    cfg = dryrun._costing_config(smoke_config("xlstm-1.3b"), 4)
    with dryrun.fake_world(mesh) as world:
        mem = dryrun.memory_cell(cfg, shape, mesh, tcfg, run=True,
                                 world=world)
    laid = dryrun.memory_cell(cfg, shape, mesh, tcfg, run=False)
    assert mem["argument_bytes"] == laid["argument_bytes"]
    _, h, hd = txl._mlstm_dims(cfg)
    assert h % mesh.shape["model"]
    rows = shape.global_batch // mesh.shape["data"]
    nc = shape.seq_len // cfg.xlstm.chunk
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    state = rows * (hd * hd + hd + 1) * 4
    inputs = rows * shape.seq_len * (3 * hd * act + 2 * 4)
    assert mem["temp_bytes"] < 4 * cfg.num_layers * (nc * state + inputs)


def test_xlstm_at_mesh_1x1_is_bit_for_bit_the_unsharded_run(tmp_path):
    """On a one-rank gloo world the (1, 1) mesh runs the xLSTM's sharded
    routes (the up projection, the chunk cell's and the sLSTM loop's
    ``map_local`` with a cold state made on the rank, the cell's state
    route in a prefill) where "model" divides the heads: every gradient
    leaf of the loss and a prefill's logits equal the unsharded run's bit
    for bit (the smoke xLSTM in f32, S 20: a chunk of 16 and a padded
    second)."""
    import torch.distributed as dist

    import _torch_world as tw
    from repro_torch.launch.mesh import (
        MeshSpec,
        build_device_mesh,
        init_distributed,
    )
    from repro_torch.parallel.sharding import distribute_tree

    cfg = dataclasses.replace(smoke_config("xlstm-1.3b"), dtype="float32",
                              num_layers=4)
    params = lm.init_params(cfg, 3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 21)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    runs = {}
    init_distributed("cpu", rank=0, world_size=1,
                     init_method=f"file://{tmp_path / 'rdv'}")
    try:
        mesh = build_device_mesh(MeshSpec(("data", "model"), (1, 1)), "cpu")
        for shape in ("train_4k", "prefill_32k"):
            ctx = tshapes.make_ctx(cfg, mesh, tshapes.SHAPES[shape])
            placed = distribute_tree(params, steps.param_shardings(cfg, ctx),
                                     mesh)
            for tag, p, c in (("0", params, NULL_CTX), ("1", placed, ctx)):
                if shape == "train_4k":
                    got = tw.flat(tw._grads(cfg, p, batch, c))
                else:
                    got = {"logits": steps.build_prefill(cfg, c, 40)(
                        p, {"tokens": batch["tokens"]})[0]}
                runs.update({f"{tag}/{k}": tw._np(v) for k, v in got.items()})
    finally:
        dist.destroy_process_group()
    keys = sorted(k[2:] for k in runs if k.startswith("0/"))
    assert "logits" in keys and len(keys) > 10
    assert keys == sorted(k[2:] for k in runs if k.startswith("1/"))
    for k in keys:
        np.testing.assert_array_equal(runs["1/" + k], runs["0/" + k],
                                      err_msg=k)


def test_the_sharded_loss_allocates_no_whole_global_logits():
    """On a (2, 2) fake world the cross entropy and its backward run on
    each rank's rows and vocab shard: DTensor's own gather would make a
    zero gradient of the whole global logits on every rank (F7), and a
    gather of the vocab a rank's rows at the whole vocab in f32, five
    copies of them (F10)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.layers import cross_entropy
    from repro_torch.parallel.sharding import spmd

    cfg = smoke_config("minicpm-2b")
    b, s, v = 8, 16, 512
    with dryrun.fake_world(MeshSpec(("data", "model"), (2, 2))) as dm:
        ctx = make_ctx(cfg, dm, SHAPES["train_4k"])
        logits = distribute_tensor(
            torch.empty(b, s, v, device="meta"), dm,
            ctx.sharding(("batch", "seq", "vocab_act")),
            src_data_rank=None).requires_grad_(True)
        targets = distribute_tensor(
            torch.zeros(b, s, dtype=torch.int32, device="meta"), dm,
            ctx.sharding(("batch", "seq")), src_data_rank=None)
        with dryrun.LiveBytes(block=1) as live, spmd(ctx):
            loss, _ = cross_entropy(logits, targets, 1e-4, ctx)
            torch.autograd.grad(loss, logits)
    # a rank's rows in f32 at its vocab shard, a few times over
    assert live.peak < 6 * (b // 2) * s * (v // 2) * 4


def test_the_broyden_solve_frees_its_entry_ring():
    """F11: with a carry and the guard, an unrolled solve (the dry-run's)
    scrubs the carried ring into a new one at entry, and the solve kept
    that copy for all its steps (4.8 GB of MiniCPM-2B's DEQ `train_4k`
    temp on the single pod).  On ``meta``, the solve's peak in units of the
    ring (u and v): 7.38 with the copy kept, 6.38 without."""
    from repro_torch.core import solvers

    m, b, d = 8, 2, 4096
    cfg = solvers.SolverConfig(max_steps=4, memory=m, unroll=True,
                               guard=True)
    carry = solvers.init_solve_carry(b, d, m, qn_dtype="bfloat16",
                                     device="meta")
    with dryrun.LiveBytes(block=1) as live:
        solvers.broyden_solve(lambda z: torch.tanh(z) - z,
                              torch.zeros(b, d, device="meta"), cfg,
                              carry=carry)
    assert live.peak < 7 * (2 * m * b * d * 2)
