"""The port's sharded execution, on a world of 4 gloo ranks on the CPU.

One module-scoped world (``tests/_torch_world.py``: spawned ranks, a
``file://`` rendezvous in the test's directory, one thread each, a
deadline) runs every check once on the meshes (data=2, model=2) and
(data=4, model=1); these tests hold what the ranks wrote against the
port's unsharded runs and against JAX:

  * placements: the reference's ``PartitionSpec``s for every rule table on
    (2,2), (4,1), (1,4) and (pod=2, data=2), and DTensor's shards against
    the rounded-up shards XLA pads to (``spec_local_shape``);
  * the dense and the DEQ train step at (2,2) with ZeRO-1 against the
    port's unsharded step (rtol 1e-4, f32) and against JAX's unsharded
    step at the reference's tolerances (``tests/test_sharding.py``), the
    moments split over "data" as ``zero1_spec`` says, the DEQ's ring
    batch-split and every rank's iterations and host reads the same;
  * the batched solve and the qN route at (4,1), sequence parallelism,
    greedy decode under ``DECODE_RULES`` (GQA and MLA) and the sync
    serving loop at (2,2);
  * the expert-parallel MoE at a capacity that drops tokens against the
    reference's sharded arm (a JAX subprocess on 4 forced host devices);
  * the int8 pod compression against JAX's quantizers, the elastic
    re-meshing, and a checkpoint written at (2,2) restored at (4,1).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as tw
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.parallel import sharding as jsh
from repro.runtime.ft import ElasticMeshManager as JElastic
from repro_torch.launch.mesh import MeshSpec
from repro_torch.optim import compression as tcomp
from repro_torch.parallel import sharding as tsh
from repro_torch.runtime.ft import ElasticMeshManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ["placements", "dense_step", "deq_step", "batched_solve",
          "seq_parallel", "decode", "moe_ep", "compression", "checkpoint",
          "pipeline_and_elastic"]
MOE_B, MOE_S = 4, 32


def _jax_cfg(kind):
    if kind == "dense":
        return dataclasses.replace(jax_smoke_config("minicpm-2b"),
                                   dtype="float32")
    cfg = jax_smoke_config("minicpm-2b", deq=True)
    return dataclasses.replace(cfg, dtype="float32",
                               deq=dataclasses.replace(cfg.deq,
                                                       qn_dtype="float32"))


def _jax_params(kind):
    p = jlm.init_params(_jax_cfg(kind), jax.random.PRNGKey(0))
    if kind == "deq":  # contractive blocks: the solves converge
        p["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 p["deq_blocks"])
    return jax.tree_util.tree_map(np.asarray, p)


def _tokens(vocab, batch, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=(batch, tw.S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _moe_inputs():
    cfg = dataclasses.replace(jax_smoke_config("deepseek-moe-16b"),
                              num_layers=2, dtype="float32")
    p = jlm.init_params(cfg, jax.random.PRNGKey(1))
    moe = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                 p["group1"]["moe"])
    x = np.random.default_rng(2).standard_normal(
        (MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
    return moe, x


_JAX_EP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import dataclasses
import jax
import numpy as np
from repro.configs.registry import smoke_config
from repro.configs.shapes import SHAPES, make_ctx
from repro.launch.mesh import make_test_mesh
from repro.models import moe
d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs_moe.npz"))
params = {}
for k in inp.files:
    if k.startswith("params/"):
        node = params
        parts = k[len("params/"):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inp[k]
cfg = smoke_config("deepseek-moe-16b")
cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                          moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
mesh = make_test_mesh((2, 2), ("data", "model"))
ctx = make_ctx(cfg, mesh, SHAPES["train_4k"])
with mesh:
    out, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg, ctx))(
        params, inp["x"])
np.savez(os.path.join(d, "jax_moe.npz"), out=np.asarray(out),
         aux=np.asarray(aux["moe_aux"]), z=np.asarray(aux["moe_z"]))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world"))
    for kind, batch, name in (("dense", tw.B, "dense"), ("deq", tw.B, "deq"),
                              ("deq", 8, "deq8")):
        p = _jax_params(kind)
        tok, tgt = _tokens(_jax_cfg(kind).vocab_size, batch)
        np.savez(os.path.join(d, f"inputs_{name}.npz"), tokens=tok,
                 targets=tgt, **{"params/" + k: v
                                 for k, v in tw.flat(p).items()})
    moe, x = _moe_inputs()
    np.savez(os.path.join(d, "inputs_moe.npz"), x=x,
             **{"params/" + k: v for k, v in tw.flat(moe).items()})
    jax_ep = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_EP), d], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        outcomes = tw.run_world(CHECKS, 4, d, timeout=300)
    finally:
        out, err = jax_ep.communicate(timeout=300)
    assert jax_ep.returncode == 0, err[-4000:]
    return d, outcomes


def _load(world, name):
    d, outcomes = world
    assert outcomes[name] == "ok", outcomes[name]
    with np.load(os.path.join(d, f"{name}.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, outcomes[name + ".values"]


# ---------------------------------------------------------------------------
# placements (no world)
# ---------------------------------------------------------------------------


class _FakeMesh:
    def __init__(self, names):
        self.axis_names = names


MESHES = {"2x2": ("data", "model"), "4x1": ("data", "model"),
          "1x4": ("data", "model"), "pod2xdata2": ("pod", "data")}
RULES = ["TRAIN_RULES", "TRAIN_SP_RULES", "DECODE_RULES", "PREFILL_RULES",
         "LONG_CONTEXT_RULES"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_placements_are_the_reference_partition_specs(rules, mesh):
    """Every parameter of four families under every rule table: the
    placements are the reference's PartitionSpec, mesh dim by mesh dim
    (``Shard(d)`` where entry d names the axis)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    names = MESHES[mesh]
    jr = jsh.rules_for_mesh(getattr(jsh, rules), _FakeMesh(names))
    spec_mesh = MeshSpec(names, (2, 2))
    tr = tsh.rules_for_mesh(getattr(tsh, rules), spec_mesh)
    n = 0
    for arch in ("minicpm-2b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                 "xlstm-1.3b"):
        for path, d in tw.flat(lm.model_decl(smoke_config(arch))).items():
            want = jr.spec(d.axes)
            pls = tsh.placements(tr.spec(d.axes), spec_mesh)
            for i, name in enumerate(names):
                dims = [k for k, e in enumerate(want)
                        if name in ((e,) if isinstance(e, str)
                                    else tuple(e or ()))]
                expect = Shard(dims[0]) if dims else Replicate()
                assert pls[i] == expect, (arch, path, want, pls)
            assert tsh.spec_of(pls, spec_mesh) == tuple(
                e for e in tr.spec(d.axes))[:len(tsh.spec_of(pls,
                                                             spec_mesh))]
            n += 1
    assert n > 50


def test_dtensor_shards_against_the_padded_xla_shards(world):
    """DTensor splits an uneven dim as torch.chunk (the last shard is
    smaller); XLA pads every shard to the rounded-up size.  Recorded: a
    rank's DTensor shard never exceeds the padded one, and differs from
    it exactly where the split is uneven."""
    arrays, values = _load(world, "placements")
    uneven = 0
    for rank_rows in values["rows"]:
        for shape, _spec, _mesh, local, padded in rank_rows:
            assert all(a <= b for a, b in zip(local, padded))
            if list(local) != list(padded):
                uneven += 1
    # (503, 64) over model=2: ranks at model coordinate 1 hold 251 rows,
    # XLA 252; (251, 8) on (4, 1) ...
    assert uneven >= 4


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------


def _jax_step(kind):
    cfg = _jax_cfg(kind)
    p = jax.tree_util.tree_map(jnp.asarray, _jax_params(kind))
    tc = JTrainConfig(steps=2, global_batch=tw.B, seq_len=tw.S, lr=1e-3,
                      warmup_steps=1, zero1=False)
    tok, tgt = _tokens(cfg.vocab_size, tw.B)
    carry = (jlm.deq_solve_carry(cfg, tw.B, tw.S)
             if jsteps.train_carry_enabled(cfg, tc) else None)
    state = jsteps.TrainState(jnp.zeros((), jnp.int32), p,
                              jopt.adamw_init(p), carry,
                              jnp.zeros((), jnp.int32))
    step = jax.jit(jsteps.build_train_step(cfg, tc,
                                           jsh.ShardCtx.for_mesh(None)))
    new, m = step(state, {"tokens": jnp.asarray(tok),
                          "targets": jnp.asarray(tgt)})
    return (tw.flat(jax.tree_util.tree_map(np.asarray, new.params)),
            float(m["loss"]))


@pytest.mark.parametrize("kind", ["dense", "deq"])
def test_sharded_step_matches_the_unsharded_step(world, kind):
    """Loss, gradient norm, every gradient leaf and every updated parameter
    of the (2,2) ZeRO-1 step against the port's unsharded step (f32)."""
    arrays, v = _load(world, f"{kind}_step")
    np.testing.assert_allclose(v["loss1"], v["loss0"], rtol=1e-4)
    np.testing.assert_allclose(v["gnorm1"], v["gnorm0"], rtol=1e-4)
    keys = [k[3:] for k in arrays if k.startswith("p0/")]
    assert keys
    for k in keys:
        g0 = arrays["g0/" + k]
        np.testing.assert_allclose(arrays["g1/" + k], g0, rtol=1e-4,
                                   atol=1e-4 * np.abs(g0).max(), err_msg=k)
        # Adam's first update moves every element by about lr (1e-3)
        # whatever its gradient, so an element whose gradient is near 0
        # moves by up to lr when the gradient's last bits change with the
        # summation order: the absolute floor is lr / 100 for the layer
        # stack, lr / 10 for the DEQ (whose gradients, through the solve
        # and the SHINE backward, agree to 1e-5 of each leaf's largest)
        np.testing.assert_allclose(
            arrays["p1/" + k], arrays["p0/" + k], rtol=1e-4,
            atol=1e-5 if kind == "dense" else 1e-4, err_msg=k)
    # ZeRO-1: every moment lies as zero1_spec says; some split over data
    assert v["moments_as_zero1"] == []
    assert v["moments_split_over_data"] > 0


@pytest.mark.parametrize("kind", ["dense", "deq"])
def test_sharded_step_matches_jax(world, kind):
    """Against JAX's unsharded step on the same numpy parameters, at the
    reference's own sharded-vs-unsharded tolerances."""
    arrays, v = _load(world, f"{kind}_step")
    want, loss = _jax_step(kind)
    np.testing.assert_allclose(v["loss1"], loss, rtol=2e-2)
    for k, a in want.items():
        np.testing.assert_allclose(arrays["p1/" + k], a, rtol=5e-2,
                                   atol=5e-4, err_msg=k)


def test_deq_step_ring_and_lockstep(world):
    """The carry's ring is split over "data" along its batch axis, and
    every rank took the same iterations and the same host reads (one
    collective per stop or restart test)."""
    _, v = _load(world, "deq_step")
    assert "Shard(dim=1)" in v["ring"] and v["ring_local"][1] == tw.B // 2
    assert len(set(v["reads"])) == 1 and v["reads"][0] > 0
    assert len(set(v["steps"])) == 1 and v["steps"][0] == v["steps0"]


def test_batched_solve_and_qn_route(world):
    a, v = _load(world, "batched_solve")
    np.testing.assert_allclose(a["z"][:5], a["z_star"][:5], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(a["z"][5:], 0.0)   # frozen rows untouched
    assert v["converged"] and v["n_steps"] < 40      # the early exit fired
    # rows (on different ranks) stopped at different iterations, frozen
    # rows never moved, and every rank made the same reads: the stop test
    # and the guard's restart test an iteration, the last stop test
    assert len(set(a["rows_steps"][:5].tolist())) > 1
    assert (a["rows_steps"][5:] == 0).all()
    assert len(set(v["reads"])) == 1
    assert v["reads"][0] == 2 * v["n_steps"] + 1
    assert "Shard(dim=1)" in v["ring"] and v["ring_local"][1] == 2
    np.testing.assert_allclose(a["qn_got"], a["qn_want"], rtol=1e-5,
                               atol=1e-5)
    assert "Shard(dim=1)" in v["qn_placements"]
    # broyden_step's route: new ring, H g, H^T s, denominators, evictions
    for i in range(7):
        np.testing.assert_allclose(a[f"broyden_got{i}"],
                                   a[f"broyden_want{i}"], rtol=1e-5,
                                   atol=1e-5, err_msg=str(i))


def test_sequence_parallel_matches_baseline(world):
    a, _ = _load(world, "seq_parallel")
    np.testing.assert_allclose(a["out1"], a["out0"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["internlm2-20b", "deepseek-v2-lite-16b"])
def test_decode_rules_give_the_unsharded_greedy_tokens(world, arch):
    a, v = _load(world, "decode")
    np.testing.assert_array_equal(a[f"{arch}/tokens1"], a[f"{arch}/tokens0"])
    np.testing.assert_allclose(a[f"{arch}/logits1"], a[f"{arch}/logits0"],
                               rtol=1e-4, atol=1e-5)
    # the cache: (layers, B, T, ...) with the length over "model"
    assert v[f"{arch}/cache"] == "(Shard(dim=1), Shard(dim=2))"


def test_serve_loop_on_the_mesh(world):
    a, v = _load(world, "decode")
    np.testing.assert_array_equal(a["serve1"], a["serve0"])
    assert all(r == v["serve_all_ranks"][0] for r in v["serve_all_ranks"])


def test_moe_expert_parallel_matches_the_reference_sharded_arm(world):
    a, _ = _load(world, "moe_ep")
    d, _ = world
    with np.load(os.path.join(d, "jax_moe.npz")) as f:
        ref = {k: f[k] for k in f.files}
    np.testing.assert_allclose(a["out"], ref["out"], rtol=1e-4, atol=1e-5)
    # aux and z: the mean over the expert axis of each DP shard's value, as
    # the reference's pmean.  The reference's P() out spec (replication not
    # checked) hands back the first device's value, data shard 0's; the
    # port also averages over the DP axes, the value every rank agrees on
    for key in ("aux", "z"):
        shards = a[f"{key}_shards"]          # ranks (data, model) row-major
        np.testing.assert_allclose(shards[0], ref[key], rtol=1e-5)
        np.testing.assert_allclose(shards[[0, 2]].mean(), a[key], rtol=1e-6)
        assert shards[0] == shards[1] and shards[2] == shards[3]
    # the capacity drops tokens: the sharded arm is not the unsharded one
    assert np.abs(a["out"] - a["out_whole"]).max() > 1e-3


# ---------------------------------------------------------------------------
# compression, elastic re-meshing, checkpoints, data
# ---------------------------------------------------------------------------


def test_quantizers_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-2, 1e3):
        x = (rng.standard_normal(1000) * scale).astype(np.float32)
        x[:6] = [0.5, 1.5, -2.5, 0.0, 127.0, -127.0]  # ties round to even
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(tq, ts, x.shape).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js, x.shape)))


def test_compression_single_pod_is_the_identity():
    grads = {"w": torch.arange(8.0)}
    st = tcomp.compression_init(grads)
    out, st2 = tcomp.compress_pod_gradients(grads, st, None)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))
    np.testing.assert_array_equal(st2.error["w"].numpy(), 0.0)


def test_compression_two_pods_closed_form(world):
    """At pod=2: the reduced gradient is the mean of the pods' dequantized
    (gradient + error) and the new error what each pod did not send, in
    JAX's quantizers; twice, the second step with the first's error."""
    _, v = _load(world, "compression")
    rows = {r["pod"]: r for r in v["rows"]}
    for key in ("w", "b"):
        g = {p: np.asarray(rows[p][f"g/{key}"], np.float32) for p in (0, 1)}
        err = {p: np.zeros_like(g[p]) for p in (0, 1)}
        for step in ("1", "2"):
            deq, new_err = {}, {}
            for p in (0, 1):
                gf = g[p] + err[p]
                q, s = jcomp.quantize_int8(jnp.asarray(gf))
                deq[p] = np.asarray(jcomp.dequantize_int8(q, s, gf.shape))
                new_err[p] = gf - deq[p]
            want = (deq[0] + deq[1]) / 2
            for r in v["rows"]:
                p = r["pod"]
                np.testing.assert_allclose(r[f"r{step}/{key}"], want,
                                           rtol=1e-6, atol=1e-9)
                np.testing.assert_allclose(r[f"e{step}/{key}"], new_err[p],
                                           rtol=1e-6, atol=1e-9)
            err = new_err


def test_choose_shape_matches_the_reference():
    for tp in (1, 2, 4, 8, 16):
        t, j = ElasticMeshManager(tp), JElastic(tp)
        for n in range(1, 601):
            assert t.choose_shape(n) == j.choose_shape(n), (tp, n)


def test_elastic_build_and_pipeline_rows(world):
    _, v = _load(world, "pipeline_and_elastic")
    assert v["elastic"] == [[2, 2], [2, 2]]
    # 3 ranks left at tp 2: tp halves to 1, DP the largest power of two,
    # (2, 1) over ranks 0-1; ranks 2-3 stand by
    assert v["elastic3"] == [[2, 1], [True, True, False, False]]
    # a solve on the re-mesh stops over its own ranks' group
    assert v["elastic3_solved"] == [True, True, None, None]
    assert v["pipeline_same"] and v["rows"] == [[2, tw.S]] * 4


def test_checkpoint_written_at_2x2_restores_at_4x1(world):
    a, v = _load(world, "checkpoint")
    assert v["warm"]
    np.testing.assert_array_equal(a["age1"], a["age0"])
    np.testing.assert_array_equal(a["z1"], a["z0"])
    np.testing.assert_array_equal(a["u1"], a["u0"])
    assert "Shard(dim=1)" in v["ring"] and v["ring_local"][1] == 2
    np.testing.assert_array_equal(a["age2"], a["age0"] + 1)


def test_trainer_checks_the_dp_divisibility():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.trainer import Trainer
    ctx = tsh.ShardCtx.for_mesh(MeshSpec(("data", "model"), (4, 1)))
    with pytest.raises(ValueError, match="not divisible by the "
                                         "data-parallel mesh extent 4"):
        Trainer(tw.dense_cfg(), TrainConfig(global_batch=6), ctx=ctx)


def test_decode_partials_combine_to_the_whole_cache():
    """The cross-rank decode's plain version: partials of slices (one with
    no valid key) merged equal the decode over the whole cache."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    b, h, kv, hd, t = 3, 4, 2, 16, 24
    q = torch.randn((b, h, hd), generator=g)
    k = torch.randn((b, t, kv, hd), generator=g)
    v = torch.randn((b, t, kv, hd), generator=g)
    lens = torch.tensor([5, 13, 24])
    want = ref.decode_attention_ref(q, k, v, lens)
    parts = [ref.decode_partials_ref(q, k[:, a:a + 8], v[:, a:a + 8],
                                     torch.clamp(lens - a, 0, 8))
             for a in (0, 8, 16)]
    assert (parts[2][0, :, 0, 1] == 0).all()   # row 0 has no key there
    got = ref.decode_combine_ref(torch.cat(parts, dim=2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_chip_smoke_four_card_world_on_the_cpu():
    """``chip_smoke.sharded_four_cards``'s plumbing (spawned ranks, the
    (2,2) DEQ step against rank 0's unsharded one, the drain, V2-Lite's
    expert-parallel prefill with its drop count) on four gloo ranks at the
    smoke configs, before a four-card host runs it over NCCL."""
    sys.path.insert(0, REPO)
    import chip_smoke
    res = chip_smoke.sharded_four_cards("cpu", device="cpu")
    assert res["drain"]["same_tokens"]
    for tag in ("f32_4_layers", "full"):
        v2 = res[f"v2_lite_prefill_{tag}"]
        assert v2["dropped_pairs"] == 0 and v2["excess"] <= 0, tag
        assert v2["held"], tag
    assert res["train"]["excess"] <= 0
    assert res["train"]["deq_steps"] == res["train"]["deq_steps1"]
    # f32 on the CPU: the moments agree far inside the card's bound (the
    # solve stops at its tolerance on each arm: 1.7e-4 read)
    assert res["train"]["first_moments"]["rel_l2"] <= 1e-3


def _moments(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(7, 5, generator=g),
            "unit": {"w": torch.randn(3, 4, 4, generator=g) * 1e-3}}


@pytest.mark.parametrize("fault", ["none", "missing_leaf", "wrong_scale",
                                   "one_element"])
def test_chip_smoke_moment_check(fault):
    """``chip_smoke._moment_diff``: equal moments pass at rtol 1e-4; a
    leaf whose update had no gradient (zeros), a gradient 10% off, or one
    element changed, fail it, each leaf at its own scale."""
    sys.path.insert(0, REPO)
    import chip_smoke
    want = _moments()
    got = _moments()
    if fault == "missing_leaf":
        got["unit"]["w"] = torch.zeros_like(got["unit"]["w"])
    elif fault == "wrong_scale":
        got["unit"]["w"] = got["unit"]["w"] * 1.1
    elif fault == "one_element":
        got["embed"][3, 2] += 1e-2
    d = chip_smoke._moment_diff(got, want, 1e-4, 1e-4)
    assert d["leaves"] == 2
    if fault == "none":
        assert d["differing"] == 0 and d["excess"] <= 0 and d["rel_l2"] == 0
    else:
        assert d["differing"] > 0 and d["excess"] > 0 and d["rel_l2"] > 1e-3


@pytest.mark.parametrize("case,held", [
    (dict(dropped=0, exc=-0.01, err=0.02, floor=0.0, floor_mult=None), True),
    (dict(dropped=0, exc=0.01, err=0.05, floor=0.03, floor_mult=None), False),
    (dict(dropped=0, exc=0.01, err=0.05, floor=0.03, floor_mult=2.0), True),
    (dict(dropped=0, exc=0.01, err=0.07, floor=0.03, floor_mult=2.0), False),
    (dict(dropped=3, exc=-0.01, err=0.02, floor=0.03, floor_mult=2.0),
     False)])
def test_chip_smoke_ep_prefill_hold(case, held):
    """The four-card EP prefill check: within the reference's tolerance, or
    (bf16 at full depth, both arms against an f32 prefill over the same
    weights) the sharded arm's error within a stated multiple of the
    unsharded arm's, and never with a dropped pair."""
    sys.path.insert(0, REPO)
    import chip_smoke
    assert chip_smoke.ep_prefill_held(**case) is held


@pytest.mark.parametrize("mesh,ranks", [("single", 256), ("multi", 512)])
def test_train_launcher_mesh_needs_the_production_ranks(monkeypatch, mesh,
                                                        ranks):
    """``--mesh single|multi`` builds the production mesh over the process
    world and raises with fewer ranks, as the reference raises with fewer
    devices (here a world of one, on gloo)."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import train
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    try:
        with pytest.raises(RuntimeError, match=f"needs {ranks} ranks, the "
                                               "world has 1"):
            train.main(["--smoke", "--device", "cpu", "--mesh", mesh,
                        "--steps", "1"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
