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
  * the serving loop at (2,2) in both pipelines with both prefix caches
    (async, async with the device store, sync with the host index)
    against the port's and JAX's unsharded drains of the same arm; the
    async schedule with entries held unready on two ranks only; a decode
    tick that gathers no leaf of the batch-split carry; the launcher
    under ``torchrun`` against the run without a mesh;
  * gradient accumulation at (2,2) (dense, DEQ) and at (4,1) with
    microbatches that do not divide over the data ranks, against the
    port's and JAX's unsharded accumulation steps;
  * the expert-parallel MoE at a capacity that drops tokens against the
    reference's sharded arm (a JAX subprocess on 4 forced host devices);
  * the int8 pod compression against JAX's quantizers, the elastic
    re-meshing, and a checkpoint written at (2,2) restored at (4,1);
  * the dry-run's smoke cells (a train step, with and without the DEQ, a
    prefill, a decode step) at (2,2): a fake world of 4 ranks in this
    process issues the gloo world's collectives, kind, bytes and group
    for each, and rank 0's peak of allocated bytes equals the real local
    shards' (``LiveBytes``);
  * query heads that do not divide "model" (3 over 2, as MiniCPM-2B's 36
    over 16): the train step, prefill and decode at (2,2) against the
    unsharded runs; a decode cache split along its length over both mesh
    dims; Zamba2's SSD and xLSTM's mLSTM cell on each rank's local rows
    and heads (gradients and prefill logits against the unsharded runs);
  * mLSTM heads that do not divide "model" (3 over 2, and 1 over 2, where
    a rank holds only a pad head), padded and split as GSPMD splits them:
    gradients and prefill logits against the unsharded runs, every rank
    issuing the same collectives.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import threading

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
          "pipeline_and_elastic", "serve_arms", "tick_gathers",
          "accum_dense", "accum_deq", "accum_uneven", "dryrun_cells",
          "uneven_heads", "decode_split_twice", "ssm_families",
          "vocab_parallel_loss", "uneven_ssm_heads", "pad_only_ssm_heads"]
MOE_B, MOE_S = 4, 32


def _jax_cfg(kind):
    if kind == "untied":
        return dataclasses.replace(jax_smoke_config("stablelm-3b"),
                                   dtype="float32")
    if kind == "dense":
        return dataclasses.replace(jax_smoke_config("minicpm-2b"),
                                   dtype="float32")
    cfg = jax_smoke_config("minicpm-2b", deq=True)
    return dataclasses.replace(cfg, dtype="float32",
                               deq=dataclasses.replace(cfg.deq,
                                                       qn_dtype="float32"))


def _jax_params(kind):
    if kind.startswith("xlstm"):
        return jax.tree_util.tree_map(np.asarray, jlm.init_params(
            _jax_xlstm3_cfg(int(kind[5:])), jax.random.PRNGKey(4)))
    p = jlm.init_params(_jax_cfg(kind), jax.random.PRNGKey(0))
    if kind == "deq":  # contractive blocks: the solves converge
        p["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 p["deq_blocks"])
    return jax.tree_util.tree_map(np.asarray, p)


def _jax_xlstm3_cfg(heads: int = 3):
    """``tw.xlstm3_cfg`` in the JAX package."""
    return dataclasses.replace(jax_smoke_config("xlstm-1.3b"),
                               dtype="float32", d_model=96, num_heads=heads,
                               num_kv_heads=heads, num_layers=4)


def _tokens(vocab, batch, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=(batch, tw.S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _untied_batch():
    """The untied config's batch: a row with its last targets ignored."""
    tok, tgt = _tokens(_jax_cfg("untied").vocab_size, tw.B, seed=3)
    tgt[1, -4:] = -1
    return tok, tgt


# the padded vocab of the smoke configs: 256 columns a "model" rank at (2, 2)
VPLOSS_V = 512


def _vploss_inputs():
    """Logits ``(B, S, VPLOSS_V)`` and targets with ``-1``s and, in rows of
    both "data" ranks, the first and last column of both vocab shards."""
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((tw.B, tw.S, VPLOSS_V))).astype(
        np.float32)
    tgt = rng.integers(0, VPLOSS_V, size=(tw.B, tw.S)).astype(np.int32)
    half = VPLOSS_V // 2
    for row in (0, tw.B // 2):
        tgt[row, :4] = [0, half - 1, half, VPLOSS_V - 1]
    tgt[1, 5:8] = -1
    tgt[tw.B - 1, 0] = -1
    return logits, tgt


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
                              ("deq", 8, "deq8"), ("dense", 8, "dense8")):
        p = _jax_params(kind)
        tok, tgt = _tokens(_jax_cfg(kind).vocab_size, batch)
        np.savez(os.path.join(d, f"inputs_{name}.npz"), tokens=tok,
                 targets=tgt, **{"params/" + k: v
                                 for k, v in tw.flat(p).items()})
    tok, tgt = _untied_batch()
    np.savez(os.path.join(d, "inputs_untied.npz"), tokens=tok, targets=tgt,
             **{"params/" + k: v
                for k, v in tw.flat(_jax_params("untied")).items()})
    toks = np.random.default_rng(6).integers(
        0, _jax_xlstm3_cfg().vocab_size,
        size=(tw.B, tw.XLSTM3_S + 1)).astype(np.int32)
    for name in ("xlstm3", "xlstm1"):
        np.savez(os.path.join(d, f"inputs_{name}.npz"), tokens=toks[:, :-1],
                 targets=toks[:, 1:],
                 **{"params/" + k: v
                    for k, v in tw.flat(_jax_params(name)).items()})
    logits, tgt = _vploss_inputs()
    np.savez(os.path.join(d, "inputs_vploss.npz"), logits=logits,
             targets=tgt)
    moe, x = _moe_inputs()
    np.savez(os.path.join(d, "inputs_moe.npz"), x=x,
             **{"params/" + k: v for k, v in tw.flat(moe).items()})
    jax_ep = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_EP), d], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    launches = _start_launcher_runs(d)
    # the world runs in its own processes; meanwhile this process computes
    # JAX's sides of the serving and accumulation checks
    box: dict = {}
    side: dict = {}

    def run():
        try:
            box["outcomes"] = tw.run_world(CHECKS, 4, d, timeout=300)
        except BaseException as e:  # noqa: BLE001 -- raised below
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        side["serve"] = _jax_serve_drains()
        side["accum"] = {c: _jax_accum_step(*ACCUM[c]) for c in ACCUM}
    finally:
        th.join()
        out, err = jax_ep.communicate(timeout=300)
        side["launcher"] = _finish_launcher_runs(launches)
    if "error" in box:
        raise box["error"]
    assert jax_ep.returncode == 0, err[-4000:]
    # the world's directory, its outcomes, and JAX's and the launcher's runs
    return d, box["outcomes"], side


def _load(world, name):
    d, outcomes, _ = world
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


# ---------------------------------------------------------------------------
# serving on the mesh: the async pipeline and the prefix caches
# ---------------------------------------------------------------------------


def _jax_serve_drains() -> dict:
    """JAX's unsharded drain of each arm of ``tw.SERVE_ARMS`` over
    ``tw.serve_prompts`` (the DEQ config and parameters of the world's
    ``deq`` inputs)."""
    from repro.runtime.serving import Request as JRequest
    from repro.runtime.serving import ServeLoop as JServeLoop
    cfg = _jax_cfg("deq")
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params("deq"))
    out = {}
    for arm, kw in tw.SERVE_ARMS.items():
        loop = JServeLoop(params, cfg, jsh.ShardCtx.for_mesh(None),
                          **tw.SERVE_KW, **kw)
        reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=tw.SERVE_NEW)
                for i, p in enumerate(tw.serve_prompts(cfg.vocab_size))]
        loop.drain(reqs)
        cache = loop.prefix if loop.prefix is not None else \
            loop.prefix_store
        out[arm] = {"tokens": [r.out for r in reqs],
                    "hits": cache.stats()["hits"] if cache else 0,
                    "prefill_calls": loop.prefill_calls,
                    "steps": {str(k): [float(x) for x in v]
                              for k, v in loop.recorded_steps.items()}}
    return out


@pytest.mark.parametrize("arm", sorted(tw.SERVE_ARMS))
def test_serve_arm_on_the_mesh_matches_unsharded_and_jax(world, arm):
    """At (2,2), with the DEQ carry batch-split between ticks: the port's
    unsharded drain of the same arm bit for bit (tokens, prefix hits and
    lookups, prefill iterations and calls, every request's step
    sequence), the same tokens on every rank, nothing left in flight, the
    same collectives on every rank; and JAX's unsharded drain's tokens,
    hits and step sequences."""
    _, v = _load(world, "serve_arms")
    got, want = v[arm]["sharded"], v[arm]["unsharded"]
    assert got == want
    assert all(t == got["tokens"] for t in v[arm]["all_ranks"])
    assert all(len(t) == tw.SERVE_NEW for t in got["tokens"])
    assert got["errors"] == [None] * len(got["tokens"])
    assert got["inflight"] == 0
    assert all(c == v[arm]["comms"][0] for c in v[arm]["comms"])
    j = world[2]["serve"][arm]
    assert got["tokens"] == j["tokens"]
    assert got["hits"] == j["hits"]
    assert got["prefill_calls"] == j["prefill_calls"]
    if arm != "async":   # the prefix arms record their prefill steps too
        assert got["hits"] >= 2 and got["prefill_iters"] > 0
    assert got["steps"] == j["steps"]


@pytest.mark.parametrize("arm", sorted(tw.STALE_ARMS))
def test_serve_stale_reset_on_the_mesh(world, arm):
    """The carry staleness bound (``carry_max_age`` 1) at (2,2) in each
    pipeline: the stale reset on the batch-split carry evicts what the
    unsharded loop evicts, and the tokens and step sequences stay its."""
    _, v = _load(world, "serve_arms")
    got, want = v[arm]["sharded"], v[arm]["unsharded"]
    assert got == want
    assert got["evictions"]["stale"] > 0
    assert all(t == got["tokens"] for t in v[arm]["all_ranks"])


def test_serve_schedule_ignores_a_rank_s_readiness(world):
    """The async store arm with every entry held unready for a few polls
    on ranks 1 and 3 only: the same tokens, hits and step sequences as
    without the skew, on every rank, and the same collectives on every
    rank as the unskewed drain issued (a rank that landed what it alone
    saw ready would have admitted a wave by itself and hung the world)."""
    _, v = _load(world, "serve_arms")
    sk, ref = v["skew"], v["async_store"]
    assert sk["sharded"] == ref["sharded"]
    assert all(t == ref["sharded"]["tokens"] for t in sk["all_ranks"])
    assert sk["comms"] == ref["comms"]
    held = sk["held_polls"]
    assert held[0] == held[2] == 0 and held[1] > 0 and held[3] > 0


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_decode_tick_gathers_no_carry_leaf(world, pipeline):
    """A decode tick at (2,2) gathers the logits and the statuses, and no
    leaf of the batch-split carry: no gathered input of the iterate's or
    the ring's local shape, no bool row vector (``warm``), and one int32
    row vector (the statuses; ``count`` and ``age`` stay split)."""
    _, v = _load(world, "tick_gathers")
    t = v[pipeline]
    assert "Shard(dim=1)" in t["placements"]
    shapes = [(g[1], g[2]) for g in t["gathers"]]
    assert shapes
    for leaf in ("z", "u"):
        assert tuple(t["carry_local"][leaf]) not in [
            (list(s), d) for s, d in shapes], leaf
    row, idt = t["carry_local"]["count"]
    assert shapes.count((row, idt)) == 1
    assert (t["carry_local"]["warm"][0], "torch.bool") not in shapes


# ---------------------------------------------------------------------------
# gradient accumulation on the mesh
# ---------------------------------------------------------------------------


def _jax_accum_step(kind, batch, k):
    cfg = _jax_cfg(kind)
    p = jax.tree_util.tree_map(jnp.asarray, _jax_params(kind))
    tc = JTrainConfig(steps=2, global_batch=batch, seq_len=tw.S, lr=1e-3,
                      warmup_steps=1, zero1=False, grad_accum=k)
    tok, tgt = _tokens(cfg.vocab_size, batch)
    state = jsteps.TrainState(jnp.zeros((), jnp.int32), p,
                              jopt.adamw_init(p), None,
                              jnp.zeros((), jnp.int32))
    step = jax.jit(jsteps.build_train_step(cfg, tc,
                                           jsh.ShardCtx.for_mesh(None)))
    new, m = step(state, {"tokens": jnp.asarray(tok),
                          "targets": jnp.asarray(tgt)})
    return (tw.flat(jax.tree_util.tree_map(np.asarray, new.params)),
            float(m["loss"]))


ACCUM = {"accum_dense": ("dense", tw.B, 2), "accum_deq": ("deq", 8, 2),
         "accum_uneven": ("dense", 8, 4)}


@pytest.mark.parametrize("check", sorted(ACCUM))
def test_grad_accum_on_the_mesh_matches_the_unsharded_step(world, check):
    """``grad_accum`` k at (2,2) (dense, 4 rows; the DEQ, 8 rows) and at
    (4,1) with microbatches of 2 rows over 4 data ranks: loss, gradient
    norm, every updated parameter and first moment against the port's
    unsharded accumulation step (rtol 1e-4, f32); the moments in their
    ZeRO-1 layout, no carry."""
    a, v = _load(world, check)
    kind = ACCUM[check][0]
    np.testing.assert_allclose(v["loss1"], v["loss0"], rtol=1e-4)
    np.testing.assert_allclose(v["gnorm1"], v["gnorm0"], rtol=1e-4)
    assert not v["carry"] and "Shard" in v["mu_placements"]
    keys = [k[3:] for k in a if k.startswith("p0/")]
    assert keys
    for k in keys:
        mu0 = a["mu0/" + k]
        np.testing.assert_allclose(a["mu1/" + k], mu0, rtol=1e-4,
                                   atol=1e-4 * np.abs(mu0).max(), err_msg=k)
        # as in test_sharded_step_matches_the_unsharded_step: Adam's first
        # update moves a near-zero gradient's element by up to lr
        np.testing.assert_allclose(
            a["p1/" + k], a["p0/" + k], rtol=1e-4,
            atol=1e-5 if kind == "dense" else 1e-4, err_msg=k)


@pytest.mark.parametrize("check", sorted(ACCUM))
def test_grad_accum_on_the_mesh_matches_jax(world, check):
    """Against JAX's unsharded ``build_train_step`` with the same
    ``grad_accum`` on the same numpy parameters and batch, at the
    reference's sharded-vs-unsharded tolerances."""
    a, v = _load(world, check)
    want, loss = world[2]["accum"][check]
    np.testing.assert_allclose(v["loss1"], loss, rtol=2e-2)
    for k, x in want.items():
        np.testing.assert_allclose(a["p1/" + k], x, rtol=5e-2, atol=5e-4,
                                   err_msg=k)


LAUNCH_ARGS = ["--smoke", "--deq", "--device", "cpu", "--prefix-cache",
               "--shared-prefix", "8", "--requests", "4", "--slots", "2",
               "--max-new-tokens", "4", "--dtype", "float32", "--qn-dtype",
               "float32"]


def _start_launcher_runs(d: str) -> dict:
    """The serve launcher under ``torchrun`` at 2x2 and without a mesh,
    started beside the world (output into ``d``)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmds = {"mesh": [sys.executable, "-m", "torch.distributed.run",
                     "--nproc-per-node", "4", "--master-port", str(port),
                     "-m", "repro_torch.launch.serve", "--mesh", "2x2",
                     *LAUNCH_ARGS],
            "one": [sys.executable, "-m", "repro_torch.launch.serve",
                    *LAUNCH_ARGS]}
    out = {}
    for name, cmd in cmds.items():
        files = [open(os.path.join(d, f"launch_{name}.{x}"), "w")
                 for x in ("out", "err")]
        out[name] = (subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=files[0], stderr=files[1]),
                     files)
    return out


def _finish_launcher_runs(runs: dict) -> dict:
    res = {}
    for name, (proc, files) in runs.items():
        try:
            rc = proc.wait(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        for f in files:
            f.close()
        with open(files[0].name) as fo, open(files[1].name) as fe:
            res[name] = (rc, fo.read(), fe.read())
    return res


def test_serve_launcher_on_the_mesh_gives_the_unsharded_tokens(world):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh
    2x2 --smoke --deq --device cpu --prefix-cache`` with the default
    (async) pipeline prints the requests of the run without ``--mesh``
    (both in f32: in bf16 a near tie of two logits may part them); the
    two runs go beside the world."""
    lines = {}
    runs = world[2]["launcher"]
    for name, (rc, out, err) in runs.items():
        assert rc == 0, (name, err[-4000:])
        lines[name] = [ln for ln in out.splitlines()
                       if ln.startswith(("  req ", "prefix cache:"))]
    assert len(lines["one"]) == 5 and lines["mesh"] == lines["one"]
    out = runs["mesh"][1]
    assert "async pipeline: 0 blocking host syncs" in out
    assert "mesh {'data': 2, 'model': 2} over gloo" in out


def test_moe_expert_parallel_matches_the_reference_sharded_arm(world):
    a, _ = _load(world, "moe_ep")
    d = world[0]
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
    (2,2) DEQ step alone and with two microbatches against rank 0's
    unsharded ones, the sync drain, the async drain with the device prefix
    store, V2-Lite's
    expert-parallel prefill with its drop count) on four gloo ranks at the
    smoke configs, before a four-card host runs it over NCCL; the DEQ
    step's collectives held against the dry-run's count of the same step
    on a fake (2,2) world, kind, count and link bytes."""
    sys.path.insert(0, REPO)
    import chip_smoke
    expect = chip_smoke.sharded_step_counts(["2x2_cpu"])["2x2_cpu"]
    res = chip_smoke.sharded_four_cards("cpu", device="cpu", expect=expect)
    assert res["train"]["issued"] == chip_smoke.expected_issued(
        expect, int(res["train"]["deq_steps"]), 4)
    assert res["train"]["issued"]["all-reduce"][0] > 0
    assert res["drain"]["same_tokens"]
    # the async pipeline with the device store: the unsharded drain's
    # tokens, hits and prefill steps; every request served
    st = res["drain_async_store"]
    assert st["same_tokens"] and not st["errors"]
    assert st["hits"] == st["hits_unsharded"] >= 4
    assert st["prefill_steps"] == st["prefill_steps_unsharded"]
    acc = res["train_accum"]
    assert acc["grad_accum"] == 2 and "fail" not in acc
    assert acc["excess"] <= 0 and acc["first_moments"]["rel_l2"] <= 1e-3
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


def _arm(**kw) -> dict:
    class _Loop:
        solve_log = [{"phase": "prefill", "steps": 3.0},
                     {"phase": "decode", "steps": 1.0}]
    a = dict(loop=_Loop(), tokens=[[5, 6], [7, 8]], errors=[None, None],
             hits=1, prefill_steps=[3.0], prefill_iters=3.0, saved_iters=0.0,
             steps={"0": [3.0, 1.0]},
             # the solver's reads (2 an iteration + the stop) and the clock
             syncs=["implicit"] * (7 + 3 + 1))
    a.update(kw)
    return a


@pytest.mark.parametrize("fault", ["none", "token", "hits", "prefill_steps",
                                   "extra_wait", "short", "error"])
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_chip_smoke_mesh_arm_check(monkeypatch, fault, pipeline):
    """``chip_smoke.check_mesh_arm`` on canned arms: equal arms pass; one
    changed token, hit or prefill step count, a missing token or an error
    fails it, and in an async arm one more host wait than the solver's
    reads and the clock."""
    sys.path.insert(0, REPO)
    import chip_smoke
    monkeypatch.setitem(chip_smoke.SHARDED_PREFIX, "new", 2)
    want = _arm()
    got = {"none": _arm(), "token": _arm(tokens=[[5, 6], [7, 9]]),
           "hits": _arm(hits=2), "prefill_steps": _arm(prefill_steps=[4.0]),
           "extra_wait": _arm(syncs=["implicit"] * 12),
           "short": _arm(tokens=[[5], [7, 8]]),
           "error": _arm(errors=[None, "DIVERGED"])}[fault]
    fails = fault != "none" and not (fault == "extra_wait"
                                      and pipeline == "sync")
    if fails:
        with pytest.raises(AssertionError):
            chip_smoke.check_mesh_arm("arm", got, want, pipeline, 12)
    else:
        chip_smoke.check_mesh_arm("arm", got, want, pipeline, 12)


# ---------------------------------------------------------------------------
# the dry-run's fake world against the gloo world; uneven query heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,deq", tw.DRYRUN_CELLS)
def test_dryrun_fake_world_equals_the_gloo_world(world, kind, deq):
    """The dry-run's cell on a fake (2,2) world of ``meta`` shards against
    the same cell on the gloo world's real tensors: every collective
    issued (kind, result bytes, group size, in order), the accounting of
    their link bytes and rank 0's peak of allocated bytes."""
    import torch.distributed as dist

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import dryrun

    _, v = _load(world, "dryrun_cells")
    tag = f"{kind}{'_deq' if deq else ''}"
    cfg = dataclasses.replace(smoke_config("minicpm-2b", deq=deq),
                              dtype="float32")
    assert not dist.is_initialized()
    with dryrun.fake_world(MeshSpec(("data", "model"), (2, 2))) as mesh:
        peak, records = tw.dryrun_cell(cfg, kind, mesh)
    want = [tuple(r) for r in v[tag + "_records"]]
    assert records == want
    assert dryrun.collective_bytes(records) == dryrun.collective_bytes(want)
    assert {r[0] for r in records} >= {"all-reduce", "all-gather"}
    assert peak == v[tag + "_peak"] > 0


def test_uneven_query_heads_match_the_unsharded_runs(world):
    """F5: with query heads that do not divide "model" the view of the
    head-split projection raised (DTensor cannot unflatten an uneven
    split); the projection is now gathered whole before the view.  The
    (2,2) train step's loss, gradient norm and gradients, the prefill's and
    the decode step's logits against the unsharded ones."""
    arrays, v = _load(world, "uneven_heads")
    np.testing.assert_allclose(v["loss1"], v["loss0"], rtol=1e-5)
    np.testing.assert_allclose(v["gnorm1"], v["gnorm0"], rtol=1e-4)
    keys = [k[3:] for k in arrays if k.startswith("g0/")]
    assert keys
    for k in keys:
        g0 = arrays["g0/" + k]
        np.testing.assert_allclose(arrays["g1/" + k], g0, rtol=1e-4,
                                   atol=1e-4 * np.abs(g0).max(), err_msg=k)
    for name in ("prefill", "decode"):
        np.testing.assert_allclose(arrays[name + "1"], arrays[name + "0"],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert v["train_comms"]["all_gather_into_tensor"] > 0


def test_decode_over_a_length_split_over_two_mesh_dims(world):
    """The sharded decode gathers each slice's partials over every mesh dim
    that splits the cache's length (it refused more than one: the dry-run's
    long-context cells on the two-pod mesh split it over "pod" and
    "data")."""
    arrays, _ = _load(world, "decode_split_twice")
    np.testing.assert_allclose(arrays["got"], arrays["want"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_local_ssm_cells_match_the_unsharded_runs(world, arch):
    """The chunked SSD and mLSTM cell run on each rank's rows and heads
    (``sharding.map_local``: DTensor's batched matmul over a split batch
    and split heads, and a cumsum's backward, fail to plan on PyTorch
    2.11): every gradient leaf of a (2,2) train step's loss and the
    prefill's logits against the unsharded runs (f32)."""
    arrays, _ = _load(world, "ssm_families")
    keys = [k.split("/g0/")[1] for k in arrays
            if k.startswith(f"{arch}/g0/")]
    assert keys
    for k in keys:
        g0 = arrays[f"{arch}/g0/{k}"]
        np.testing.assert_allclose(arrays[f"{arch}/g1/{k}"], g0, rtol=1e-4,
                                   atol=1e-4 * np.abs(g0).max(), err_msg=k)
    np.testing.assert_allclose(arrays[f"{arch}/prefill1"],
                               arrays[f"{arch}/prefill0"], rtol=1e-4,
                               atol=1e-5)


def test_uneven_ssm_heads_are_padded_and_split(world):
    """F12: where "model" does not divide the mLSTM heads (xLSTM-1.3B's 4
    over 16), every rank ran every head (the view gathered them whole),
    4x the reference's share of the chunk loop.  The heads are now padded
    to a multiple of "model" and split, as GSPMD splits them.  At (2, 2)
    with 3 heads each rank's cell holds ``ceil(3 / 2) = 2`` (the unsharded
    run 3), every gradient that reached a cell's inputs is finite (pad
    heads included), and every gradient leaf of the train step's loss and
    the prefill's logits (through the cell's state route) agree with the
    unsharded port and with JAX at rtol 1e-5 (f32)."""
    from repro.parallel.sharding import ShardCtx as JShardCtx

    arrays, v = _load(world, "uneven_ssm_heads")
    assert set(v["train_heads1"]) == set(v["prefill_heads1"]) == {2}
    assert set(v["train_heads0"]) == set(v["prefill_heads0"]) == {3}
    assert v["finite"] == [True] * 4
    inp = np.load(os.path.join(world[0], "inputs_xlstm3.npz"))
    jcfg, jctx = _jax_xlstm3_cfg(), JShardCtx.for_mesh(None)
    jp = tw.unflat(dict(inp), "params/")
    jb = {"tokens": jnp.asarray(inp["tokens"]),
          "targets": jnp.asarray(inp["targets"])}
    gj = tw.flat(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda p: jlm.loss_fn(p, jb, jcfg, jctx)[0]))(jp)))
    assert sorted(gj) == sorted(k[3:] for k in arrays if k.startswith("g0/"))
    for k, want in gj.items():
        for got in (arrays["g1/" + k], arrays["g0/" + k]):
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
        np.testing.assert_allclose(arrays["g1/" + k], arrays["g0/" + k],
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    jl = np.asarray(jax.jit(lambda p, t: jlm.prefill(
        p, {"tokens": t}, jcfg, jctx, 40))(jp, jb["tokens"])[0])
    for got in (arrays["prefill1"], arrays["prefill0"]):
        np.testing.assert_allclose(got, jl, rtol=1e-5,
                                   atol=1e-5 * np.abs(jl).max())
    assert all(c == v["train_comms"][0] for c in v["train_comms"])
    assert all(c == v["prefill_comms"][0] for c in v["prefill_comms"])


def test_pad_only_ssm_heads_issue_the_same_collectives(world):
    """One mLSTM head at (2, 2): padded to 2, one a rank, so the ranks at
    "model" 1 hold only a pad head.  Such a rank's output must keep its
    autograd link to the cell's inputs: else its backward skips the
    collectives of the real rank's (the input's reduce-scatter, the
    weights' partial sums), which on a real mesh pairs mismatched
    collectives.  Every rank issues the same collectives in the train step
    and the prefill, every gradient that reached a cell is finite, and
    every gradient leaf and the prefill's logits agree with the unsharded
    run at rtol 1e-5 (f32)."""
    arrays, v = _load(world, "pad_only_ssm_heads")
    assert set(v["train_heads1"]) == set(v["prefill_heads1"]) == {1}
    assert v["finite"] == [True] * 4
    for kind in ("train_comms", "prefill_comms"):
        assert v[kind][0] and all(c == v[kind][0] for c in v[kind]), v[kind]
    grads = sorted(k[3:] for k in arrays if k.startswith("g0/"))
    assert grads == sorted(k[3:] for k in arrays if k.startswith("g1/"))
    for k in grads:
        want = arrays["g0/" + k]
        np.testing.assert_allclose(arrays["g1/" + k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(arrays["prefill1"], arrays["prefill0"],
                               rtol=1e-5,
                               atol=1e-5 * np.abs(arrays["prefill0"]).max())


# ---------------------------------------------------------------------------
# the vocab-parallel loss (F10)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag,z", tw.VPLOSS_Z)
def test_vocab_parallel_loss_matches_unsharded_and_jax(world, tag, z):
    """F10: the sharded loss gathered the vocab onto every rank (a rank's
    rows at the whole vocab in f32, five copies).  At (2,2) the logits
    stay split over rows and vocab: the loss, ``nll``, ``z``, ``tokens``
    and the logits' gradient (f32, targets ``-1`` and on both edges of each
    vocab shard) against the port's unsharded loss and JAX's
    ``cross_entropy``; each rank's gradient is its rows' vocab shard, and
    the loss issues the row maxima's and the pair's all-reduces over
    "model" and the partial sums' over "data", no gather."""
    from repro.models import layers as jlayers
    from repro_torch.models.layers import cross_entropy

    arrays, v = _load(world, "vocab_parallel_loss")
    logits, tgt = _vploss_inputs()
    x = torch.from_numpy(logits).requires_grad_(True)
    loss, m = cross_entropy(x, torch.from_numpy(tgt), z)
    g, = torch.autograd.grad(loss, x)
    port = {"loss": loss, **m, "grad": g}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda a: jlayers.cross_entropy(a, jnp.asarray(tgt), z),
        has_aux=True))(jnp.asarray(logits))
    ref = {"loss": lj, **mj, "grad": gj}
    for k in ("loss", "nll", "z", "tokens", "grad"):
        got = arrays[f"{tag}/{k}"]
        np.testing.assert_allclose(got, port[k].detach().numpy(), rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got, np.asarray(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert v[f"{tag}/grad_local"] == [tw.B // 2, tw.S, VPLOSS_V // 2]
    rows = tw.B // 2 * tw.S
    assert [tuple(r) for r in v[f"{tag}/records"]] == [
        ("all-reduce", 4 * rows, 2), ("all-reduce", 8 * rows, 2),
        ("all-reduce", 4, 2)]


@pytest.mark.parametrize("kind", ["dense", "untied"])
def test_vocab_parallel_loss_fn_gradient(world, kind):
    """``loss_fn`` at (2,2) with the vocab split, for the tied MiniCPM-2B
    smoke config and the untied StableLM-3B (f32): the loss and every
    gradient leaf against the port's unsharded ``loss_fn`` and JAX's."""
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    arrays, _ = _load(world, "vocab_parallel_loss")
    cfg = tw.dense_cfg() if kind == "dense" else tw.untied_cfg()
    p = _jax_params(kind)
    tok, tgt = (_tokens(cfg.vocab_size, tw.B) if kind == "dense"
                else _untied_batch())
    leaves = tree_map(lambda a: a.requires_grad_(True),
                      lm.params_from_jax(p, "cpu"))
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    loss, _ = lm.loss_fn(leaves, batch, cfg)
    gs = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    port = tw.flat(tree_map(lambda a: next(gs).numpy(), leaves))
    jcfg = _jax_cfg(kind)
    lj, gj = jax.jit(jax.value_and_grad(lambda q: jlm.loss_fn(
        q, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}, jcfg,
        jsh.ShardCtx.for_mesh(None))[0]))(
        jax.tree_util.tree_map(jnp.asarray, p))
    want = tw.flat(jax.tree_util.tree_map(np.asarray, gj))
    np.testing.assert_allclose(arrays[f"{kind}/loss"], loss.item(), rtol=1e-5)
    np.testing.assert_allclose(arrays[f"{kind}/loss"], float(lj), rtol=1e-5)
    assert port.keys() == want.keys()
    for k, g0 in port.items():
        got = arrays[f"{kind}/g/{k}"]
        for ref in (g0, want[k]):
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=k)
