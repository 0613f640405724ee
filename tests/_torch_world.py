"""A world of gloo ranks for the port's sharded tests.

``run_world`` spawns ``nprocs`` CPU ranks (``torch.multiprocessing``,
``file://`` rendezvous in the test's directory, one thread each, a
deadline on the whole world); every rank runs every named check of this
module in order, in lockstep, and rank 0 writes what the checks return to
``<dir>/<check>.npz`` and their outcomes to ``<dir>/outcomes.json``.  A
check returns a dict of numpy arrays (and plain values, which land in
the outcome).  The tests read them and hold them against the port's
unsharded runs and against JAX.

Inputs a check needs from JAX (parameters, a batch) are written by the
test into ``<dir>/inputs_<name>.npz`` before the world starts.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, S = 4, 16


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def run_world(checks: list[str], nprocs: int, directory: str,
              timeout: float = 240.0) -> dict:
    """Run ``checks`` on a spawned world; returns ``{check: "ok" or the
    failing rank's traceback}``.  A world past ``timeout`` is killed."""
    pc = mp.start_processes(_rank_main, args=(nprocs, directory, checks),
                            nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not pc.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {nprocs} ranks past {timeout} s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
    with open(os.path.join(directory, "outcomes.json")) as f:
        return json.load(f)


def _rank_main(rank: int, nprocs: int, directory: str, checks: list[str]):
    import sys

    torch.set_num_threads(1)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import warnings
    warnings.filterwarnings("ignore")
    from repro_torch.launch.mesh import MeshSpec, build_device_mesh, \
        init_distributed

    # collectives fail after a minute instead of hanging the world
    init_distributed("cpu", rank=rank, world_size=nprocs,
                     init_method="file://" + os.path.join(directory, "rdv"),
                     timeout=datetime.timedelta(seconds=60))
    w = World(rank, nprocs, directory,
              build_device_mesh(MeshSpec(("data", "model"), (2, 2)), "cpu"),
              build_device_mesh(MeshSpec(("data", "model"), (4, 1)), "cpu"))
    outcomes = {}
    for name in checks:
        torch.manual_seed(0)
        try:
            out = globals()["check_" + name](w) or {}
            status = "ok"
        except Exception:  # noqa: BLE001 -- reported to the test
            out, status = {}, traceback.format_exc()
        statuses = [None] * nprocs
        dist.all_gather_object(statuses, status)
        bad = [f"rank {r}:\n{s}" for r, s in enumerate(statuses) if s != "ok"]
        outcomes[name] = "ok" if not bad else "\n".join(bad)
        if rank == 0:
            arrays = {k: v for k, v in out.items()
                      if isinstance(v, np.ndarray)}
            np.savez(os.path.join(directory, f"{name}.npz"), **arrays)
            outcomes[name + ".values"] = {
                k: v for k, v in out.items() if not isinstance(v, np.ndarray)}
    if rank == 0:
        with open(os.path.join(directory, "outcomes.json"), "w") as f:
            json.dump(outcomes, f)
    dist.barrier()
    dist.destroy_process_group()


@dataclasses.dataclass
class World:
    rank: int
    size: int
    dir: str
    mesh22: object
    mesh41: object

    def inputs(self, name: str) -> dict:
        with np.load(os.path.join(self.dir, f"inputs_{name}.npz")) as f:
            return {k: f[k] for k in f.files}

    def gather(self, value):
        out = [None] * self.size
        dist.all_gather_object(out, value)
        return out


# ---------------------------------------------------------------------------
# trees of numpy arrays
# ---------------------------------------------------------------------------


def flat(tree, prefix="") -> dict:
    """A nested dict of arrays as ``{"a/b": array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflat(d: dict, prefix: str = "") -> dict:
    out: dict = {}
    for k, v in d.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _np(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------


def dense_cfg():
    from repro_torch.configs.registry import smoke_config
    return dataclasses.replace(smoke_config("minicpm-2b"), dtype="float32")


def deq_cfg():
    from repro_torch.configs.registry import smoke_config
    cfg = smoke_config("minicpm-2b", deq=True)
    return dataclasses.replace(
        cfg, dtype="float32",
        deq=dataclasses.replace(cfg.deq, qn_dtype="float32"))


def untied_cfg():
    """StableLM-3B's smoke config (its own LM head) in f32."""
    from repro_torch.configs.registry import smoke_config
    return dataclasses.replace(smoke_config("stablelm-3b"), dtype="float32")


def moe_cfg():
    from repro_torch.configs.registry import smoke_config
    cfg = smoke_config("deepseek-moe-16b")
    return dataclasses.replace(
        cfg, num_layers=2, dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


def tcfg(zero1=True, batch=B):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(steps=2, global_batch=batch, seq_len=S, lr=1e-3,
                       warmup_steps=1, zero1=zero1)


def _batch(w, name):
    inp = w.inputs(name)
    return {"tokens": torch.from_numpy(inp["tokens"]),
            "targets": torch.from_numpy(inp["targets"])}


def _params(w, name):
    from repro_torch.models import lm
    return lm.params_from_jax(unflat(w.inputs(name), "params/"), "cpu")


# ---------------------------------------------------------------------------
# checks (run on every rank; rank 0's return value is saved)
# ---------------------------------------------------------------------------


def check_placements(w):
    """DTensor's shard of each test tensor on this rank against the
    rounded-up shard XLA pads to (``spec_local_shape``)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import mesh_spec
    from repro_torch.parallel.sharding import placements, spec_local_shape

    cases = [((503, 64), ("model", None)), ((251, 8), ("data", "model")),
             ((4, 36, 16), ("data", "model", None)), ((7,), (("data",
                                                                "model"),))]
    rows = []
    for shape, spec in cases:
        for mesh in (w.mesh22, w.mesh41):
            spec_m = tuple(e if e is None or all(
                n in mesh.mesh_dim_names for n in ((e,) if isinstance(e, str)
                                                   else e)) else None
                for e in spec)
            full = torch.arange(int(np.prod(shape)),
                                dtype=torch.float32).reshape(shape)
            dt = distribute_tensor(full, mesh, placements(spec_m, mesh),
                                   src_data_rank=None)
            local = tuple(dt.to_local().shape)
            assert torch.equal(dt.full_tensor(), full)
            rows.append([list(shape), str(spec_m),
                         list(mesh.mesh.shape), local,
                         list(spec_local_shape(shape, spec_m,
                                               mesh_spec(mesh)))])
    return {"rows": w.gather(rows)}


def _train(w, cfg, name, ctx, steps_n=1, zero1=True, batch=B):
    from repro_torch.core import solvers
    from repro_torch.launch import steps

    tc = tcfg(zero1, batch)
    params = _params(w, name)
    b = _batch(w, name)
    state = steps.init_train_state(cfg, tc, params=params, ctx=ctx)
    step = steps.build_train_step(cfg, tc, ctx=ctx)
    reads0 = solvers.STOP_READS[0]
    ms = []
    for _ in range(steps_n):
        state, m = step(state, b)
        ms.append(m)
    return state, ms, solvers.STOP_READS[0] - reads0


def _step_check(w, cfg, name):
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import (
        NULL_CTX,
        full_tree,
        spec_of,
        zero1_spec,
    )

    s0, m0, _ = _train(w, cfg, name, NULL_CTX)
    ctx = make_ctx(cfg, w.mesh22, SHAPES["train_4k"])
    s1, m1, reads = _train(w, cfg, name, ctx)
    out = {"loss0": float(m0[0]["loss"]), "loss1": float(m1[0]["loss"]),
           "gnorm0": float(m0[0]["grad_norm"]),
           "gnorm1": float(m1[0]["grad_norm"]),
           "reads": w.gather(reads),
           "steps": w.gather(float(m1[0].get("deq_steps", 0.0))),
           "steps0": float(m0[0].get("deq_steps", 0.0))}
    p0, p1 = flat(s0.params), flat(full_tree(s1.params))
    out.update({"p0/" + k: _np(v) for k, v in p0.items()})
    out.update({"p1/" + k: _np(v) for k, v in p1.items()})
    # the moments lie where zero1_spec says (trailing replicated entries
    # dropped on both sides)
    decl = flat(lm.model_decl(cfg))
    mu = flat(s1.opt.mu)
    zsize = ctx.mesh.shape["data"]

    def trim(spec):
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    out["moments_as_zero1"] = [
        k for k, d in decl.items()
        if trim(spec_of(mu[k].placements, ctx.device_mesh))
        != trim(zero1_spec(d, ctx.rules, zero_size=zsize))]
    out["moments_split_over_data"] = sum(
        "data" in str(spec_of(mu[k].placements, ctx.device_mesh))
        for k in mu)
    # the gradients themselves (a cold solve), leaf by leaf
    for tag, c, params in (("g0/", NULL_CTX, _params(w, name)),
                           ("g1/", ctx, steps.init_train_state(
                               cfg, tcfg(), params=_params(w, name),
                               ctx=ctx).params)):
        out.update({tag + k: _np(v)
                    for k, v in flat(_grads(cfg, params, _batch(w, name),
                                            c)).items()})
    if s1.carry is not None:
        out["ring"] = str(s1.carry.lowrank.u.placements)
        out["ring_local"] = list(s1.carry.lowrank.u.to_local().shape)
    return out


def _grads(cfg, params, batch, ctx):
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.parallel.sharding import spmd

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with spmd(ctx):
        loss, _ = lm.loss_fn(leaves, batch, cfg, ctx=ctx)
        gs = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return tree_map(lambda p: next(gs), leaves)


def check_dense_step(w):
    return _step_check(w, dense_cfg(), "dense")


def check_deq_step(w):
    return _step_check(w, deq_cfg(), "deq")


def check_batched_solve(w):
    """The reference's batched-solve layout test at (4, 1), and the
    ``qn_apply_multi`` route against the plain op."""
    from repro_torch.core.solvers import init_solve_carry
    from repro_torch.implicit import ImplicitConfig
    from repro_torch.implicit.engine import batched_solve
    from repro_torch.kernels import ops, ref
    from repro_torch.parallel.sharding import TRAIN_RULES, ShardCtx, \
        distribute_tree
    from repro_torch.parallel.sharding import spmd as sh_spmd

    ctx = ShardCtx.for_mesh(w.mesh41, TRAIN_RULES)
    d = 16
    g = torch.Generator().manual_seed(0)
    a = 0.5 * torch.randn((d, d), generator=g) / np.sqrt(d)
    b = torch.randn((8, d), generator=g)
    cfg = ImplicitConfig.from_strings(solver="broyden", max_steps=40,
                                      tol=1e-6, memory=20)
    z0 = ctx.constrain(torch.zeros((8, d)), ("batch", "flat"))
    valid = torch.arange(8) < 5
    # each row its own contraction: the rows converge at different steps
    scale = torch.tensor([0.1, 0.9, 0.3, 1.0, 0.6, 1.0, 1.0, 1.0])
    carry = init_solve_carry(8, d, 20, qn_dtype="float32")
    carry = distribute_tree(carry, type(carry)(
        z=("data", None), lowrank=type(carry.lowrank)(
            alpha=(), u=(None, "data", None), v=(None, "data", None),
            count=("data",)), warm=("data",), age=("data",)), w.mesh41)
    from repro_torch.core import solvers
    reads0 = solvers.STOP_READS[0]
    with sh_spmd(ctx):
        z, stats, new_carry = batched_solve(
            lambda p, x, zz: (zz @ p[0].t()) * p[1][:, None] + x, (a, scale),
            b, z0, cfg, valid=valid, carry=carry, ctx=ctx,
            state_axes=("batch", "flat"))
    z_star = torch.stack([torch.linalg.solve(torch.eye(d) - c * a, r)
                          for c, r in zip(scale, b)])
    u = new_carry.lowrank.u
    out = {"z": _np(z), "z_star": z_star.numpy(),
           "converged": bool(stats.converged.full_tensor().all()),
           "n_steps": int(stats.n_steps), "ring": str(u.placements),
           "ring_local": list(u.to_local().shape),
           "rows_steps": _np(torch.isfinite(stats.trace.full_tensor()).sum(0)),
           "reads": w.gather(solvers.STOP_READS[0] - reads0)}
    # the qN route: batch-split operands against the plain op
    m, bb, dd = 8, 8, 256
    u0 = torch.randn((m, bb, dd), generator=g)
    v0 = torch.randn((m, bb, dd), generator=g)
    xs = torch.randn((2, bb, dd), generator=g)
    mask = (torch.rand((m, bb), generator=g) > 0.3).float()
    want = ref.qn_apply_multi_ref(u0, v0, xs, torch.tensor(1.0), mask,
                                  (False, True))
    sh = lambda t, spec: ctx.constrain(t, spec)  # noqa: E731
    got = ops.qn_apply_multi_sharded(
        sh(u0, ("qn_mem", "batch", None)), sh(v0, ("qn_mem", "batch", None)),
        sh(xs, (None, "batch", None)), torch.tensor(1.0),
        sh(mask, ("qn_mem", "batch")), (False, True))
    out.update({"qn_want": want.numpy(), "qn_got": _np(got),
                "qn_placements": str(got.placements)})
    # the Broyden step's route: every output against the plain step
    gn, s_, hg = (torch.randn((bb, dd), generator=g) for _ in range(3))
    slot = (torch.arange(bb) % m).int()
    active = torch.rand((bb,), generator=g) > 0.2
    alpha = torch.tensor(0.8)
    want = ref.broyden_step_ref(u0, v0, gn, s_, hg, alpha, mask, slot,
                                active, 1e-8)
    rows = ("batch", None)
    got = ops.broyden_step(
        sh(u0, ("qn_mem", "batch", None)), sh(v0, ("qn_mem", "batch", None)),
        sh(gn, rows), sh(s_, rows), sh(hg, rows), alpha,
        sh(mask, ("qn_mem", "batch")), sh(slot, ("batch",)),
        sh(active, ("batch",)), 1e-8)
    for i, (a, b) in enumerate(zip(got, want)):
        out[f"broyden_got{i}"], out[f"broyden_want{i}"] = _np(a), _np(b)
    return out


def check_seq_parallel(w):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as sh

    cfg = dataclasses.replace(smoke_config("stablelm-3b"), dtype="float32")
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, S)).astype(np.int32))
    out0, _ = lm.forward(params, {"tokens": toks}, cfg, train=False)
    cfg_sp = dataclasses.replace(cfg, seq_parallel=True)
    ctx = make_ctx(cfg_sp, w.mesh22, SHAPES["train_4k"])
    assert ctx.rules.physical("seq_res") == "model"
    pd = lm.place_params(params, cfg, ctx)
    out1, _ = lm.forward(pd, {"tokens": toks}, cfg_sp, train=False, ctx=ctx)
    return {"out0": out0.numpy(), "out1": _np(out1)}


def _greedy(params, cfg, toks, n, ctx=None):
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import full_tree

    logits, caches, lens = lm.prefill(params, {"tokens": toks}, cfg, 32,
                                      **({"ctx": ctx[1]} if ctx else {}))
    nxt = full_tree(logits)[:, -1].argmax(-1).int()
    out, logit_rows = [nxt], []
    for _ in range(n):
        lg, caches = lm.decode_step(params, caches, nxt, full_tree(lens),
                                    cfg, **({"ctx": ctx[0]} if ctx else {}))
        lg = full_tree(lg)
        logit_rows.append(lg)
        nxt = lg.argmax(-1).int()
        out.append(nxt)
        lens = full_tree(lens) + 1
    return torch.stack(out, 1), torch.stack(logit_rows, 1)


def check_decode(w):
    """Greedy decode under DECODE_RULES (cache length over "model") against
    the unsharded decode; and the sync serving loop on the mesh."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.serving import Request, ServeLoop

    out = {}
    for arch in ("internlm2-20b", "deepseek-v2-lite-16b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        params = lm.init_params(cfg, seed=0, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 8)).astype(np.int32))
        t0, l0 = _greedy(params, cfg, toks, 5)
        dctx = make_ctx(cfg, w.mesh22, SHAPES["decode_32k"])
        pctx = make_ctx(cfg, w.mesh22, SHAPES["prefill_32k"])
        pd = lm.place_params(params, cfg, dctx)
        t1, l1 = _greedy(pd, cfg, toks, 5, (dctx, pctx))
        out[f"{arch}/tokens0"], out[f"{arch}/tokens1"] = t0.numpy(), t1.numpy()
        out[f"{arch}/logits0"], out[f"{arch}/logits1"] = l0.numpy(), l1.numpy()
        caches = lm.init_cache(cfg, 2, 32, "cpu", dctx)
        out[f"{arch}/cache"] = str(caches["group0"].k.placements)
    # the sync serving loop: the DEQ's batch-split solves, T-split caches
    cfg = deq_cfg()
    params = lm.init_params(cfg, seed=0, device="cpu")

    def reqs():
        return [Request(uid=i, prompt=[3, 5, 7, 11 + i][:3 + i % 2],
                        max_new_tokens=4) for i in range(5)]
    r0 = reqs()
    ServeLoop(params, cfg, slots=4, max_len=32, eos_id=-1).drain(r0)
    dctx = make_ctx(cfg, w.mesh22, SHAPES["decode_32k"])
    pctx = make_ctx(cfg, w.mesh22, SHAPES["prefill_32k"])
    pd = lm.place_params(params, cfg, dctx)
    r1 = reqs()
    loop = ServeLoop(pd, cfg, slots=4, max_len=32, eos_id=-1, ctx=dctx,
                     prefill_ctx=pctx)
    loop.drain(r1)
    out["serve0"] = np.array([r.out for r in r0])
    out["serve1"] = np.array([r.out for r in r1])
    out["serve_all_ranks"] = w.gather([r.out for r in r1])
    return out


def check_moe_ep(w):
    """The expert-parallel branch at (2, 2) with a capacity that drops
    tokens: one MoE block on the test's inputs."""
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh

    cfg = moe_cfg()
    inp = w.inputs("moe")
    params = to_torch(unflat(inp, "params/"))
    x = torch.from_numpy(inp["x"])
    ctx = make_ctx(cfg, w.mesh22, SHAPES["train_4k"])
    assert ctx.axis_size("expert_act") == 2
    decl = moe.moe_decl(cfg)
    pd = sh.distribute_tree(params, sh.spec_tree(decl, ctx.rules), w.mesh22)
    with sh.spmd(ctx):
        out, aux = moe.moe_block(pd, ctx.constrain(
            x, ("batch", "seq", "embed_act")), cfg, ctx)
        o0, aux0 = moe.moe_block(params, x, cfg)
    return {"out": _np(out), "aux": _np(aux["moe_aux"]),
            "z": _np(aux["moe_z"]),
            "aux_shards": np.array(w.gather(float(aux["moe_aux"].to_local()))),
            "z_shards": np.array(w.gather(float(aux["moe_z"].to_local()))),
            "out_whole": o0.numpy(),
            "aux_whole": aux0["moe_aux"].numpy()}


def check_compression(w):
    """``compress_pod_gradients`` at (pod=2, data=2): two steps, the second
    with the first's error feedback."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.optim.compression import (
        compress_pod_gradients,
        compression_init,
    )

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    pod = mesh.get_local_rank("pod")
    g = torch.Generator().manual_seed(100 + pod)
    grads = {"w": torch.randn((3, 300), generator=g),
             "b": torch.randn((7,), generator=g) * 1e-3}
    st = compression_init(grads)
    r1, st = compress_pod_gradients(grads, st, mesh)
    r2, st2 = compress_pod_gradients(grads, st, mesh)
    rows = w.gather({"pod": pod,
                     **{f"r1/{k}": v.numpy().tolist() for k, v in r1.items()},
                     **{f"e1/{k}": v.numpy().tolist()
                        for k, v in st.error.items()},
                     **{f"r2/{k}": v.numpy().tolist() for k, v in r2.items()},
                     **{f"e2/{k}": v.numpy().tolist()
                        for k, v in st2.error.items()},
                     **{f"g/{k}": v.numpy().tolist()
                        for k, v in grads.items()}})
    return {"rows": rows}


def check_checkpoint(w):
    """A DEQ state written at (2, 2) restores at (4, 1) and warm-starts."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch import steps
    from repro_torch.parallel.sharding import full_tree

    cfg = deq_cfg()
    tc = tcfg(zero1=False, batch=8)
    params = _params(w, "deq")
    inp = w.inputs("deq8")
    b = {"tokens": torch.from_numpy(inp["tokens"]),
         "targets": torch.from_numpy(inp["targets"])}
    ctx = make_ctx(cfg, w.mesh22, SHAPES["train_4k"])
    state = steps.init_train_state(cfg, tc, params=params, ctx=ctx)
    state, _ = steps.build_train_step(cfg, tc, ctx=ctx)(state, b)
    before = full_tree(state.carry)
    mgr = CheckpointManager(os.path.join(w.dir, "ckpt"), keep=1,
                            async_save=False)
    mgr.save(1, state)
    ctx2 = make_ctx(cfg, w.mesh41, SHAPES["train_4k"])
    template = steps.init_train_state(cfg, tc, params=params, ctx=ctx2)
    _, restored, _ = mgr.restore(template)
    after = full_tree(restored.carry)
    u = restored.carry.lowrank.u
    state2, _ = steps.build_train_step(cfg, tc, ctx=ctx2)(restored, b)
    return {"age0": before.age.numpy(), "age1": after.age.numpy(),
            "z0": _np(before.z), "z1": _np(after.z),
            "u0": _np(before.lowrank.u), "u1": _np(after.lowrank.u),
            "age2": _np(full_tree(state2.carry).age),
            "warm": bool(before.warm.all()),
            "ring": str(u.placements), "ring_local": list(u.to_local().shape)}


def check_pipeline_and_elastic(w):
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.data.pipeline import make_lm_batch_iterator
    from repro_torch.runtime.ft import ElasticMeshManager

    cfg = dense_cfg()
    ctx = make_ctx(cfg, w.mesh22, SHAPES["train_4k"])
    whole = next(make_lm_batch_iterator(cfg, 4, S, seed=3, device="cpu"))
    mine = next(make_lm_batch_iterator(cfg, 4, S, seed=3, device="cpu",
                                       ctx=ctx))
    same = torch.equal(mine["tokens"].full_tensor(), whole["tokens"])
    rows = list(mine["tokens"].to_local().shape)
    spec, mesh = ElasticMeshManager(2).build(device_type="cpu")
    spec3, mesh3 = ElasticMeshManager(2).build(3, device_type="cpu")
    solved = None
    if mesh3 is not None:  # a solve on the re-mesh: its ranks alone
        from repro_torch.implicit import ImplicitConfig
        from repro_torch.implicit.engine import batched_solve
        from repro_torch.parallel.sharding import ShardCtx, spmd
        ctx3 = ShardCtx.for_mesh(mesh3)
        a = 0.4 * torch.eye(8)
        b = torch.arange(32.0).reshape(4, 8) / 32
        with spmd(ctx3):
            z, stats = batched_solve(
                lambda p, x, zz: zz @ p.t() + x, a, b,
                ctx3.constrain(torch.zeros((4, 8)), ("batch", "flat")),
                ImplicitConfig.from_strings(solver="broyden", max_steps=30,
                                            tol=1e-6, memory=8),
                ctx=ctx3, state_axes=("batch", "flat"))
        solved = bool(torch.allclose(z.full_tensor(), b / 0.6, atol=1e-4))
    return {"pipeline_same": all(w.gather(same)), "rows": w.gather(rows),
            "elastic": [list(spec.sizes), list(mesh.mesh.shape)],
            "elastic3": [list(spec3.sizes),
                         w.gather(mesh3 is not None)],
            "elastic3_solved": w.gather(solved)}


# ---------------------------------------------------------------------------
# serving on the mesh: both pipelines, both prefix caches
# ---------------------------------------------------------------------------

# the arms held against the port's and JAX's unsharded drains of the same
# arm; every loop at 4 slots (2 a data rank), EOS off
SERVE_ARMS = {
    "async": dict(pipeline="async", async_depth=2),
    "async_store": dict(pipeline="async", async_depth=2, prefix_cache=True,
                        prefix_cache_slots=16),
    "sync_index": dict(pipeline="sync", prefix_cache=True,
                       prefix_cache_slots=16),
}
SERVE_KW = dict(slots=4, max_len=32, eos_id=-1, record=True)
SERVE_NEW = 3
# the skew check: entries held unready for this many polls on ranks 1, 3
SKEW_POLLS = 3


def serve_prompts(vocab: int = 503, seed: int = 11) -> list[list[int]]:
    """Six 12-token prompts over one shared 8-token base: four in the
    first wave, then the first again (an exact hit) and one more tail (a
    partial hit)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(2, vocab, size=8).tolist()
    tails = [base + rng.integers(2, vocab, size=4).tolist() for _ in range(5)]
    return tails[:4] + [list(tails[0]), tails[4]]


def _serve_ctxs(cfg, mesh):
    from repro_torch.configs.shapes import SHAPES, make_ctx
    return (make_ctx(cfg, mesh, SHAPES["decode_32k"]),
            make_ctx(cfg, mesh, SHAPES["prefill_32k"]))


def _serve(params, cfg, kw, ctxs=None, ready=None):
    """A drain of ``serve_prompts`` through one ``ServeLoop(**kw)``: the
    loop, the requests and the collectives by op (``CommDebugMode``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.runtime.serving import Request, ServeLoop

    extra = {} if ctxs is None else {"ctx": ctxs[0], "prefill_ctx": ctxs[1]}
    loop = ServeLoop(params, cfg, **SERVE_KW, **kw, **extra)
    if ready is not None:
        loop._entry_ready = ready
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=SERVE_NEW)
            for i, p in enumerate(serve_prompts(cfg.vocab_size))]
    mode = CommDebugMode()
    with mode:
        loop.drain(reqs)
    comms = {str(k).split(".")[-1]: v
             for k, v in sorted(mode.get_comm_counts().items(),
                                key=lambda kv: str(kv[0]))}
    return loop, reqs, comms


# the carry staleness bound on the mesh: the stale reset of each pipeline
STALE_ARMS = {"sync_stale": dict(pipeline="sync", carry_max_age=1),
              "async_stale": dict(pipeline="async", async_depth=2,
                                  carry_max_age=1)}


def _serve_record(loop, reqs) -> dict:
    cache = loop.prefix if loop.prefix is not None else loop.prefix_store
    stats = cache.stats() if cache is not None else {}
    return {"tokens": [r.out for r in reqs],
            "evictions": dict(loop.carries.evictions_by_reason),
            "errors": [r.error for r in reqs],
            "hits": stats.get("hits", 0), "lookups": stats.get("lookups", 0),
            "prefill_iters": loop.prefill_iters,
            "saved_iters": loop.saved_iters,
            "prefill_calls": loop.prefill_calls,
            "steps": {str(k): v for k, v in loop.recorded_steps.items()},
            "inflight": len(loop._inflight)}


def check_serve_arms(w):
    """Each arm of ``SERVE_ARMS`` and ``STALE_ARMS`` drained at (2, 2) and
    unsharded, and the async store arm once more with entries held unready for
    ``SKEW_POLLS`` polls on ranks 1 and 3 only."""
    import collections

    from repro_torch.models import lm

    cfg = deq_cfg()
    params = _params(w, "deq")
    ctxs = _serve_ctxs(cfg, w.mesh22)
    placed = lm.place_params(params, cfg, ctxs[0])
    out = {}
    for arm, kw in {**SERVE_ARMS, **STALE_ARMS}.items():
        loop0, reqs0, _ = _serve(params, cfg, kw)
        loop1, reqs1, comms = _serve(placed, cfg, kw, ctxs)
        out[arm] = {"unsharded": _serve_record(loop0, reqs0),
                    "sharded": _serve_record(loop1, reqs1),
                    "all_ranks": w.gather([r.out for r in reqs1]),
                    "comms": w.gather(comms)}
    polls: collections.Counter = collections.Counter()

    def held(e):
        polls[id(e)] += 1
        return polls[id(e)] > SKEW_POLLS

    skewed = w.rank in (1, 3)
    loop2, reqs2, comms2 = _serve(placed, cfg, SERVE_ARMS["async_store"],
                                  ctxs, ready=held if skewed else None)
    out["skew"] = {"sharded": _serve_record(loop2, reqs2),
                   "all_ranks": w.gather([r.out for r in reqs2]),
                   "comms": w.gather(comms2),
                   "held_polls": w.gather(sum(polls.values()))}
    return out


class _Gathers:
    """A dispatch mode noting the gathers a block issues: each collective
    op whose name holds "gather", with its first input's shape and dtype
    (DTensor ops run first, so what is seen are their collectives on
    local tensors, as ``CommDebugMode`` sees them)."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented
                name = getattr(func, "__name__", str(func))
                if "gather" in name and args and isinstance(args[0],
                                                            torch.Tensor):
                    seen.append((name, list(args[0].shape),
                                 str(args[0].dtype)))
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def check_tick_gathers(w):
    """One decode tick of each pipeline at (2, 2), no admission in it:
    the collectives that gather, by input shape and dtype, beside the
    local shapes of the carry's leaves."""
    from repro_torch.models import lm
    from repro_torch.runtime.serving import Request, ServeLoop

    cfg = deq_cfg()
    ctxs = _serve_ctxs(cfg, w.mesh22)
    placed = lm.place_params(_params(w, "deq"), cfg, ctxs[0])
    out = {}
    for pipeline in ("sync", "async"):
        loop = ServeLoop(placed, cfg, slots=4, max_len=32, eos_id=-1,
                         pipeline=pipeline, ctx=ctxs[0], prefill_ctx=ctxs[1])
        for i, p in enumerate(serve_prompts(cfg.vocab_size)[:4]):
            loop.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        for _ in range(3):
            loop.step()
        g = _Gathers()
        with g.mode:
            loop.step()
        c = loop.carries.carry
        out[pipeline] = {
            "gathers": g.seen,
            "carry_local": {
                "z": [list(c.z.to_local().shape), str(c.z.dtype)],
                "u": [list(c.lowrank.u.to_local().shape),
                      str(c.lowrank.u.dtype)],
                "count": [list(c.lowrank.count.to_local().shape),
                          str(c.lowrank.count.dtype)],
                "warm": [list(c.warm.to_local().shape), str(c.warm.dtype)]},
            "placements": str(c.lowrank.u.placements)}
    return out


# ---------------------------------------------------------------------------
# gradient accumulation on the mesh
# ---------------------------------------------------------------------------


def _accum(w, cfg, name, ctx, k, batch):
    from repro_torch.launch import steps
    from repro_torch.parallel.sharding import full_tree

    tc = dataclasses.replace(tcfg(True, batch), grad_accum=k)
    state = steps.init_train_state(cfg, tc, params=_params(w, name),
                                   ctx=ctx)
    state, m = steps.build_train_step(cfg, tc, ctx=ctx)(state, _batch(w, name))
    return ({k2: _np(v) for k2, v in flat(full_tree(state.params)).items()},
            {k2: _np(v) for k2, v in flat(full_tree(state.opt.mu)).items()},
            float(m["loss"]), float(m["grad_norm"]), state)


def _accum_check(w, cfg, name, mesh, k, batch):
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.parallel.sharding import NULL_CTX

    p0, mu0, l0, g0, _ = _accum(w, cfg, name, NULL_CTX, k, batch)
    ctx = make_ctx(cfg, mesh, SHAPES["train_4k"])
    p1, mu1, l1, g1, s1 = _accum(w, cfg, name, ctx, k, batch)
    out = {"loss0": l0, "loss1": l1, "gnorm0": g0, "gnorm1": g1,
           "carry": s1.carry is not None,
           "mu_placements": str(next(iter(
               flat(s1.opt.mu).values())).placements)}
    out.update({"p0/" + k2: v for k2, v in p0.items()})
    out.update({"p1/" + k2: v for k2, v in p1.items()})
    out.update({"mu0/" + k2: v for k2, v in mu0.items()})
    out.update({"mu1/" + k2: v for k2, v in mu1.items()})
    return out


def check_accum_dense(w):
    return _accum_check(w, dense_cfg(), "dense", w.mesh22, 2, B)


def check_accum_deq(w):
    return _accum_check(w, deq_cfg(), "deq8", w.mesh22, 2, 8)


def check_accum_uneven(w):
    """B=8, k=4 at (4, 1): each microbatch of 2 rows over 4 data ranks."""
    return _accum_check(w, dense_cfg(), "dense8", w.mesh41, 4, 8)


# ---------------------------------------------------------------------------
# the dry-run's cells on real tensors, and query heads that do not divide
# ---------------------------------------------------------------------------

# (kind, deq) of the dry-run cells held against a fake world of the same
# mesh: every collective and rank 0's allocations
DRYRUN_CELLS = (("train", False), ("prefill", False), ("decode", False),
                ("train", True))


def dryrun_cell(cfg, kind: str, mesh, args=None):
    """The dry-run's cell of a smoke ``cfg`` at (B, S) = (``B``, ``S``) on
    ``mesh`` (a ``DeviceMesh``), its arguments ``args`` (whole tensors,
    placed here), or ``meta`` ones; returns ``(rank 0's peak bytes, the
    collectives as (kind, bytes, group) triples)``."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import dryrun
    from repro_torch.parallel.sharding import distribute_tree

    cfg = dryrun._costing_config(cfg, cfg.num_layers)
    shape = ShapeSuite(kind, kind, S, B)
    cell = dryrun.build_cell(cfg, shape, mesh, dryrun._train_config(shape, 1))
    if args is not None:
        cell = dataclasses.replace(cell, args=tuple(
            distribute_tree(a, sp, mesh)
            for a, sp in zip(args(cfg, shape), cell.specs)))
    peak, _, records = dryrun.run_step(cell)
    return peak, [tuple(r) for r in records]


def real_cell_args(cfg, shape):
    """A cell's arguments as real CPU tensors, the same on every rank
    (parameters from seed 0, tokens from a seeded generator, cold caches
    and state)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    gen = torch.Generator().manual_seed(0)
    b, s = shape.global_batch, shape.seq_len

    def tok(*size):
        return torch.randint(0, cfg.vocab_size, size, generator=gen,
                             dtype=torch.int32)

    if shape.kind == "train":
        tc = dataclasses.replace(tcfg(batch=b), seq_len=s)
        return (steps.init_train_state(cfg, tc, device="cpu"),
                {"tokens": tok(b, s), "targets": tok(b, s)})
    params = lm.init_params(cfg, seed=0, device="cpu")
    if shape.kind == "prefill":
        return (params, {"tokens": tok(b, s)})
    return (params, lm.init_cache(cfg, b, s, device="cpu"), tok(b),
            torch.tensor([3, 7, 0, 15][:b], dtype=torch.int32))


def check_dryrun_cells(w):
    """The dry-run's smoke cells run at (2, 2) on real tensors: rank 0's
    collectives as issued and its peak of allocated bytes (``LiveBytes``
    over the local shards), for the test to hold against a fake world."""
    from repro_torch.configs.registry import smoke_config

    out = {}
    for kind, deq in DRYRUN_CELLS:
        cfg = dataclasses.replace(smoke_config("minicpm-2b", deq=deq),
                                  dtype="float32")
        peak, records = dryrun_cell(cfg, kind, w.mesh22, real_cell_args)
        tag = f"{kind}{'_deq' if deq else ''}"
        out[tag + "_peak"] = peak
        out[tag + "_records"] = records
    return out


def uneven_heads_cfg():
    """MiniCPM-2B's smoke config with 3 query (and KV) heads: neither
    divides the (2, 2) mesh's "model" axis, as 36 heads do not divide 16."""
    return dataclasses.replace(dense_cfg(), num_heads=3, num_kv_heads=3)


def check_uneven_heads(w):
    """A train step (its loss, gradient norm and every gradient leaf), a
    prefill and a decode step at (2, 2) with query heads that do not
    divide "model", against the same runs unsharded."""
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import NULL_CTX, distribute_tree, \
        whole
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = uneven_heads_cfg()
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = {}
    for tag, ctx in (("0", NULL_CTX),
                     ("1", make_ctx(cfg, w.mesh22, SHAPES["train_4k"]))):
        if tag == "0" and w.rank:  # the unsharded runs: rank 0's alone
            continue
        tc = tcfg()
        params = lm.init_params(cfg, seed=0, device="cpu")
        state = steps.init_train_state(cfg, tc, params=params, ctx=ctx)
        mode = CommDebugMode()
        with mode:
            state, m = steps.build_train_step(cfg, tc, ctx=ctx)(state, batch)
        out["loss" + tag] = float(m["loss"])
        out["gnorm" + tag] = float(m["grad_norm"])
        placed = steps.init_train_state(cfg, tc, params=params, ctx=ctx)
        out.update({f"g{tag}/{k}": _np(v) for k, v in flat(
            _grads(cfg, placed.params, batch, ctx)).items()})
        if tag == "1":
            out["train_comms"] = {str(k).split(".")[-1]: v for k, v in
                                  mode.get_comm_counts().items()}
    params = lm.init_params(cfg, seed=0, device="cpu")
    for tag, shape_name in (("0", None), ("1", "decode_32k")):
        if tag == "0" and w.rank:
            continue
        p, caches = params, lm.init_cache(cfg, B, 2 * S, device="cpu")
        ctx = NULL_CTX
        if shape_name:
            from repro_torch.configs.shapes import cache_sharding
            from repro_torch.launch.steps import param_shardings
            ctx = make_ctx(cfg, w.mesh22, SHAPES[shape_name])
            p = distribute_tree(params, param_shardings(cfg, ctx), w.mesh22)
            caches = distribute_tree(caches,
                                     cache_sharding(cfg, ctx, caches),
                                     w.mesh22)
        logits, caches, lens = steps.build_prefill(cfg, ctx, 2 * S)(
            p, {"tokens": batch["tokens"]})
        nxt = whole(logits)[:, -1].argmax(-1).to(torch.int32)
        dl, _ = steps.build_decode_step(cfg, ctx)(
            p, caches, nxt, torch.full((B,), S, dtype=torch.int32))
        out["prefill" + tag] = _np(logits)
        out["decode" + tag] = _np(dl)
    return out


def check_decode_split_twice(w):
    """The decode attention over a cache whose length is split over both
    mesh dims (as long-context decode splits it over "pod" and "data"),
    against the plain decode over the whole cache; one row's keys end in
    the first slice, so the other slices hold none of it."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(3)
    b, h, kvh, hd, t = 2, 4, 2, 16, 32
    q = torch.randn(b, h, hd, generator=gen)
    k = torch.randn(b, t, kvh, hd, generator=gen)
    v = torch.randn(b, t, kvh, hd, generator=gen)
    lens = torch.tensor([30, 7], dtype=torch.int32)
    kd, vd = (distribute_tensor(x, w.mesh22, (Shard(1), Shard(1)),
                                src_data_rank=None) for x in (k, v))
    got = ops.decode_attention(q, kd, vd, lens)
    return {"got": _np(got),
            "want": ref.decode_attention_ref(q, k, v, lens).numpy()}


def check_ssm_families(w):
    """Zamba2's chunked SSD and xLSTM's chunked mLSTM cell run on each
    rank's local rows and heads (``map_local``): at (2, 2), every gradient
    leaf of a smoke train step's loss and a prefill's logits against the
    unsharded runs (f32, S=32: two chunks of 16)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import NULL_CTX, distribute_tree

    out = {}
    for arch in ("zamba2-2.7b", "xlstm-1.3b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (B, 33), generator=gen,
                             dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        params = lm.init_params(cfg, seed=0, device="cpu")
        tctx = make_ctx(cfg, w.mesh22, SHAPES["train_4k"])
        placed = distribute_tree(params, steps.param_shardings(cfg, tctx),
                                 w.mesh22)
        for tag, p, ctx in (("0", params, NULL_CTX), ("1", placed, tctx)):
            if tag == "0" and w.rank:  # the unsharded runs: rank 0's
                continue
            out.update({f"{arch}/g{tag}/{k}": _np(v) for k, v in flat(
                _grads(cfg, p, batch, ctx)).items()})
        pctx = make_ctx(cfg, w.mesh22, SHAPES["prefill_32k"])
        pp = distribute_tree(params, steps.param_shardings(cfg, pctx),
                             w.mesh22)
        for tag, p, ctx in (("0", params, NULL_CTX), ("1", pp, pctx)):
            if tag == "0" and w.rank:
                continue
            logits, _, _ = steps.build_prefill(cfg, ctx, 40)(
                p, {"tokens": batch["tokens"]})
            out[f"{arch}/prefill{tag}"] = _np(logits)
    return out


# xLSTM at 3 heads and at 1: the tokens of a train step and a prefill (S
# 37: two chunks of 16 and a padded third)
XLSTM3_S = 37


def xlstm3_cfg(heads: int = 3):
    """xLSTM-1.3B's smoke config at ``heads`` heads over one unit (d 96),
    in f32: 3 heads (or 1) do not divide the (2, 2) mesh's "model", as
    xLSTM-1.3B's 4 do not divide 16."""
    from repro_torch.configs.registry import smoke_config
    return dataclasses.replace(smoke_config("xlstm-1.3b"), dtype="float32",
                               d_model=96, num_heads=heads,
                               num_kv_heads=heads, num_layers=4)


def _padded_ssm_heads(w, heads: int) -> dict:
    """A (2, 2) train step's loss gradients and a prefill's logits for the
    ``heads``-head smoke xLSTM, each beside the same run unsharded (rank
    0's); the heads each rank's cell held, whether every gradient that
    reached a cell's inputs (pad heads included) was finite, and each
    rank's collectives by op in the sharded runs."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch import steps
    from repro_torch.models import xlstm
    from repro_torch.parallel.sharding import NULL_CTX, distribute_tree

    cfg = xlstm3_cfg(heads)
    name = f"xlstm{heads}"
    batch = _batch(w, name)
    params = _params(w, name)
    seen, finite = [], []
    cell = xlstm.mlstm_cell_chunked

    def spy(q, k, v, i_pre, f_pre, cache, chunk):
        seen.append(int(q.shape[2]))
        for t in (q, k, v, i_pre, f_pre):
            if t.requires_grad:
                t.register_hook(lambda g: finite.append(
                    bool(torch.isfinite(g).all())))
        return cell(q, k, v, i_pre, f_pre, cache, chunk)

    def prefill(p, ctx):
        return steps.build_prefill(cfg, ctx, 40)(
            p, {"tokens": batch["tokens"]})[0]

    out = {}
    xlstm.mlstm_cell_chunked = spy
    try:
        for kind, shape, run in (
                ("train", "train_4k", lambda p, ctx: flat(
                    _grads(cfg, p, batch, ctx))),
                ("prefill", "prefill_32k", prefill)):
            ctx1 = make_ctx(cfg, w.mesh22, SHAPES[shape])
            placed = distribute_tree(params, steps.param_shardings(cfg, ctx1),
                                     w.mesh22)
            for tag, p, ctx in (("0", params, NULL_CTX), ("1", placed, ctx1)):
                if tag == "0" and w.rank:  # the unsharded runs: rank 0's
                    continue
                seen.clear()
                mode = CommDebugMode()
                with mode:
                    got = run(p, ctx)
                if kind == "train":
                    out.update({f"g{tag}/{k}": _np(v) for k, v in got.items()})
                else:
                    out["prefill" + tag] = _np(got)
                out[f"{kind}_heads{tag}"] = list(seen)
                if tag == "1":
                    out[f"{kind}_comms"] = w.gather(
                        {str(k).split(".")[-1]: v for k, v in
                         mode.get_comm_counts().items()})
    finally:
        xlstm.mlstm_cell_chunked = cell
    out["finite"] = w.gather(bool(finite) and all(finite))
    return out


def check_uneven_ssm_heads(w):
    """The mLSTM with heads that "model" does not divide, split as GSPMD
    splits them (3 padded to 4, 2 a rank): ``_padded_ssm_heads``."""
    return _padded_ssm_heads(w, 3)


def check_pad_only_ssm_heads(w):
    """One head padded to 2, 1 a rank: the ranks at "model" 1 hold only a
    pad head, and their backward must issue the collectives of the others'
    (``_padded_ssm_heads``)."""
    return _padded_ssm_heads(w, 1)


# the vocab-parallel loss's z-loss weights: none, and ``loss_fn``'s
VPLOSS_Z = (("z0", 0.0), ("z4", 1e-4))


def check_vocab_parallel_loss(w):
    """The cross entropy at (2, 2) on logits split over rows and vocab, in
    f32: the loss, its metrics and the logits' gradient at each
    ``VPLOSS_Z`` (targets ``-1`` and on both edges of each rank's vocab
    shard), the collectives it issues, and the gradient of ``loss_fn``
    for the tied MiniCPM-2B smoke config and the untied StableLM-3B."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.shapes import SHAPES, make_ctx
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import lm
    from repro_torch.models.layers import cross_entropy
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.parallel.sharding import distribute_tree, spmd

    inp = w.inputs("vploss")
    ctx = make_ctx(dense_cfg(), w.mesh22, SHAPES["train_4k"])
    out = {}
    for tag, z in VPLOSS_Z:
        logits = distribute_tensor(
            torch.from_numpy(inp["logits"]), w.mesh22,
            ctx.sharding(("batch", "seq", "vocab_act")),
            src_data_rank=None).requires_grad_(True)
        targets = distribute_tensor(
            torch.from_numpy(inp["targets"]), w.mesh22,
            ctx.sharding(("batch", "seq")), src_data_rank=None)
        with spmd(ctx), dryrun.Collectives() as coll:
            loss, m = cross_entropy(logits, targets, z, ctx)
            g, = torch.autograd.grad(loss, logits)
        out[f"{tag}/records"] = [tuple(r) for r in coll.records]
        out[f"{tag}/grad_local"] = list(g.to_local().shape)
        out[f"{tag}/loss"] = _np(loss)
        out.update({f"{tag}/{k}": _np(v) for k, v in m.items()})
        out[f"{tag}/grad"] = _np(g)
    for name, cfg in (("dense", dense_cfg()), ("untied", untied_cfg())):
        c = make_ctx(cfg, w.mesh22, SHAPES["train_4k"])
        params = tree_map(lambda p: p.requires_grad_(True), distribute_tree(
            _params(w, name), steps.param_shardings(cfg, c), w.mesh22))
        with spmd(c):
            loss, _ = lm.loss_fn(params, _batch(w, name), cfg, ctx=c)
            gs = iter(torch.autograd.grad(loss, tree_leaves(params)))
        out[f"{name}/loss"] = _np(loss)
        out.update({f"{name}/g/{k}": _np(v) for k, v in flat(
            tree_map(lambda p: next(gs), params)).items()})
    return out

