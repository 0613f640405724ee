"""The port's cross-request prefix caches against the JAX package's.

On the CPU, with the same numpy inputs fed to both packages:

  * index and store: one sequence of publish / lookup / release / peek /
    evict calls to JAX's and the port's ``PrefixCarryIndex`` and
    ``DevicePrefixStore`` gives equal matches, chosen rows, ``stats()`` and
    eviction counts by reason (also on each registry), plus port-only
    cases for the scratch row, LRU eviction that skips leased entries, and
    ``max_age``;
  * carry assembly: ``prefix_seed_carry``, ``prefix_gather_carry`` and
    ``prefix_store_scatter`` against JAX's;
  * a prefill seeded from a prefix (a full miss, bit for bit the port's
    own cold prefill; an exact hit; a partial hit) against JAX's;
  * the sync loop with the prefix cache against JAX's sync loop over an
    overlapping-prefix stream.

The model tests use the small DEQ config of ``tests/test_torch_serving.py``
(weight-tied blocks scaled by 0.3, f32); the JAX side is jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.implicit import DevicePrefixStore as JStore
from repro.implicit import PrefixCarryIndex as JIndex
from repro.implicit import prefix_hashes as j_prefix_hashes
from repro.implicit import prefix_store_scatter as j_scatter
from repro.models import lm as jlm
from repro.obs import metrics as jmetrics
from repro.parallel.sharding import ShardCtx
from repro.runtime.serving import Request as JRequest
from repro.runtime.serving import ServeLoop as JServeLoop
from repro_torch.configs.registry import smoke_config
from repro_torch.core.lowrank import LowRank
from repro_torch.core.solvers import SolveCarry
from repro_torch.implicit import (
    DevicePrefixStore,
    PrefixCarryIndex,
    prefix_hashes,
    prefix_store_scatter,
)
from repro_torch.models import lm as tlm
from repro_torch.obs import metrics as tmetrics
from repro_torch.runtime.serving import Request, ServeLoop

CTX = ShardCtx.for_mesh(None)
TOL = dict(rtol=1e-4, atol=1e-4)


def _small(cfg):
    return dataclasses.replace(
        cfg, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, dtype="float32",
        deq=dataclasses.replace(cfg.deq, max_steps=40, tol=1e-4, memory=16))


@pytest.fixture(scope="module")
def setup():
    jcfg = _small(jax_smoke_config("minicpm-2b", deq=True))
    tcfg = _small(smoke_config("minicpm-2b", deq=True))
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params["deq_blocks"] = jax.tree_util.tree_map(
        lambda a: a * 0.3, params["deq_blocks"])
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, tlm.params_from_jax(np_params, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _evictions(registry_snapshot) -> dict:
    return {m["labels"]["reason"]: m["value"]
            for m in registry_snapshot["metrics"]
            if m["name"] == "prefix_cache_evictions_total"}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


# ---------------------------------------------------------------------------
# index and store: operation by operation against JAX
# ---------------------------------------------------------------------------


def _ops(seed=5, n=40):
    """A stream of cache operations over prompts sharing prefixes."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(2, 50, size=6).tolist() for _ in range(3)]
    prompts = [b + rng.integers(2, 50, size=int(k)).tolist()
               for b in bases for k in (0, 2, 3)]
    kinds = ["publish", "lookup", "lookup", "peek", "release", "evict"]
    return [(kinds[int(rng.integers(0, 5 if i % 9 else 6))],
             prompts[int(rng.integers(0, len(prompts)))]) for i in range(n)]


def _snap(tokens, d=3, m=2):
    n = len(tokens)
    z = np.arange(n * d, dtype=np.float32).reshape(n, d) + sum(tokens)
    u = np.arange(m * n * d, dtype=np.float32).reshape(m, n, d) * 0.5
    return z, u, -u, len(tokens) % 4


@pytest.mark.parametrize("max_age", [None, 6])
def test_prefix_index_matches_jax_operation_by_operation(max_age):
    ji = JIndex(slots=7, block=2, max_age=max_age)
    ti = PrefixCarryIndex(slots=7, block=2, max_age=max_age)
    jleases, tleases = [], []
    jbefore = _evictions(jmetrics.default_registry().snapshot())
    tbefore = _evictions(tmetrics.default_registry().snapshot())
    for op, toks in _ops():
        if op == "publish":
            z, u, v, c = _snap(toks)
            assert ti.publish(toks, torch.from_numpy(z), torch.from_numpy(u),
                              torch.from_numpy(v), c) == \
                ji.publish(toks, z, u, v, c)
        elif op in ("lookup", "peek"):
            jm, tm = ji.lookup(toks), ti.lookup(toks)
            assert (jm is None) == (tm is None)
            if jm is not None:
                assert (tm.entry.tokens, tm.length, tm.exact) == \
                    (jm.entry.tokens, jm.length, jm.exact)
                np.testing.assert_array_equal(_np(tm.entry.z), jm.entry.z)
                assert tm.entry.count == jm.entry.count
                if jm.entry.u is not None:
                    np.testing.assert_array_equal(_np(tm.entry.u), jm.entry.u)
                jleases.append(jm)
                tleases.append(tm)
        elif op == "release" and jleases:
            ji.release(jleases.pop(0))
            ti.release(tleases.pop(0))
        elif op == "evict":
            assert ti.evict_poisoned(toks) == ji.evict_poisoned(toks)
        assert ti.stats() == ji.stats()
        assert ti.tokens_held() == ji.tokens_held()
    assert sum(ti.evictions_by_reason.values()) > 0
    assert _delta(_evictions(tmetrics.default_registry().snapshot()),
                  tbefore) == _delta(_evictions(
                      jmetrics.default_registry().snapshot()), jbefore)


@pytest.mark.parametrize("max_age", [None, 5])
def test_device_store_matches_jax_operation_by_operation(max_age):
    js = JStore(4, 16, feat=3, memory=2, block=2, max_age=max_age)
    ts = DevicePrefixStore(4, 16, feat=3, memory=2, block=2,
                           max_age=max_age)
    jbefore = _evictions(jmetrics.default_registry().snapshot())
    tbefore = _evictions(tmetrics.default_registry().snapshot())
    for op, toks in _ops(seed=9, n=50):
        if op == "publish":
            assert ts.plan_publish(toks) == js.plan_publish(toks)
        elif op == "lookup":
            assert ts.lookup(toks) == js.lookup(toks)
        elif op == "peek":
            assert ts.peek(toks) == js.peek(toks)
        elif op == "evict":
            assert ts.evict_poisoned(toks) == js.evict_poisoned(toks)
        assert ts.stats() == js.stats()
        assert sorted(ts._free) == sorted(js._free)
    assert sum(ts.evictions_by_reason.values()) > 0
    assert _delta(_evictions(tmetrics.default_registry().snapshot()),
                  tbefore) == _delta(_evictions(
                      jmetrics.default_registry().snapshot()), jbefore)


def test_prefix_hashes_match_jax():
    toks = [5, 9, 2, 7, 7, 3, 127, 0]
    assert prefix_hashes(toks) == j_prefix_hashes(toks)


def test_store_scratch_row_takes_skipped_publishes():
    st = DevicePrefixStore(2, 8, feat=4, memory=2, block=2)
    assert st.scratch == 2 and st.z.shape == (3, 8, 4)
    assert st.u.shape == (2, 3, 8, 4) and st.u.dtype == torch.bfloat16
    slot = st.plan_publish([3, 5, 7])
    assert slot != st.scratch
    assert st.plan_publish([3, 5, 7]) == st.scratch      # dedup refresh
    assert st.plan_publish([]) == st.scratch             # empty prompt
    assert st.plan_publish(list(range(9))) == st.scratch  # longer than seq
    # a scatter to the scratch row leaves every stored row alone
    carry = SolveCarry(
        z=torch.ones(2, 3, 4), warm=torch.ones(2, dtype=torch.bool),
        age=torch.zeros(2, dtype=torch.int32),
        lowrank=LowRank(alpha=torch.ones(()),
                            u=torch.ones(2, 2, 3, 4),
                            v=torch.ones(2, 2, 3, 4),
                            count=torch.tensor([2, 2], dtype=torch.int32)))
    prefix_store_scatter(st.arrays, carry,
                         torch.tensor([st.scratch, st.scratch]))
    assert float(st.z[:2].abs().sum()) == 0.0
    assert int(st.count[st.scratch]) == 2
    assert DevicePrefixStore(0, 8, 4, 2).plan_publish([1, 2]) == 0


def test_index_lru_eviction_skips_leased_entries():
    idx = PrefixCarryIndex(slots=2, block=8)
    z = torch.zeros(3, 4)
    idx.publish([1, 2, 3], z)
    lease = idx.lookup([1, 2, 3])
    idx.publish([4, 5, 6], z)
    idx.publish([7, 8, 9], z)
    assert idx.evictions_by_reason["lru"] >= 1
    again = idx.lookup([1, 2, 3])
    assert again is not None                   # survived while leased
    assert idx.lookup([4, 5, 6]) is None       # the unleased LRU victim
    idx.release(again)
    idx.release(lease)
    with pytest.raises(ValueError):  # one release per lease
        idx.release(lease)


def test_max_age_sweeps_index_and_store():
    idx = PrefixCarryIndex(slots=8, block=8, max_age=2)
    st = DevicePrefixStore(4, 8, feat=4, memory=2, block=8, max_age=2)
    idx.publish([1, 2, 3], torch.zeros(3, 4))
    st.plan_publish([1, 2, 3])
    for _ in range(4):
        assert idx.lookup([9, 9, 9]) is None
        assert st.lookup([9, 9, 9]) is None
    assert len(idx) == 0 and len(st) == 0
    assert idx.evictions_by_reason["stale"] == 1
    assert st.evictions_by_reason["stale"] == 1
    assert sorted(st._free) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        PrefixCarryIndex(4, max_age=0)
    with pytest.raises(ValueError):
        DevicePrefixStore(4, 0, 4, 2)


# ---------------------------------------------------------------------------
# carry assembly
# ---------------------------------------------------------------------------


def _ring_snap(rng, m, length, d, count):
    return (rng.standard_normal((length, d)).astype(np.float32),
            rng.standard_normal((m, length, d)).astype(np.float32),
            rng.standard_normal((m, length, d)).astype(np.float32), count)


def test_prefix_seed_carry_matches_jax(setup):
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(3)
    m, d = jcfg.deq.memory, jcfg.d_model
    # a miss, a ring of 5, an iterate-only seed, a wrapped ring (count > m)
    snaps = [None, _ring_snap(rng, m, 4, d, 5),
             (rng.standard_normal((2, d)).astype(np.float32), None, None, 0),
             _ring_snap(rng, m, 6, d, m + 3)]
    jc, jpl = jlm.prefix_seed_carry(jcfg, 4, 6, snaps)
    tc, tpl = tlm.prefix_seed_carry(
        tcfg, 4, 6, [None if s is None else tuple(
            x if x is None or isinstance(x, int) else torch.from_numpy(x)
            for x in s) for s in snaps], "cpu")
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    np.testing.assert_array_equal(tc.warm.numpy(), np.asarray(jc.warm))
    np.testing.assert_array_equal(_np(tc.z), _np(jc.z))
    np.testing.assert_array_equal(_np(tc.lowrank.u), _np(jc.lowrank.u))
    np.testing.assert_array_equal(_np(tc.lowrank.v), _np(jc.lowrank.v))
    assert tc.lowrank.u.dtype == torch.bfloat16  # the config's ring dtype
    # the live ring slots agree; the wrapped row keeps the donor's count
    # (the next pair overwrites its oldest), where JAX's host assembly
    # clamps it to m and its device gather does not
    np.testing.assert_array_equal(tc.lowrank._valid_mask().numpy(),
                                  np.asarray(jc.lowrank._valid_mask()))
    assert tc.lowrank.count.tolist() == [0, 5, 0, m + 3]
    assert np.asarray(jc.lowrank.count).tolist() == [0, 5, 0, m]
    with pytest.raises(ValueError):
        tlm.prefix_seed_carry(tcfg, 1, 2, [snaps[1]], "cpu")
    with pytest.raises(ValueError):
        tlm.prefix_seed_carry(tcfg, 2, 6, [None], "cpu")


def _store_arrays(rng, cfg, slots=5, seq=8):
    m, d = cfg.deq.memory, cfg.d_model
    z = rng.standard_normal((slots + 1, seq, d)).astype(np.float32)
    u = rng.standard_normal((m, slots + 1, seq, d)).astype(np.float32)
    v = rng.standard_normal((m, slots + 1, seq, d)).astype(np.float32)
    c = np.array([3, m + 2, 0, 7, 1, 0], np.int32)[:slots + 1]
    return z, u, v, c


def test_prefix_gather_carry_and_scatter_match_jax(setup):
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(4)
    arrays = _store_arrays(rng, jcfg)
    slot_ids = np.array([1, 5, 3], np.int32)
    plen = np.array([6, 0, 3], np.int32)
    jc, _ = jlm.prefix_gather_carry(
        jcfg, 3, 6, tuple(jnp.asarray(a) for a in arrays),
        jnp.asarray(slot_ids), jnp.asarray(plen))
    t_arrays = tuple(torch.from_numpy(a.copy()) for a in arrays)
    tc, _ = tlm.prefix_gather_carry(tcfg, 3, 6, t_arrays,
                                    torch.from_numpy(slot_ids),
                                    torch.from_numpy(plen))
    for got, want in ((tc.z, jc.z), (tc.lowrank.u, jc.lowrank.u),
                      (tc.lowrank.v, jc.lowrank.v)):
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(tc.lowrank.count.numpy(),
                                  np.asarray(jc.lowrank.count))
    np.testing.assert_array_equal(tc.warm.numpy(), np.asarray(jc.warm))

    # publish-back: the port writes in place what JAX returns
    pub = np.array([2, 0, 5], np.int32)
    j_new = j_scatter(tuple(jnp.asarray(a) for a in arrays), jc,
                      jnp.asarray(pub))
    prefix_store_scatter(t_arrays, tc, torch.from_numpy(pub))
    for got, want in zip(t_arrays, j_new):
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# a prefill seeded from a prefix
# ---------------------------------------------------------------------------


def _jprefill(jcfg, jparams, toks, snaps):
    b, s = toks.shape
    pc, pl = jlm.prefix_seed_carry(jcfg, b, s, snaps)
    fn = jax.jit(lambda p, t, c, l: jlm.prefill(
        p, {"tokens": t}, jcfg, CTX, 32, prefix_carry=c, prefix_len=l,
        return_status=True))
    logits, _, _, pf, steps, status = fn(jparams, jnp.asarray(toks), pc, pl)
    return logits, pf, float(steps), np.asarray(status)


def _tprefill(tcfg, tparams, toks, snaps):
    b, s = toks.shape
    pc, pl = tlm.prefix_seed_carry(tcfg, b, s, snaps, "cpu")
    logits, _, _, pf, steps, status = tlm.prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, tcfg, 32,
        prefix_carry=pc, prefix_len=pl, return_status=True)
    return logits, pf, steps, status.numpy()


def _row_snap(pf, row, length):
    lr = pf.lowrank
    return (np.array(_np(pf.z[row])[:length]),
            np.array(_np(lr.u[:, row])[:, :length]),
            np.array(_np(lr.v[:, row])[:, :length]), int(lr.count[row]))


def _torch_snap(snap):
    return None if snap is None else (
        torch.from_numpy(snap[0]), torch.from_numpy(snap[1]),
        torch.from_numpy(snap[2]), snap[3])


def test_seeded_prefill_matches_jax(setup):
    """(i) a full miss: JAX's steps and statuses, logits and carry within
    TOL, and bit for bit the port's own cold prefill; (ii) an exact hit
    and (iii) a partial hit, seeded with JAX's converged carry: JAX's
    steps (fewer than cold) and statuses, logits and carry within TOL."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    toks = rng.integers(2, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, jpf, jsteps, jst = _jprefill(jcfg, jparams, toks, [None, None])
    tl, tpf, tsteps, tst = _tprefill(tcfg, tparams, toks, [None, None])
    assert tsteps == jsteps and tsteps > 2
    np.testing.assert_array_equal(tst, jst)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tpf.z), _np(jpf.z), **TOL)
    cold, _, _ = tlm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                             tcfg, 32)
    assert torch.equal(tl, cold)

    # (ii) row 0's prompt again, seeded with its whole carry; (iii) a
    # prompt sharing its first 8 tokens, seeded with that prefix
    snap_full = _row_snap(jpf, 0, 12)
    snap_part = _row_snap(jpf, 0, 8)
    assert snap_full[3] <= jcfg.deq.memory
    partial = toks[1:].copy()
    partial[0, :8] = toks[0, :8]
    for prompt, snap, exact in ((toks[:1], snap_full, True),
                                (partial, snap_part, False)):
        jl2, jpf2, js2, jst2 = _jprefill(jcfg, jparams, prompt, [snap])
        tl2, tpf2, ts2, tst2 = _tprefill(tcfg, tparams, prompt,
                                         [_torch_snap(snap)])
        assert ts2 == js2 < tsteps
        assert (ts2 > 0) != exact  # an exact hit starts at its fixed point
        np.testing.assert_array_equal(tst2, jst2)
        assert (tst2 == 0).all()
        np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL)
        np.testing.assert_allclose(_np(tpf2.z), _np(jpf2.z), **TOL)


# ---------------------------------------------------------------------------
# the sync loop with the prefix cache
# ---------------------------------------------------------------------------


def overlap_prompts(n=6, base_len=8, tail_len=4, vocab=128, seed=7):
    """An overlapping-prefix stream: one shared base, random tails, and
    the first prompt sent twice (an exact hit)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(2, vocab, size=base_len).tolist()
    p0 = base + rng.integers(2, vocab, size=tail_len).tolist()
    out = [p0, list(p0)]
    while len(out) < n:
        out.append(base + rng.integers(2, vocab, size=tail_len).tolist())
    return out


def _prefix_metrics(snapshot) -> dict:
    out = {}
    for m in snapshot["metrics"]:
        if m["name"].startswith("prefix_cache_"):
            key = (m["name"], tuple(sorted(m["labels"].items())))
            out[key] = m.get("value", m.get("count"))
    return out


def test_sync_loop_with_prefix_cache_matches_jax(setup):
    jcfg, tcfg, jparams, tparams = setup
    prompts = overlap_prompts()
    kw = dict(slots=2, max_len=32, eos_id=-1, pipeline="sync", record=True,
              prefix_cache=True, prefix_cache_slots=16)
    jreg, treg = jmetrics.default_registry(), tmetrics.default_registry()
    jreg.reset()
    treg.reset()
    jloop = JServeLoop(jparams, jcfg, CTX, **kw)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    jloop.drain(jreqs)
    tloop = ServeLoop(tparams, tcfg, **kw)
    treqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    tloop.drain(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 3 and r.error is None for r in treqs)
    assert tloop.recorded_steps == jloop.recorded_steps
    assert tloop.prefill_calls == jloop.prefill_calls
    assert tloop.prefill_iters == jloop.prefill_iters
    assert tloop.saved_iters == jloop.saved_iters > 0
    assert tloop.prefix.stats() == jloop.prefix.stats()
    assert tloop.prefix.stats()["hits"] >= 2
    tm, jm = _prefix_metrics(treg.snapshot()), _prefix_metrics(
        jreg.snapshot())
    assert tm == jm
    assert ("prefix_cache_saved_iters", ()) in tm
    for uid, logits_j in jloop.recorded_logits.items():
        for a, b in zip(tloop.recorded_logits[uid], logits_j):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **TOL)
