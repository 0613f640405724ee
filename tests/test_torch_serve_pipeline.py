"""The port's async serving pipeline against its sync loop and the JAX
package's pipelines, on the CPU.

  * an async drain through the device prefix store equals the port's sync
    drain bit for bit (tokens, recorded logits, step sequences) and counts
    no blocking host read;
  * the port's async drain gives the JAX async drain's tokens and step
    sequences (``async_depth=2``);
  * admission reordering: the JAX loop's order for the same queue, the
    same fairness age bound, the same validation errors;
  * the async retry path: a prefill row forced to fault is retried cold
    under a new epoch, the landings dispatched before the retry are
    dropped, and its prefix chain is evicted as poisoned;
  * ``coalesce_states`` and ``write_carry_slot`` against JAX's;
  * the launcher with ``--pipeline async --prefix-cache`` on the CPU;
  * ``chip_smoke.py``'s checks of the prefix phase on canned arms: one
    changed token and one extra host read each fail.

The small DEQ config of ``tests/test_torch_serving.py`` (blocks scaled by
0.3, f32); the JAX loop jits its own programs.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.implicit import coalesce_states as j_coalesce  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel.sharding import ShardCtx  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro.runtime.serving import ServeLoop as JServeLoop  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.solvers import STATUS_DIVERGED  # noqa: E402
from repro_torch.implicit import (  # noqa: E402
    coalesce_states,
    solvers as implicit_solvers,
    write_carry_rows,
    write_carry_slot,
)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.runtime.serving import Request, ServeLoop  # noqa: E402

CTX = ShardCtx.for_mesh(None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _overlap_prompts(n=6, base_len=8, tail_len=4, vocab=128, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(2, vocab, size=base_len).tolist()
    return [base + rng.integers(2, vocab, size=tail_len).tolist()
            for _ in range(n)]


LOOP_KW = dict(slots=3, max_len=64, eos_id=-1, prefix_cache=True,
               prefix_cache_slots=16, record=True)


def _drain(params, cfg, prompts, max_new=3, **kw):
    loop = ServeLoop(params, cfg, **{**LOOP_KW, **kw})
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    loop.drain(reqs)
    return loop, reqs


def _host_syncs() -> float:
    return sum(m["value"]
               for m in tmetrics.default_registry().snapshot()["metrics"]
               if m["name"] == "host_syncs_total")


@pytest.mark.parametrize("max_age", [None, 1])
def test_async_drain_is_bit_for_bit_the_sync_drain(setup, max_age):
    """Also with the carry staleness bound, which the async tick applies
    on the device (and counts at the landing)."""
    _, tcfg, _, tparams = setup
    prompts = _overlap_prompts()
    loop_s, reqs_s = _drain(tparams, tcfg, prompts, pipeline="sync",
                            carry_max_age=max_age)
    before = _host_syncs()
    loop_a, reqs_a = _drain(tparams, tcfg, prompts, pipeline="async",
                            async_depth=2, carry_max_age=max_age)
    assert (loop_a.carries.evictions_by_reason
            == loop_s.carries.evictions_by_reason)
    assert (loop_a.carries.evictions_by_reason["stale"] > 0) == bool(max_age)
    assert _host_syncs() - before == 0
    assert [r.out for r in reqs_a] == [r.out for r in reqs_s]
    assert all(len(r.out) == 3 and r.error is None for r in reqs_a)
    assert loop_a.recorded_steps == loop_s.recorded_steps
    assert set(loop_a.recorded_logits) == set(loop_s.recorded_logits)
    for uid, want in loop_s.recorded_logits.items():
        got = loop_a.recorded_logits[uid]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert loop_a.prefix_store.stats()["hits"] >= 1
    assert loop_a.saved_iters == loop_s.saved_iters > 0
    assert loop_a.prefill_iters == loop_s.prefill_iters
    # every solve is logged, the async ones with their statuses once landed
    assert [(s["phase"], s["rows"], s["steps"], s["status"])
            for s in loop_a.solve_log] == [
        (s["phase"], s["rows"], s["steps"], s["status"])
        for s in loop_s.solve_log]
    assert not loop_a._inflight


def test_async_drain_matches_jax_async(setup):
    jcfg, tcfg, jparams, tparams = setup
    prompts = _overlap_prompts()
    jloop = JServeLoop(jparams, jcfg, CTX, pipeline="async", async_depth=2,
                       **LOOP_KW)
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=3)
             for i, p in enumerate(prompts)]
    jloop.drain(jreqs)
    tloop, treqs = _drain(tparams, tcfg, prompts, pipeline="async",
                          async_depth=2)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tloop.recorded_steps == jloop.recorded_steps
    assert tloop.prefix_store.stats() == jloop.prefix_store.stats()
    assert tloop.saved_iters == jloop.saved_iters
    assert tloop.prefill_calls == jloop.prefill_calls


# ---------------------------------------------------------------------------
# admission reordering
# ---------------------------------------------------------------------------


def _policy_loops(setup, **kw):
    jcfg, tcfg, jparams, tparams = setup
    base = dict(slots=2, max_len=32, eos_id=-1, prefix_cache=True,
                prefix_cache_slots=8, **kw)
    return (JServeLoop(jparams, jcfg, CTX, **base),
            ServeLoop(tparams, tcfg, **base))


def _queue(reqcls, specs):
    out = []
    for uid, prompt, rounds in specs:
        r = reqcls(uid=uid, prompt=list(prompt), max_new_tokens=1)
        r.wait_rounds = rounds
        out.append(r)
    return out


@pytest.mark.parametrize("pipeline", ["sync", "async"])
@pytest.mark.parametrize("reorder,bound", [(False, 8), (True, 8), (True, 2)])
def test_admission_order_matches_jax(setup, pipeline, reorder, bound):
    jloop, tloop = _policy_loops(setup, pipeline=pipeline, reorder=reorder,
                                 reorder_age_bound=bound)
    base_a, base_b = [3, 5, 7, 11], [2, 4, 6, 8]
    specs = [(0, base_a + [50, 51], 0), (1, base_b + [60, 61], 0),
             (2, [120, 121, 122, 123, 124, 125], 2), (3, base_a + [52], 0),
             (4, base_b + [62, 63], 1), (5, base_a + [53, 54], 0),
             (6, [9, 9, 9], 0)]
    if pipeline == "async":
        # published prefixes group by store key
        for loop in (jloop, tloop):
            loop.prefix_store.plan_publish(base_b + [60])
    jloop.pending = _queue(JRequest, specs)
    tloop.pending = _queue(Request, specs)
    for n in (3, 2, 5):
        jt, tt = jloop._admission_order(n), tloop._admission_order(n)
        assert [r.uid for r in tt] == [r.uid for r in jt]
        assert [r.uid for r in tloop.pending] == [r.uid for r in
                                                  jloop.pending]
        assert [r.wait_rounds for r in tloop.pending] == [
            r.wait_rounds for r in jloop.pending]


@pytest.mark.parametrize("kw", [dict(pipeline="batch"),
                                dict(async_depth=0),
                                dict(reorder=True, reorder_age_bound=0)])
def test_serve_loop_validation_matches_jax(setup, kw):
    jcfg, tcfg, jparams, tparams = setup
    with pytest.raises(ValueError) as jerr:
        JServeLoop(jparams, jcfg, CTX, **kw)
    with pytest.raises(ValueError) as terr:
        ServeLoop(tparams, tcfg, **kw)
    assert str(terr.value) == str(jerr.value)


def test_reorder_drain_gives_the_sync_tokens(setup):
    _, tcfg, _, tparams = setup
    fam_a = _overlap_prompts(n=3, seed=1)
    fam_b = _overlap_prompts(n=3, seed=2)
    loner = np.random.default_rng(11).integers(2, 128, size=12).tolist()
    prompts = [fam_a[0], fam_b[0], loner, fam_a[1], fam_b[1], fam_a[2],
               fam_b[2]]
    _, reqs_s = _drain(tparams, tcfg, prompts, pipeline="sync")
    _, reqs_a = _drain(tparams, tcfg, prompts, pipeline="async",
                       reorder=True, reorder_age_bound=2)
    assert [r.out for r in reqs_a] == [r.out for r in reqs_s]
    assert all(len(r.out) == 3 for r in reqs_a)


# ---------------------------------------------------------------------------
# the async retry path
# ---------------------------------------------------------------------------


def test_async_retry_bumps_the_epoch_and_drops_stale_landings(setup):
    """Row 1 of the first prefill wave is made to report DIVERGED once: its
    token is dropped, its prompt's prefix chain is evicted as poisoned, and
    it is retried cold under epoch 1; the tick dispatched before the retry
    lands stale for that slot and is dropped, and the request still ends
    with exactly its tokens, as in an unfaulted drain."""
    _, tcfg, _, tparams = setup
    prompts = _overlap_prompts(n=4)
    _, clean = _drain(tparams, tcfg, prompts, pipeline="async",
                      prefix_cache=False)
    orig = implicit_solvers.broyden_solve
    faults = []

    def faulty(g, z0, cfg, **kw):
        res = orig(g, z0, cfg, **kw)
        if z0.shape[1] > 1 and not faults:
            res.status[1] = STATUS_DIVERGED
            faults.append(1)
        return res

    stale = []
    orig_land = ServeLoop._land_tick

    def land_tick(self, e, out, t_land, epochs):
        stale.extend(r.uid for s, r in e.group if epochs[s] != r.epoch)
        return orig_land(self, e, out, t_land, epochs)

    reg = tmetrics.default_registry()
    retries = reg.counter("serve_request_retries_total").value
    with mock.patch.object(implicit_solvers, "broyden_solve", faulty), \
            mock.patch.object(ServeLoop, "_land_tick", land_tick):
        loop = ServeLoop(tparams, tcfg, **{**LOOP_KW, "record": False},
                         pipeline="async", async_depth=2)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
                for i, p in enumerate(prompts)]
        loop.drain(reqs)
    assert faults
    r1 = reqs[1]
    assert r1.retried and r1.epoch == 1 and r1.error is None
    assert stale and set(stale) == {1}
    assert reg.counter("serve_request_retries_total").value == retries + 1
    assert reg.counter("serve_request_faults_total",
                       {"status": "diverged"}).value >= 1
    assert loop.prefix_store.evictions_by_reason["poisoned"] >= 1
    assert [len(r.out) for r in reqs] == [3] * 4
    assert r1.out == clean[1].out


# ---------------------------------------------------------------------------
# engine helpers
# ---------------------------------------------------------------------------


def test_coalesce_states_and_write_carry_slot_match_jax(setup):
    rng = np.random.default_rng(0)
    states = [{"a": rng.standard_normal((2, 3)).astype(np.float32),
               "b": (rng.standard_normal(4).astype(np.float32),)}
              for _ in range(3)]
    jb = j_coalesce([jax.tree_util.tree_map(jnp.asarray, s) for s in states],
                    slots=5)
    tb = coalesce_states([{"a": torch.from_numpy(s["a"]),
                           "b": (torch.from_numpy(s["b"][0]),)}
                          for s in states], slots=5)
    np.testing.assert_array_equal(tb.z0["a"].numpy(), np.asarray(jb.z0["a"]))
    np.testing.assert_array_equal(tb.z0["b"][0].numpy(),
                                  np.asarray(jb.z0["b"][0]))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    back = tb.unbatch(tb.z0)
    assert len(back) == 3
    np.testing.assert_array_equal(back[2]["a"].numpy(), states[2]["a"])
    with pytest.raises(ValueError):
        coalesce_states([states[0]] * 3, slots=2)

    _, tcfg, _, _ = setup
    src = tlm.deq_solve_carry(tcfg, 2, 1, "cpu")
    src.z.normal_()
    src.lowrank.count.fill_(3)
    one = write_carry_slot(tlm.deq_solve_carry(tcfg, 3, 1, "cpu"), src, 2, 1)
    many = write_carry_rows(tlm.deq_solve_carry(tcfg, 3, 1, "cpu"), src,
                            [2], [1])
    assert torch.equal(one.z, many.z) and torch.equal(one.z[2], src.z[1])
    assert one.lowrank.count.tolist() == [0, 0, 3]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_async_prefix_cache_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--deq", "--device", "cpu", "--requests", "4", "--slots", "2",
         "--max-new-tokens", "3", "--pipeline", "async", "--prefix-cache",
         "--shared-prefix", "8"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 4 requests, 12 tokens" in out.stdout
    assert "prefix cache: " in out.stdout
    assert "async pipeline: 0 blocking host syncs" in out.stdout


def _bridge(snapshot) -> dict:
    return {(m["name"], tuple(sorted(m["labels"].items()))):
            m.get("value", m.get("count"))
            for m in snapshot["metrics"]
            if m["name"].startswith(("solve", "carry_age"))}


def test_async_drain_lands_the_metrics_bridge_at_its_landings(setup):
    """With metrics on, the async drain makes no read for the bridge: each
    entry carries the pending values to the host with its outputs and lands
    them with it, so nothing is pending after the drain, and the bridge
    holds what it holds after the same sync drain."""
    _, tcfg, _, tparams = setup
    reg = tmetrics.default_registry()
    tmetrics.set_enabled(True)
    try:
        reg.reset()
        _drain(tparams, tcfg, _overlap_prompts(), pipeline="sync")
        want = _bridge(reg.snapshot())
        reg.reset()
        _drain(tparams, tcfg, _overlap_prompts(), pipeline="async")
        assert not reg._pending
        got = _bridge(reg.snapshot())
    finally:
        tmetrics.set_enabled(False)
    assert ("solves_total", (("phase", "serve"),)) in want
    assert got == want


def test_launcher_traces_the_async_drain(tmp_path):
    """The default pipeline's spans: ``admit``, ``prefill_dispatch`` and
    ``decode_dispatch`` inside ``drain`` (no ``serve_tick``; on the CPU
    every entry is ready when queued, so no ``pipeline_wait``), and the
    in-flight gauge in the Prometheus file."""
    import json

    from repro_torch.launch import serve as tserve
    from repro_torch.obs import tracing
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    try:
        tserve.main(["--smoke", "--deq", "--device", "cpu", "--requests",
                     "3", "--slots", "2", "--max-new-tokens", "3",
                     "--trace-out", str(trace), "--metrics-prom-out",
                     str(prom)])
    finally:
        tracing.set_enabled(False)
        tracing.clear()
        tmetrics.set_enabled(False)
    ev = json.loads(trace.read_text())["traceEvents"]
    spans = {e["name"] for e in ev if e["ph"] == "B"}
    assert spans == {"drain", "admit", "prefill_dispatch", "decode_dispatch"}
    assert "serve_pipeline_inflight" in prom.read_text()


# ---------------------------------------------------------------------------
# chip_smoke.py's checks of the prefix phase, on canned arms
# ---------------------------------------------------------------------------


def _canned_arms() -> dict:
    toks = [[5 + i] * 4 for i in range(3)]
    steps = {i: [6.0, 2.0, 2.0, 2.0] for i in range(3)}
    launched = {k: (7 if k in chip_smoke.SERVE_PATH else 0)
                for k in chip_smoke.KERNELS}
    arm = dict(tokens=toks, errors=[None] * 3, max_new=4, eos=1,
               steps=steps, hits=4, saved_iters=4.0, prefill_iters=8.0,
               launches=launched, host_syncs={},
               prefill_solves=[{"broyden_step": 2, "counts": [0, 9]}])
    cold = dict(arm, hits=0, saved_iters=0.0, prefill_iters=18.0, steps={})
    return {"a_sync": cold, "b_sync_prefix": copy.deepcopy(arm),
            "c_async_prefix": copy.deepcopy(arm),
            "d_async_prefix_reorder": copy.deepcopy(arm)}


def test_prefix_arm_check_passes_and_fails_on_one_changed_token():
    arms = _canned_arms()
    chip_smoke.check_prefix_arms(arms)
    for name in chip_smoke.ASYNC_ARMS:
        bad = _canned_arms()
        bad[name]["tokens"][1][2] += 1
        with pytest.raises(AssertionError, match="tokens"):
            chip_smoke.check_prefix_arms(bad)


@pytest.mark.parametrize("mutate,match", [
    (lambda a: a["c_async_prefix"]["steps"][0].__setitem__(1, 3.0),
     "step sequences"),
    (lambda a: a["b_sync_prefix"].__setitem__("saved_iters", 0.0), "saved"),
    (lambda a: a["c_async_prefix"].__setitem__("prefill_iters", 18.0),
     "prefill iterations"),
    (lambda a: a["c_async_prefix"]["launches"].__setitem__("rmsnorm", 0),
     "not launched"),
    (lambda a: a["d_async_prefix_reorder"]["launches"].__setitem__(
        "qn_apply", 1), "off-path"),
    (lambda a: a["c_async_prefix"].__setitem__(
        "host_syncs", {"tick_land": 1.0}), "blocking reads"),
    (lambda a: a["c_async_prefix"].__setitem__(
        "prefill_solves", [{"broyden_step": 2, "counts": [0, 0]}]),
     "warm ring"),
    (lambda a: a["b_sync_prefix"]["errors"].__setitem__(0, "diverged"),
     "error"),
])
def test_prefix_arm_check_fails_on_each_broken_arm(mutate, match):
    arms = _canned_arms()
    mutate(arms)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_prefix_arms(arms)


def test_async_sync_accounting_fails_on_one_extra_read():
    log = [{"phase": "prefill", "steps": 6.0}, {"phase": "decode",
                                                "steps": 12.0},
           {"phase": "prefill", "steps": 0.0}]
    want = chip_smoke.async_expected_syncs(log, 12)
    assert want == (2 * 6 + 1) + 24 + 1 + 1
    syncs = (["Event.synchronize"]
             + ["implicit at src/repro_torch/core/solvers.py:406"] * 20
             + ["implicit at src/repro_torch/core/solvers.py:442"] * 18)
    assert sum(chip_smoke.check_syncs("canned", syncs, want).values()) == 39
    with pytest.raises(AssertionError, match="host waits"):
        chip_smoke.check_syncs(
            "canned", syncs + ["implicit at src/repro_torch/runtime/"
                               "serving.py:700"], want)
