"""The port's span tracer, metrics bridge and Prometheus exporter against
the JAX package's.

  * the Chrome-trace schema and nesting (as ``tests/test_obs.py`` holds the
    JAX recorder), silence when disabled, and the phase marks of a
    differentiable fixed point and of a train step;
  * ``to_prom()`` of the same counters, gauges and histograms (labels to
    escape, a histogram without a ``+Inf`` bucket) equal to the JAX
    registry's text, the atomic ``write_prom``, ``PromFlusher`` and
    ``emit_scalar``, and the trainer's count of rejected updates, landed
    from its one host read per interval;
  * the launchers end to end on the CPU with ``--trace-out`` and
    ``--metrics-prom-out``, for every forward solver;
  * the bridge (``record_solve``, ``record_backward``, ``emit_scalar``):
    switched off, a train step and a drain reach none of it; switched on,
    the same smoke train steps and drain as the JAX package's give the same
    metric names and labels (forward, backward and serve solve records, the
    residual-tape series) and the same counts of solves and iterations,
    landed at the trainer's one host read per interval without a read of
    their own; a series' Prometheus text equals the reference's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticTokenDataset as JDataset
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.obs import metrics as jmetrics
from repro.optim import optimizers as jopt
from repro.parallel.sharding import ShardCtx
from repro.runtime.serving import Request as JRequest
from repro.runtime.serving import ServeLoop as JServeLoop
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import make_lm_batch_iterator
from repro_torch.implicit import ImplicitConfig, implicit_fixed_point
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.runtime.serving import Request, ServeLoop
from repro_torch.runtime.trainer import Trainer


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with the switches off and an empty
    recorder: the off default must hold for the rest of the suite."""
    obs_metrics.set_enabled(False)
    obs_tracing.set_enabled(False)
    obs_tracing.clear()
    yield
    obs_metrics.set_enabled(False)
    obs_tracing.set_enabled(False)
    obs_tracing.clear()


def _check_schema(trace: dict) -> list[dict]:
    json.dumps(trace)
    ev = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    for e in ev:
        assert "name" in e and "ph" in e and "pid" in e and "tid" in e
        if e["ph"] != "M":
            assert isinstance(e["ts"], float) and e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
    assert {e["name"] for e in ev if e["ph"] == "M"} == {
        "process_name", "thread_name"}
    assert len({e["pid"] for e in ev}) == 1
    assert len({e["tid"] for e in ev}) == 1
    return ev


def _window(ev, name):
    b = next(e for e in ev if e["ph"] == "B" and e["name"] == name)
    e = next(e for e in ev if e["ph"] == "E" and e["name"] == name)
    return b["ts"], e["ts"]


def _inside(x, window):
    return (window[0] <= x["ts"]
            and x["ts"] + x["dur"] <= window[1] + 1e-3)


def test_chrome_trace_schema_and_nesting():
    obs_tracing.set_enabled(True)
    with obs_tracing.span("outer", step=1):
        with obs_tracing.span("inner"):
            pass
        y = torch.ones(5) * 2
        obs_tracing.phase_done("compute", y)
    obs_tracing.instant("tick")

    trace = obs_tracing.default_recorder().to_chrome_trace()
    ev = _check_schema(trace)
    begins = [e for e in ev if e["ph"] == "B"]
    ends = [e for e in ev if e["ph"] == "E"]
    assert len(begins) == len(ends) == 2
    assert next(e for e in begins if e["name"] == "outer")["args"] == {
        "step": 1}
    xs = [e for e in ev if e["ph"] == "X"]
    assert len(xs) == 1
    # the X phase starts at the inner span's end and sits in the outer span
    assert _inside(xs[0], _window(ev, "outer"))
    assert xs[0]["ts"] >= _window(ev, "inner")[1]
    assert [e["name"] for e in ev if e["ph"] == "i"] == ["tick"]


def test_tracing_disabled_is_silent():
    with obs_tracing.span("ghost"):
        obs_tracing.phase_done("phantom", torch.ones(2))
        obs_tracing.instant("nope")
    assert obs_tracing.default_recorder().events() == []


def test_fixed_point_phases_tile_the_step(tmp_path):
    """``forward_solve`` then ``implicit_backward``, back to back inside
    the enclosing span, for each forward solver."""
    obs_tracing.set_enabled(True)
    w = torch.nn.Parameter(0.3 * torch.randn(6, 6, generator=torch.Generator()
                                             .manual_seed(0)))
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))

    def f(p, xx, z):
        return torch.tanh(z @ p) + xx

    for solver in ("broyden", "adjoint_broyden", "anderson", "fixed_point"):
        cfg = ImplicitConfig.from_strings(solver=solver, backward="shine",
                                          max_steps=20, tol=1e-5, memory=4)
        with obs_tracing.span("step", solver=solver):
            z, _ = implicit_fixed_point(f, w, x, torch.zeros_like(x), cfg)
            z.sum().backward()
    trace = obs_tracing.write(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json")) == json.loads(
        json.dumps(trace))
    ev = _check_schema(trace)
    xs = [e for e in ev if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["forward_solve",
                                       "implicit_backward"] * 4
    steps = [(b["ts"], e["ts"]) for b, e in zip(
        [e for e in ev if e["ph"] == "B"], [e for e in ev if e["ph"] == "E"])]
    for i, win in enumerate(steps):
        fwd, bwd = xs[2 * i], xs[2 * i + 1]
        assert _inside(fwd, win) and _inside(bwd, win)
        assert fwd["ts"] == win[0]
        assert bwd["ts"] == pytest.approx(fwd["ts"] + fwd["dur"])


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


def _fill(reg):
    reg.counter("solves_total", {"phase": "forward"}).inc(3)
    reg.counter("solves_total", {"phase": "backward"}).inc(2.5)
    reg.counter("9lives-total").inc()
    reg.gauge("qn_ring_bytes", {"dtype": "bfloat16"}).set(1.5e6)
    reg.gauge("big", {"path": 'a\\b"c\nd'}).set(1e16)
    reg.gauge("unset")
    h = reg.histogram("serve_ttft_ms")
    for v in (0.05, 3.0, 7.5, 7.5, 1200.0, 1e9):
        h.observe(v)
    hb = reg.histogram("step_ms", {"arm": "kernel"}, buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 7.0):
        hb.observe(v)


def test_to_prom_text_equals_jax():
    treg, jreg = obs_metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _fill(treg)
    _fill(jreg)
    text = treg.to_prom()
    assert text == jreg.to_prom()
    assert "# TYPE serve_ttft_ms histogram" in text
    assert 'step_ms_bucket{arm="kernel",le="+Inf"} 3' in text
    assert '_9lives_total 1' in text
    assert obs_metrics.MetricsRegistry().to_prom() == ""


def test_write_prom_is_atomic_and_flusher_flushes_at_stop(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    _fill(reg)
    path = tmp_path / "sub" / "m.prom"
    assert reg.write_prom(str(path)) == path.read_text() == reg.to_prom()
    assert os.listdir(path.parent) == ["m.prom"]  # no temporary left
    out = tmp_path / "f.prom"
    flusher = obs_metrics.PromFlusher(str(out), interval_s=3600,
                                      registry=reg).start()
    reg.counter("late").inc(7)
    flusher.stop()
    assert "late 7" in out.read_text()


def test_emit_scalar_kinds_and_off_switch():
    reg = obs_metrics.default_registry()
    obs_metrics.emit_scalar("es_gauge_t", torch.tensor(9.0))
    assert reg.counter("es_count_t").value == 0.0
    obs_metrics.set_enabled(True)
    for v in (3.0, 5.0):
        obs_metrics.emit_scalar("es_gauge_t", torch.tensor(v))
        obs_metrics.emit_scalar("es_count_t", torch.tensor(v),
                                kind="counter")
        obs_metrics.emit_scalar("es_hist_t", v, kind="histogram",
                                labels={"k": "x"})
    # a number lands at once; a tensor at the next read, here a flush
    assert reg.histogram("es_hist_t", {"k": "x"}).count == 2
    assert reg.gauge("es_gauge_t").value == 0.0
    reg.flush()
    assert reg.gauge("es_gauge_t").value == 5.0
    assert reg.counter("es_count_t").value == 8.0
    assert reg.histogram("es_hist_t", {"k": "x"}).count == 2


def test_trainer_counts_skips_at_the_interval_read(monkeypatch):
    """Rejected updates reach ``train_update_skips_total`` from the
    trainer's one host read per interval, as a number: the step itself
    hands ``emit_scalar`` no tensor to read."""
    cfg = smoke_config("minicpm-2b", deq=True)
    cfg = dataclasses.replace(
        cfg, dtype="float32", d_model=32, num_heads=2, num_kv_heads=2,
        d_ff=64, vocab_size=128, head_dim=16,
        deq=dataclasses.replace(cfg.deq, max_steps=4))
    tcfg = TrainConfig(steps=5, global_batch=2, seq_len=8, skip_budget=9)

    def nan_loss(p, b):
        return p["final_norm"]["scale"].sum() * float("nan"), {}

    emitted = []
    real = obs_metrics.emit_scalar
    monkeypatch.setattr(obs_metrics, "emit_scalar", lambda name, v, **kw: (
        emitted.append((name, v)), real(name, v, **kw)))
    obs_metrics.set_enabled(True)
    total = obs_metrics.default_registry().counter("train_update_skips_total")
    before = total.value
    Trainer(cfg, tcfg, loss_fn=nan_loss, device="cpu").run(
        make_lm_batch_iterator(cfg, 2, 8, device="cpu"), steps=5,
        log_every=3, on_metrics=lambda i, m: None)
    assert emitted == [("train_update_skips_total", 3.0),
                       ("train_update_skips_total", 2.0)]
    assert total.value == before + 5.0


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["adjoint_broyden", "anderson",
                                    "fixed_point"])
def test_train_launcher_traces_and_exports(tmp_path, solver, capsys):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    est = obs_metrics.default_registry().counter(
        "backward_estimates_total", {"estimator": "shine_fallback"})
    before = est.value
    tlaunch.main(["--arch", "minicpm-2b", "--smoke", "--deq", "--device",
                  "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                  "--solver", solver, "--trace-out", str(trace),
                  "--metrics-prom-out", str(prom)])
    assert "finished at step 2" in capsys.readouterr().out
    ev = _check_schema(json.loads(trace.read_text()))
    names = [e["name"] for e in ev]
    # B and E of each span, one X per phase, per step
    for name, n in (("data", 4), ("train_step", 4), ("forward_solve", 2),
                    ("implicit_backward", 2), ("optimizer", 2)):
        assert names.count(name) == n, name
    steps = [e for e in ev if e["ph"] == "B" and e["name"] == "train_step"]
    ends = [e for e in ev if e["ph"] == "E" and e["name"] == "train_step"]
    xs = [e for e in ev if e["ph"] == "X"]
    for b, e in zip(steps, ends):
        inside = [x["name"] for x in xs if _inside(x, (b["ts"], e["ts"]))]
        assert inside == ["forward_solve", "implicit_backward", "optimizer"]
    text = prom.read_text()
    assert "# TYPE backward_estimates_total counter" in text
    assert ('backward_estimates_total{estimator="shine_fallback"} '
            f"{obs_metrics._prom_num(before + 2)}") in text
    assert "# TYPE train_update_skips_total counter" in text


def test_train_launcher_rejects_unknown_solver(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--smoke", "--deq", "--device", "cpu", "--solver",
                      "newton"])
    err = capsys.readouterr().err
    for name in ("adjoint_broyden", "anderson", "broyden", "fixed_point"):
        assert name in err


def test_serve_launcher_traces_the_drain(tmp_path):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    before = obs_metrics.default_registry().counter(
        "serve_requests_completed").value
    tserve.main(["--smoke", "--deq", "--device", "cpu", "--requests", "3",
                 "--slots", "2", "--max-new-tokens", "3", "--pipeline",
                 "sync", "--trace-out", str(trace), "--metrics-prom-out",
                 str(prom)])
    ev = _check_schema(json.loads(trace.read_text()))
    drain = _window(ev, "drain")
    spans = {e["name"] for e in ev if e["ph"] == "B"}
    assert spans == {"drain", "serve_tick", "admit", "prefill", "decode"}
    for e in ev:
        if e["ph"] in "BEX":
            assert drain[0] <= e["ts"] <= drain[1] + 1e-3
    assert (f"serve_requests_completed "
            f"{obs_metrics._prom_num(before + 3)}") in prom.read_text()


# ---------------------------------------------------------------------------
# The bridge from the device: off, silent; on, the reference's metrics
# ---------------------------------------------------------------------------

CTX = ShardCtx.for_mesh(None)
# every metric the bridge writes (the rest of the registry is host-side
# counting, unconditional in both packages)
BRIDGE = {"solves_total", "solve_failures_total", "solves_by_warm_total",
          "solve_iters_total", "solve_iters_last", "solve_residual",
          "carry_age_at_use", "solve_residual_tape",
          "backward_estimates_total", "backward_iters_total",
          "backward_residual", "backward_fallbacks_total",
          "backward_cotangents_zeroed_total"}


def _small(cfg, **deq):
    """The smoke DEQ at d=32, f32 with an f32 ring (the serving parity
    tests' size): both packages take the same solver steps."""
    return dataclasses.replace(
        cfg, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, dtype="float32",
        deq=dataclasses.replace(cfg.deq, qn_dtype="float32", **deq))


@pytest.fixture(scope="module")
def bridge_setup():
    jcfg = _small(jax_smoke_config("minicpm-2b", deq=True))
    tcfg = _small(smoke_config("minicpm-2b", deq=True))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jp["deq_blocks"] = jax.tree_util.tree_map(lambda a: a * 0.3,
                                              jp["deq_blocks"])
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, npp


def _bridge_rows(snapshot: dict) -> dict:
    return {(m["name"], tuple(sorted(m["labels"].items()))): m
            for m in snapshot["metrics"] if m["name"] in BRIDGE}


def _torch_train(tcfg, npp, steps=2):
    """``steps`` steps of the port's train step (``deq_carry="state"``)
    through the Trainer, one read at the end; returns its metrics."""
    tc = TrainConfig(steps=steps, global_batch=2, seq_len=8, lr=1e-3,
                     warmup_steps=2)
    seen = []
    Trainer(tcfg, tc, params=tlm.params_from_jax(npp, "cpu")).run(
        make_lm_batch_iterator(tcfg, 2, 8, device="cpu"), steps=steps,
        log_every=steps, on_metrics=lambda i, m: seen.append(m))
    return seen


def _jax_train(jcfg, jp, steps=2):
    jtc = JTrainConfig(zero1=False, steps=steps, global_batch=2, seq_len=8,
                       lr=1e-3, warmup_steps=2)
    step = jax.jit(jsteps.build_train_step(jcfg, jtc, CTX))
    st = jsteps.TrainState(jnp.zeros((), jnp.int32), jp, jopt.adamw_init(jp),
                           jlm.deq_solve_carry(jcfg, 2, 8),
                           jnp.zeros((), jnp.int32))
    for i in range(steps):
        toks = JDataset(jcfg.vocab_size, 0).batch(i, 2, 9)
        st, m = step(st, {"tokens": jnp.asarray(toks[:, :-1]),
                          "targets": jnp.asarray(toks[:, 1:])})
    jax.block_until_ready(m)
    jax.effects_barrier()


_PROMPTS = [[5, 9, 3, 7, 11], [2, 4, 6, 8, 10, 12, 14, 16, 18],
            [13, 17, 19, 23, 29]]


def _torch_drain(tcfg, npp):
    loop = ServeLoop(tlm.params_from_jax(npp, "cpu"), tcfg, slots=2,
                     max_len=32)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=3)
            for i, p in enumerate(_PROMPTS)]
    loop.drain(reqs)
    return reqs


def _jax_drain(jcfg, jp):
    loop = JServeLoop(jp, jcfg, CTX, slots=2, max_len=32, pipeline="sync")
    reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=3)
            for i, p in enumerate(_PROMPTS)]
    loop.drain(reqs)
    jax.effects_barrier()
    return reqs


def test_metrics_off_reaches_no_bridge(bridge_setup, monkeypatch):
    """With metrics off a train step and a drain land nothing through the
    bridge and queue nothing for it: the registry holds no bridge metric."""
    _, tcfg, _, npp = bridge_setup
    reg = obs_metrics.default_registry()
    reg.reset()

    def refuse(*a, **k):
        raise AssertionError("the bridge was reached with metrics off")

    for name in ("_land_solve", "_land_backward", "_land_scalar"):
        monkeypatch.setattr(obs_metrics, name, refuse)
    monkeypatch.setattr(obs_metrics.MetricsRegistry, "defer", refuse)
    _torch_train(tcfg, npp, steps=1)
    assert all(len(r.out) == 3 for r in _torch_drain(tcfg, npp))
    names = {m["name"] for m in reg.snapshot()["metrics"]}
    assert not names & BRIDGE, names & BRIDGE
    assert "serve_tokens_total" in names  # host-side counting goes on


@pytest.mark.parametrize("path", ["train", "drain"])
def test_metrics_on_match_jax_names_and_counts(bridge_setup, path):
    """The same 2 smoke train steps (a cold then a warm forward solve and
    two ``shine_fallback`` backwards), or the same drain (prefill solves
    under ``forward``, decode solves under ``serve``), in both packages with
    metrics on: the same bridge metric names and labels, the same counter
    values, histogram and series counts, and carry ages; residual means at
    rtol 1e-3."""
    jcfg, tcfg, jp, npp = bridge_setup
    treg, jreg = obs_metrics.default_registry(), jmetrics.default_registry()
    treg.reset()
    jreg.reset()
    obs_metrics.set_enabled(True)
    jmetrics.set_enabled(True)
    try:
        if path == "train":
            _jax_train(jcfg, jp)
            _torch_train(tcfg, npp)
        else:
            jreqs, treqs = _jax_drain(jcfg, jp), _torch_drain(tcfg, npp)
            assert [r.out for r in treqs] == [r.out for r in jreqs]
    finally:
        jmetrics.set_enabled(False)
    want = _bridge_rows(jreg.snapshot())
    got = _bridge_rows(treg.snapshot())
    assert sorted(got) == sorted(want)
    phases = {dict(k[1]).get("phase") for k in got}
    assert phases == ({"forward"} | ({"serve"} if path == "drain"
                                     else {None}))
    assert ("solve_residual_tape", (("phase", "forward"),)) in got
    for key, w in want.items():
        g = got[key]
        assert g["kind"] == w["kind"], key
        if w["kind"] in ("counter", "gauge"):
            assert g["value"] == w["value"], key
        elif w["kind"] == "series":
            assert g["count"] == w["count"], key
            np.testing.assert_allclose(g["last"], w["last"], rtol=1e-3,
                                       err_msg=str(key))
        else:
            assert g["count"] == w["count"], key
            assert g["counts"] == w["counts"] or key[0] == "solve_residual"
            np.testing.assert_allclose(g["sum"], w["sum"], rtol=1e-3,
                                       err_msg=str(key))


def test_bridge_lands_at_the_interval_read(bridge_setup, monkeypatch):
    """With metrics on, 2 train steps with one metrics read at the end make
    one host transfer (``_to_host``), which also lands every solve and
    backward record: the bridge reads nothing on its own."""
    _, tcfg, _, npp = bridge_setup
    reg = obs_metrics.default_registry()
    reg.reset()
    calls = []
    real = obs_metrics._to_host
    monkeypatch.setattr(obs_metrics, "_to_host", lambda parts: (
        calls.append(len(parts)), real(parts))[1])
    obs_metrics.set_enabled(True)
    _torch_train(tcfg, npp)
    assert len(calls) == 1
    assert not reg._pending
    assert reg.counter("solves_total", {"phase": "forward"}).value == 2
    assert reg.counter("backward_estimates_total",
                       {"estimator": "shine_fallback"}).value == 2


def test_series_prom_text_equals_jax():
    """A series renders as its count of records (a gauge), as the
    reference's ``to_prom`` writes it, beside the other kinds."""
    treg, jreg = obs_metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (treg, jreg):
        _fill(reg)
        reg.series("solve_residual_tape", {"phase": "forward"}).record(
            [3.0, 0.5, 0.25])
        reg.series("solve_residual_tape", {"phase": "forward"}).record([1.0])
        reg.series("solve_residual_tape", {"phase": "serve"}).record([2.0])
    text = treg.to_prom()
    assert text == jreg.to_prom()
    assert "# TYPE solve_residual_tape_records gauge" in text
    assert 'solve_residual_tape_records{phase="forward"} 2' in text
    assert treg.series("solve_residual_tape",
                       {"phase": "forward"}).payload() == jreg.series(
        "solve_residual_tape", {"phase": "forward"}).payload()
