"""The port's span tracer and Prometheus exporter against the JAX package's.

  * the Chrome-trace schema and nesting (as ``tests/test_obs.py`` holds the
    JAX recorder), silence when disabled, and the phase marks of a
    differentiable fixed point and of a train step;
  * ``to_prom()`` of the same counters, gauges and histograms (labels to
    escape, a histogram without a ``+Inf`` bucket) equal to the JAX
    registry's text, the atomic ``write_prom``, ``PromFlusher`` and
    ``emit_scalar``, and the trainer's count of rejected updates, landed
    from its one host read per interval;
  * the launchers end to end on the CPU with ``--trace-out`` and
    ``--metrics-prom-out``, for every forward solver.
"""

import dataclasses
import json
import os

import pytest
import torch

from repro.obs import metrics as jmetrics
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import make_lm_batch_iterator
from repro_torch.implicit import ImplicitConfig, implicit_fixed_point
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
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
                 "--slots", "2", "--max-new-tokens", "3", "--trace-out",
                 str(trace), "--metrics-prom-out", str(prom)])
    ev = _check_schema(json.loads(trace.read_text()))
    drain = _window(ev, "drain")
    spans = {e["name"] for e in ev if e["ph"] == "B"}
    assert spans == {"drain", "serve_tick", "admit", "prefill", "decode"}
    for e in ev:
        if e["ph"] in "BEX":
            assert drain[0] <= e["ts"] <= drain[1] + 1e-3
    assert (f"serve_requests_completed "
            f"{obs_metrics._prom_num(before + 3)}") in prom.read_text()
