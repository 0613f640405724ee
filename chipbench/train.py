"""The training cells: one ``Trainer`` drives set-up, checks and window.

Set-up draws the weights from the seed on the card, builds the program's
``Trainer`` on them and starts ``Trainer.run`` over the benchmark's feed.
The run's first ``checked_steps`` steps are the ones the reference follows
(their losses, the first step's gradient as AdamW's first moment holds it,
every leaf's change after the last of them); ``warm_steps`` more let the
allocator and the carry settle; then the window opens at a host read and
lasts until the feed, asked for the next batch after ``--seconds``,
closes it.  Nothing compiles in the window: every kernel was built and
every shape run in the set-up steps.

Each batch is ``batch`` rows of ``seq + 1`` token ids drawn uniformly over
the vocabulary on the card from the seed and the step (rows all differ);
tokens are the first ``seq``, targets the last ``seq``.

After the window the program's state is freed and the reference
(``chipbench/reference/<layout>.py``, float32) runs the checked steps from
the same weights and batches; ``compare`` gives the numbers that decide
``correct``.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from chipbench import flops, harness, layouts, tree, weights

B1 = 0.9  # AdamW's first-moment decay (the program's and the reference's)


class WindowClosed(Exception):
    """Raised by the feed when the window's time is up."""


def batch_for(cfg: dict, traffic: dict, seed: int, step: int,
              device) -> dict:
    """Step ``step``'s batch (1-based), the same for every side."""
    b, s = traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device).manual_seed(
        weights.seed_of(seed, 1 << 40, step))
    toks = torch.randint(0, cfg["vocab_size"], (b, s + 1), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
    return {"tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


class _Feed:
    """The trainer's batch iterator: draws each step's batch and closes
    the window when its time is up."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.step = 0
        self.deadline = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowClosed
        self.step += 1
        return batch_for(self.cfg, self.traffic, self.seed, self.step,
                         self.device)


class Card:
    """What a run reads of the card around its window: clocks and power
    as it opens and closes, and the peak of allocated memory in it."""

    def __init__(self, device):
        self.device = device
        self.at_open = self.at_close = None
        self.peak_bytes = 0

    def open(self) -> None:
        self.at_open = harness.smi_sample()
        torch.cuda.reset_peak_memory_stats(self.device)

    def close(self) -> None:
        self.at_close = harness.smi_sample()
        self.peak_bytes = torch.cuda.max_memory_allocated(self.device)


def run_program(cell, seed: int, seconds: float, trace: bool, device,
                instrument=None, card: Card | None = None) -> dict:
    """Set-up, checked steps and window of the program.  Returns the
    records: checked readings, window times and, traced, what the
    per-layer readers take; ``card`` (on the card) is read as the window
    opens and closes."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.trainer import Trainer

    cfg, tr = cell.config, cell.traffic
    opt = tr["optimizer"]
    mcfg = layouts.layout(cfg).model_config(cfg)
    tcfg = TrainConfig(
        steps=opt["schedule_steps"], global_batch=tr["batch"],
        seq_len=tr["seq"], lr=opt["lr"], warmup_steps=opt["warmup_steps"],
        weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
        z_loss=opt["z_loss"], schedule=cfg["schedule"], zero1=False,
        qn_dtype=cfg.get("deq", {}).get("qn_dtype", "bfloat16"))
    params = weights.make_params(cfg, seed, device)
    trainer = Trainer(mcfg, tcfg, device=device, params=params)
    del params
    checked, warm = tr["checked_steps"], tr["warm_steps"]
    rec = {"steps": []}
    readings = {"loss": [], "iters": [], "gnorm": []}
    names = weights.leaf_names(cfg)
    feed = _Feed(cfg, tr, seed, device)
    ranges = harness.Ranges() if trace else None
    prof = harness.Profile() if trace else None
    syncs: list = []
    sync_ctx = harness.count_syncs(syncs) if trace else None
    state_box = {}
    orig_step = trainer._train_step

    def step_fn(state, batch):
        k = len(state_box.get("done", [])) + 1
        new_state, metrics = orig_step(state, batch)
        state_box.setdefault("done", []).append(k)
        if k == 1:
            mu = tree.leaves(new_state.opt.mu)
            state_box["grad"] = torch.stack(
                [torch.linalg.vector_norm(t.float()) for t in mu]) / (1 - B1)
            # the first gradient as AdamW holds it, kept on the host for
            # the comparison after the window
            state_box["grad_host"] = dict(zip(names, [
                host_copy(t / (1 - B1)) for t in mu]))
        if k == checked:
            ch = []
            flat = tree.leaves(new_state.params)
            for n, p in zip(names, flat):
                p0 = weights.make_leaf(cfg, seed, n, device)
                ch.append(torch.linalg.vector_norm(p.float() - p0.float()))
                del p0
            state_box["change"] = torch.stack(ch)
        return new_state, metrics

    trainer._train_step = step_fn
    t_window = {}

    def on_metrics(i, m):
        now = time.perf_counter()
        if i <= checked:
            readings["loss"].append(m["loss"])
            readings["gnorm"].append(m["grad_norm"])
            readings["iters"].append(m.get("deq_steps"))
        if i == checked + warm:
            if trace:
                from repro_torch.obs import tracing as obs_tracing
                obs_tracing.clear()
                obs_tracing.set_enabled(True)
                sync_ctx.__enter__()
                prof.start()
                ranges.active = True
            if card is not None:
                card.open()
            t_window["start"] = now = time.perf_counter()
            feed.deadline = now + seconds
            t_window["trace_end"] = now + tr["trace_seconds"]
        elif i > checked + warm:
            rec["steps"].append({"t": now - t_window["start"],
                                 "iters": m.get("deq_steps")})
            if trace and prof.t1 is None and now >= t_window["trace_end"]:
                ranges.active = False
                n = len(syncs)
                prof.stop()
                del syncs[n:]  # the profiler's own wait, not the program's
                rec["trace_steps"] = len(rec["steps"])

    if trace:
        instrument(ranges)
    try:
        trainer.run(feed, steps=opt["schedule_steps"], log_every=1,
                    on_metrics=on_metrics)
    except WindowClosed:
        pass
    finally:
        if trace:
            if prof.t0 is not None and prof.t1 is None:
                ranges.active = False
                prof.stop()
                rec["trace_steps"] = len(rec["steps"])
            if "start" in t_window:
                sync_ctx.__exit__(None, None, None)
            ranges.remove()
    if card is not None:
        card.close()
    rec["setup_end"] = t_window.get("start")
    readings["grad"] = dict(zip(names, state_box["grad"].tolist()))
    readings["grad_host"] = state_box["grad_host"]
    readings["change"] = dict(zip(names, state_box["change"].tolist()))
    if trace:
        from repro_torch.obs import tracing as obs_tracing
        ev = obs_tracing.default_recorder().events()
        obs_tracing.set_enabled(False)
        obs_tracing.clear()
        rec["phases"] = _phase_ms(ev)
        rec["host_waits"] = len(syncs)
        rec["profile"] = (prof.read(ranges.names)
                          if prof.t1 is not None else None)
        rec["calls"] = dict(ranges.calls)
    del trainer, state_box, orig_step
    gc.collect()
    torch.cuda.empty_cache()
    rec["readings"] = readings
    return rec


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A leaf of a first gradient on the host, in bfloat16 (its rounding,
    2^-9 of each entry, lies well under the gaps compared)."""
    return t.detach().to(torch.bfloat16).to("cpu")


def _phase_ms(events: list) -> dict:
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            out.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return out


def reference_readings(cell, seed: int, device, quant: str | None = None,
                       against: dict | None = None,
                       follow: list | None = None) -> dict:
    """The reference's (or, ``quant="fp8"``, the control's) checked steps
    from the same weights and batches.  Its first gradient is kept on the
    host, or, given ``against`` (another side's, on the host), its
    difference from that one is measured leaf by leaf.  ``follow``: the
    other side's solve iterations of each checked step, which the DEQ's
    solves then run (None: the configuration's own stop test)."""
    cfg, tr = cell.config, cell.traffic
    params = weights.make_params(cfg, seed, device, torch.float32)
    batches = [batch_for(cfg, tr, seed, k, device)
               for k in range(1, tr["checked_steps"] + 1)]
    ref_mod = layouts.reference(cfg)
    ref = ref_mod.Ref(cfg, quant)
    first: dict = {}

    def on_first(names, grads):
        for n, g in zip(names, grads):
            if against is None:
                first[n] = host_copy(g)
            else:
                other = against[n].to(device=g.device, dtype=torch.float32)
                first[n] = float(torch.linalg.vector_norm(other - g))
                del other

    out = ref_mod.train_follow(
        ref, params, batches, tr["optimizer"],
        lambda n: weights.make_leaf(cfg, seed, n, device),
        store_dtype=weights.dtype_of(cfg), first_grad=on_first,
        follow=follow)
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    res = {"loss": out["loss"], "iters": out["iters"],
           "gnorm": out["gnorm"], "grad": out["grad_norms"],
           "change": out["change_norms"]}
    res["grad_diff" if against is not None else "grad_host"] = first
    return res


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct`` (a cell's limits file names the
    ones it compares).

    ``loss_gap``: the largest relative gap of the checked steps' losses;
    ``loss1_gap``: the first step's alone.
    ``gnorm1_gap``: the relative gap of the first step's whole gradient
    norm before the clip (the program's ``grad_norm``).
    ``grad_gap``: over leaves, the largest gap between the program's and
    the reference's norm of the first step's clipped gradient, over the
    larger of the reference's norm of that leaf and of the median leaf.
    ``grad_diff``: over leaves, the largest norm of the difference of the
    two first gradients, over the same denominator (a first-order measure,
    where a gap of norms is second-order in the difference).
    ``update_gap``: the same for the parameters' change after the checked
    steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a leaf with none moves by round-off
    under AdamW's normalisation)."""
    loss_steps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                      ref["loss"])]
    gnorm_steps = [abs(a - b) / abs(b) for a, b in zip(prog["gnorm"],
                                                       ref["gnorm"])]
    med_g = statistics.median(ref["grad"].values())
    grad = {n: abs(prog["grad"][n] - ref["grad"][n])
            / max(ref["grad"][n], med_g) for n in ref["grad"]}
    moving = [n for n in ref["change"] if ref["grad"][n] >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in moving)
    upd = {n: abs(prog["change"][n] - ref["change"][n])
           / max(ref["change"][n], med_c) for n in moving}
    gw = max(grad, key=grad.get)
    uw = max(upd, key=upd.get)
    diff = {n: ref["grad_diff"][n] / max(ref["grad"][n], med_g)
            for n in ref.get("grad_diff", {})}
    dw = max(diff, key=diff.get) if diff else None
    return {"loss_gap": max(loss_steps), "loss1_gap": loss_steps[0],
            "gnorm1_gap": gnorm_steps[0], "grad_gap": grad[gw],
            "update_gap": upd[uw], "grad_diff": diff[dw] if diff else None,
            "diff_worst": dw, "loss_steps": loss_steps,
            "gnorm_steps": gnorm_steps, "grad_worst": gw, "update_worst": uw,
            "left_out": sorted(set(ref["change"]) - set(moving))}


NUMBERS = ("loss_gap", "loss1_gap", "gnorm1_gap", "grad_gap", "grad_diff",
           "update_gap")


def judge(cell, numbers: dict) -> tuple[bool, dict]:
    compared = {k: (numbers[k], cell.limits[k]) for k in cell.limits}
    ok = all(v <= lim for v, lim in compared.values())
    return ok, compared


def metrics_end_to_end(cell, rec: dict, setup_s: float) -> dict:
    steps = rec["steps"]
    out = {"setup_s": {"value": setup_s, "unit": "s"}}
    if steps:
        out["train_step_ms"] = {"value": steps[-1]["t"] / len(steps) * 1e3,
                                "unit": "ms"}
    out["train_peak_gib"] = {"value": rec["peak_bytes"] / 2 ** 30,
                             "unit": "GiB"}
    return {k: v for k, v in out.items()
            if k in {m["name"] for m in cell.end_to_end}}


def per_layer_record(cell, rec: dict) -> dict:
    """What the per-layer readers take from a traced training run: the
    window's steps (iterations, operations, time), the program's phases
    and host waits, and the traced slice's profile with the roofline bound
    and device time of each kernel the benchmark wraps."""
    cfg, tr = cell.config, cell.traffic
    steps = rec["steps"]
    iters = [s["iters"] for s in steps]
    count = layouts.layout(cfg).train_step_flops
    step_flops = [count(cfg, tr["batch"], tr["seq"], int(n or 0))
                  for n in iters]
    prof = rec.get("profile") or {}
    calls = rec.get("calls", {})
    rs = prof.get("range_s", {})
    kernels = {}
    qn = calls.get("broyden_step", []) + calls.get("qn_apply_multi", [])
    if qn:
        kernels["qn"] = {"bound_s": qn_bound_s(qn),
                         "device_s": rs.get("broyden_step", 0.0)
                         + rs.get("qn_apply_multi", 0.0)}
    if calls.get("attention"):
        kernels["attention"] = {
            "bound_s": sum(flops.bound_s(nb, fl) for nb, fl in
                           calls["attention"]),
            "device_s": rs.get("attention", 0.0)}
    return {"n_steps": len(steps),
            "window_s": steps[-1]["t"] if steps else 0.0,
            "iters": iters, "step_flops": step_flops,
            "phases": rec.get("phases", {}),
            "host_waits": rec.get("host_waits"), "profile": prof,
            "trace_steps": rec.get("trace_steps") or 0, "kernels": kernels,
            "peak_flops": flops.peak_flops("bfloat16")}


def check(cell, seed: int, rec: dict, device) -> tuple[dict, dict]:
    """The reference after the program's run (``rec``): it follows the
    checked steps from the same weights and batches, as many solve
    iterations as the program ran in each.  Returns the numbers that
    decide ``correct`` and the reference's readings."""
    ref = reference_readings(cell, seed, device,
                             against=rec["readings"].pop("grad_host"),
                             follow=rec["readings"]["iters"])
    return compare(rec["readings"], ref), ref


def run_cell(cell, seed: int, seconds: float, trace: bool,
             t_start: float) -> tuple[dict, dict]:
    """One run of a training cell on the card: ``(result, compared)``."""
    device = torch.device("cuda")
    card = Card(device)
    rec = run_program(cell, seed, seconds, trace, device,
                      instrument_train if trace else None, card)
    rec["peak_bytes"] = card.peak_bytes
    setup_s = rec["setup_end"] - t_start
    print(f"card at the window's open: {card.at_open}\n"
          f"card at the window's close: {card.at_close}", flush=True)
    if trace:
        metrics = harness.per_layer_values(cell, per_layer_record(cell, rec))
    else:
        metrics = metrics_end_to_end(cell, rec, setup_s)
    t_ref = time.perf_counter()
    numbers, ref = check(cell, seed, rec, device)
    reference_s = time.perf_counter() - t_ref
    ok, compared = judge(cell, numbers)
    result = {"correct": ok, "attempted": len(rec["steps"]),
              "failed": 0, "metrics": metrics,
              "device": harness.device_info(cell.chips,
                                            rec["peak_bytes"])}
    prof = rec.get("profile")
    if trace and prof:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["details"] = {"numbers": {k: numbers[k] for k in NUMBERS},
                         "program": rec["readings"]["loss"],
                         "reference": ref["loss"],
                         "iters": [rec["readings"]["iters"], ref["iters"]],
                         "grad_worst": numbers["grad_worst"],
                         "update_worst": numbers["update_worst"],
                         "left_out": numbers["left_out"],
                         "steps": len(rec["steps"]),
                         "reference_s": reference_s,
                         "step_ms": _step_ms(rec["steps"])}
    return result, compared


def _step_ms(steps: list) -> list:
    """Each window step's time, from one host read to the next."""
    t = [0.0] + [s["t"] for s in steps]
    return [round((b - a) * 1e3, 3) for a, b in zip(t, t[1:])]


def instrument_train(ranges) -> None:
    """The benchmark's ranges around the program's layers and kernels."""
    from repro_torch.implicit import fixed_point
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as launch_steps

    ranges.wrap(fixed_point, "solve_forward", "fixed_point.solve")
    ranges.wrap(fixed_point, "estimate_cotangent", "fixed_point.cotangent")
    ranges.wrap(launch_steps, "clip_by_global_norm", "optimizer")
    ranges.wrap(launch_steps, "adamw_update", "optimizer")
    ranges.wrap(ops, "attention", "attention", _attn_cost)
    ranges.wrap(ops, "broyden_step", "broyden_step", _broyden_cost)
    ranges.wrap(ops, "qn_apply_multi", "qn_apply_multi", _qn_cost)


def _attn_cost(a, kw, out):
    q, k = a[0], a[1]
    b, s, h, hd = q.shape
    return flops.attention_cost(b, s, k.shape[1], h, k.shape[2], hd,
                                q.element_size(), kw.get("causal", True))


def _broyden_cost(a, kw, out):
    # (u, v, g_new, s, hg_old, alpha, mask, ...): the mask (m, B) holds
    # the live slots; it is read after the window
    u, mask = a[0], a[6]
    return ("broyden_step", mask, u.shape[1], u[0, 0].numel(),
            u.element_size())


def _qn_cost(a, kw, out):
    u, xs, mask = a[0], a[2], a[4]
    return ("qn_apply_multi", mask, u.shape[1], u[0, 0].numel(),
            u.element_size(), xs.shape[0], xs.element_size())


def qn_bound_s(calls: list) -> float:
    """The roofline bound of the recorded qN calls, their live slots read
    from the masks after the window."""
    total = 0.0
    for c in calls:
        live = float(c[1].sum())
        if c[0] == "broyden_step":
            nb, fl = flops.broyden_step_cost(live, c[2], c[3], c[4])
        else:
            nb, fl = flops.qn_apply_multi_cost(live, c[2], c[3], c[5], c[4],
                                               c[6])
        total += flops.bound_s(nb, fl, "float32")
    return total
