"""What every cell of the benchmark shares: the manifest, the look for the
card, the environment a run builds in, the readers of per-layer metrics,
the profiler's trace and its reduction, host-wait counting, and the line a
run prints last.

A cell is found by name: ``BENCHMARK.json`` names its configuration and
traffic mix, whose files live under ``chipbench/configs/`` and
``chipbench/traffic/``, and a traffic file's ``kind`` names the module that
runs it (``chipbench/<kind>.py``); a per-layer metric is the reader
``chipbench/metrics/<metric>.py``; the limits of a cell's comparisons are
``chipbench/limits/<workload>.json``.  Adding a cell, a mix or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that must not be loaded in a run's process: JAX,
# its companions, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SYNC_WARNING = "called a synchronizing CUDA operation"


class Refused(RuntimeError):
    """A run that cannot give a result (no card, a bad manifest)."""


def boot() -> None:
    """The program on the path and every build cache inside the checkout,
    at fixed paths (the program's CUDA kernels already build into
    ``build/repro_torch/`` at its root)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    cache = ROOT / "build" / "chipbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------


class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    metrics and limits."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        wl = {w["name"]: w for w in manifest["workloads"]}
        if name not in wl:
            raise Refused(f"no workload {name!r} in BENCHMARK.json; have "
                          f"{sorted(wl)}")
        self.name = name
        self.workload = wl[name]
        entry = {c["name"]: c for c in manifest["configs"]}[
            self.workload["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = json.loads(
            (root / "chipbench" / "traffic" /
             f"{self.workload['traffic']}.json").read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        lim = root / "chipbench" / "limits" / f"{name}.json"
        self.limits = json.loads(lim.read_text())["limits"]


def driver(cell: Cell):
    """The module that runs the cell's kind of traffic: ``kind`` in the
    traffic file names ``chipbench/<kind>.py``, whose ``run_cell(cell,
    seed, seconds, trace, t_start)`` returns ``(result, compared)``."""
    kind = cell.traffic["kind"]
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind):
        raise Refused(f"bad traffic kind {kind!r}")
    mod = importlib.import_module("chipbench." + kind)
    if not hasattr(mod, "run_cell"):
        raise Refused(f"chipbench/{kind}.py runs no cell")
    return mod


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reader(name: str, root: Path = ROOT):
    """The ``read(rec) -> float | None`` of per-layer metric ``name``."""
    path = root / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "chipbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(cell: Cell, rec: dict, root: Path = ROOT) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], root)(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def require_chips(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark measures the port on "
                      "the card and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell asks for {n} cards; "
                      f"{torch.cuda.device_count()} present")


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def smi_sample() -> str:
    """The card's name, power limit, SM clock, power draw and temperature
    (read only; nothing is set)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_loaded() -> list[str]:
    """Modules whose top-level name (before the first dot, compared whole)
    is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# host waits on the card (a copy of the port's chip_smoke.count_syncs)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def count_syncs(out: list):
    """Note in ``out`` each host wait on the card issued inside the block:
    explicit ``synchronize`` calls (torch.cuda, events, streams) and the
    implicit ones ``torch.cuda.set_sync_debug_mode("warn")`` reports (a
    read of a card tensor, a copy from pageable memory, ``nonzero``)."""
    import torch

    card = torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if card else None
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.ExitStack() as stack:
        warnings.simplefilter("always")
        for owner, label in ((torch.cuda, "torch.cuda"),
                             (torch.cuda.Event, "Event"),
                             (torch.cuda.Stream, "Stream")):
            orig = getattr(owner, "synchronize")

            def counted(*a, _orig=orig, _label=label, **kw):
                out.append(f"{_label}.synchronize")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    return _orig(*a, **kw)

            stack.enter_context(mock.patch.object(owner, "synchronize",
                                                  counted))
        if card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(prev)
    for w in caught:
        if SYNC_WARNING in str(w.message):
            out.append(f"implicit at {Path(w.filename).name}:{w.lineno}")


# ---------------------------------------------------------------------------
# ranges around the program's calls, and the profiler's trace
# ---------------------------------------------------------------------------


class Ranges:
    """While ``active``, wraps chosen functions of the program's modules in
    ``torch.profiler.record_function`` ranges named ``chipbench:<name>``
    and notes each call's cost from its arguments.  Patched on
    :meth:`install`, restored on :meth:`remove`."""

    def __init__(self):
        self.active = False
        self.names: list[str] = []
        self.calls: dict[str, list] = collections.defaultdict(list)
        self._patches: list = []

    def wrap(self, module, attr: str, name: str, cost=None) -> None:
        import torch

        orig = getattr(module, attr)

        def wrapped(*a, **kw):
            if not self.active:
                return orig(*a, **kw)
            with torch.profiler.record_function("chipbench:" + name):
                out = orig(*a, **kw)
            self.calls[name].append(cost(a, kw, out) if cost else None)
            return out

        self._patches.append((module, attr, orig))
        if name not in self.names:
            self.names.append(name)
        setattr(module, attr, wrapped)

    def remove(self) -> None:
        for module, attr, orig in reversed(self._patches):
            setattr(module, attr, orig)
        self._patches.clear()


def read_trace(path: str, names: list[str]) -> dict:
    """Reduce a profiler trace: the device's busy time (the union of its
    operations), the device time of the kernels launched inside each
    ``chipbench:<name>`` range, the device operations that took most time,
    and the device's idle gaps summed by what the host was doing (the
    innermost range open on the host and the host operation under it)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev_ops, launches, annots, cpu_ops = [], {}, [], []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev_ops.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e["ts"]
        elif cat == "user_annotation":
            annots.append(e)
        elif cat == "cpu_op":
            cpu_ops.append(e)
    # device time by range: a kernel belongs to a range if it was launched
    # while the range was open on the host
    by_name: dict[str, list] = {n: [] for n in names}
    for a in annots:
        n = a["name"].removeprefix("chipbench:")
        if a["name"].startswith("chipbench:") and n in by_name:
            by_name[n].append((a["ts"], a["ts"] + a["dur"]))
    for n in by_name:
        by_name[n].sort()
    range_s = {n: 0.0 for n in names}
    range_kernels = {n: 0 for n in names}
    for k in dev_ops:
        t = launches.get(k.get("args", {}).get("correlation"))
        if t is None:
            continue
        for n, iv in by_name.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                range_s[n] += k["dur"] * 1e-6
                range_kernels[n] += 1
    # busy time and idle gaps on the device's timeline
    spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in dev_ops)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    by_op = collections.Counter()
    for k in dev_ops:
        by_op[_short(k["name"]) or k["cat"]] += k["dur"] * 1e-6
    host = sorted([(a["ts"], a["ts"] + a["dur"], a["name"]) for a in annots],
                  key=lambda x: (x[0], -x[1]))
    ops = sorted([(c["ts"], c["ts"] + c["dur"], c["name"]) for c in cpu_ops],
                 key=lambda x: (x[0], -x[1]))
    gaps = collections.Counter()
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        label = _innermost(host, mid) or "no range"
        op = _innermost(ops, mid)
        gaps[label + (" / " + op if op else "")] += (s1 - e0) * 1e-6
    return {"busy_s": busy_s, "range_s": range_s,
            "range_kernels": range_kernels, "kernels": len(dev_ops),
            "device_ops": by_op.most_common(10),
            "idle_gaps": gaps.most_common(10)}


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymous
    parts, template and call arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:80] or name[:80]


def _innermost(intervals: list, t: float) -> str | None:
    """The shortest interval holding ``t`` (intervals sorted by start)."""
    best = None
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    # walk back over intervals that start before t; ranges nest, so a
    # bounded walk finds the enclosing ones
    for j in range(i, max(i - 4000, -1), -1):
        s, e, n = intervals[j]
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, n)
    return None if best is None else best[1].removeprefix("chipbench:")


class Profile:
    """The profiler over a slice of the window, its trace written under
    ``TMPDIR`` and deleted once read."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def read(self, names: list[str]) -> dict:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            out = read_trace(path, names)
        out["window_s"] = self.t1 - self.t0
        return out


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def emit(result: dict, compared: dict) -> None:
    """Print each number compared beside its limit as the last lines on
    standard error, and the result as the last line on standard output,
    with the comparison under its own key, last."""
    for k, (v, lim) in compared.items():
        print(f"compared {k} = {v!r} limit {lim!r}", file=sys.stderr)
    result = dict(result)
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
